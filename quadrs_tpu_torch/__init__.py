"""quadrs_tpu_torch — the PyTorch and CUDA port of quadrs_tpu.

The streaming receiver chain (``stream``): raw IQ capture planes
(cf32 / cs8 / cu8 / cs16) are decoded, shifted by an exact NCO, low-pass
filtered with decimation and turned into fftshifted STFT magnitudes, or
surveyed per bin (``stream -scan``).  Decode, mix and FIR run as one
hand-written CUDA kernel for Hopper (``csrc/frontend.cu``).

The waterfall bank (``waterfall``, ``waterfall -search``, ``scan``):
many captures decode, window and transform at once into spectrogram
rows, per-window peaks or per-bin survey statistics, through three
hand-written CUDA kernels (``csrc/waterfall.cu``).

Every kernel has a plain PyTorch version, which CPU tensors take.  The
package imports ``torch`` and numpy, and never ``jax`` or
``quadrs_tpu``; the JAX package is the reference the tests hold it to.
"""

from quadrs_tpu_torch.formats import FileDetails, FileFormat
from quadrs_tpu_torch.models.receiver import PipelineConfig, PipelineModel
from quadrs_tpu_torch.models.waterfall import WaterfallConfig, WaterfallModel
from quadrs_tpu_torch.sources import SampleSource, open_capture
from quadrs_tpu_torch.stream_runner import RunStats, ScanResult, StreamRunner, WaterfallRunner

__version__ = "0.1.0"

__all__ = [
    "FileDetails",
    "FileFormat",
    "PipelineConfig",
    "PipelineModel",
    "RunStats",
    "SampleSource",
    "ScanResult",
    "StreamRunner",
    "WaterfallConfig",
    "WaterfallModel",
    "WaterfallRunner",
    "open_capture",
]
