"""quadrs_tpu_torch — the PyTorch and CUDA port of quadrs_tpu.

The streaming receiver chain (``stream``): raw IQ capture planes
(cf32 / cs8 / cu8 / cs16) are decoded, shifted by an exact NCO, low-pass
filtered with decimation and turned into fftshifted STFT magnitudes.
Decode, mix and FIR run as one hand-written CUDA kernel for Hopper
(``csrc/frontend.cu``), with a plain PyTorch version of it for CPU
tensors.  The package imports ``torch`` and numpy, and never ``jax`` or
``quadrs_tpu``; the JAX package is the reference the tests hold it to.
"""

from quadrs_tpu_torch.formats import FileDetails, FileFormat
from quadrs_tpu_torch.models.receiver import PipelineConfig, PipelineModel
from quadrs_tpu_torch.sources import SampleSource, open_capture
from quadrs_tpu_torch.stream_runner import RunStats, StreamRunner

__version__ = "0.1.0"

__all__ = [
    "FileDetails",
    "FileFormat",
    "PipelineConfig",
    "PipelineModel",
    "RunStats",
    "SampleSource",
    "StreamRunner",
    "open_capture",
]
