"""quadrs_tpu_torch — the PyTorch and CUDA port of quadrs_tpu.

The reference command chain (``from``/``gen`` -> ``shift`` -> ``lowpass``
-> ``sparkfft``/``bucket``/``write``): a lazy stream graph pulled window
by window with the reference's per-read semantics, each batch of windows
computed by torch ops on the device (:mod:`.pipeline`, :mod:`.sinks`).

The streaming receiver chain (``stream``): raw IQ capture planes
(cf32 / cs8 / cu8 / cs16) are decoded, shifted by an exact NCO, low-pass
filtered with decimation and turned into fftshifted STFT magnitudes, or
surveyed per bin (``stream -scan``).  Inside its envelope decode, mix and
FIR run as one hand-written CUDA kernel for Hopper (``csrc/frontend.cu``);
outside it, as torch ops (``ops/fir.fir_decimate``).

The waterfall bank (``waterfall``, ``waterfall -search``, ``scan``):
many captures decode, window and transform at once into spectrogram
rows, per-window peaks or per-bin survey statistics, through three
hand-written CUDA kernels (``csrc/waterfall.cu``).

Pattern search (``find``: a template bank over a carrier-offset grid,
overlap-save FFT correlation with the candidate scan on the device) and
the conditioning stages (``iqbal``, ``dcblock``, ``agc``, ``resample``)
run as torch ops and cuFFT in any chain (:mod:`.ops.correlate`,
:mod:`.ops.resample`, :mod:`.stream`); :mod:`.bits` decodes OOK pulse
trains.

The receivers (``ook``, ``fsk``, ``fm``, ``am``, ``ssb``:
:mod:`.models.demod`) run their channel through a streaming front end
(the raw span of many per-read windows staged once a dispatch) and the
analog ones through one audio tail on the device, as torch ops and cuFFT.

Capture files are read through the package's own C++ loader
(``native/loader.cc``, built with g++ at first use), staged into
page-locked rings and copied on a copy stream (:mod:`.staging`); live
input comes from a pipe (``-stdin yes``: :class:`.sources.PipeSource`),
``stream -trigger`` records bursts, ``info`` prints capture statistics
and ``replay`` turns a recorded capture into a live pipe.

A device mesh (``-mesh TxS``, :mod:`.parallel.sharding`) shards ``stream``,
``waterfall``, ``scan``, ``find``, ``channelize``, the receivers and the
``serve`` daemon over a ``(stream, time)`` grid of devices: each shard is
staged with its halo and runs the single-device program on its device.  A
mesh may span processes (:mod:`.parallel.distributed`, on
``torch.distributed``).  :mod:`.utils.profiling` accounts the stages and
traces the device; :mod:`.utils.determinism` audits repeatability.

Every kernel has a plain PyTorch version, which CPU tensors take.  The
package imports ``torch`` and numpy, and never ``jax`` or
``quadrs_tpu``; the JAX package is the reference the tests hold it to.
"""

from quadrs_tpu_torch.formats import FileDetails, FileFormat
from quadrs_tpu_torch.models.receiver import PipelineConfig, PipelineModel
from quadrs_tpu_torch.models.waterfall import WaterfallConfig, WaterfallModel
from quadrs_tpu_torch.pipeline import Operation, exec_operation, run_pipeline
from quadrs_tpu_torch.sources import LivePipeStream, PipeSource, SampleSource, ToneGen, open_capture
from quadrs_tpu_torch.stream import Agc, DcBlock, IqCorrect, LowPass, Resample, Shift, Stream
from quadrs_tpu_torch.stream_runner import RunStats, ScanResult, StreamRunner, WaterfallRunner

__version__ = "0.1.0"

# the JAX package's exports (quadrs_tpu.__all__), then the models
__all__ = [
    "FileFormat",
    "FileDetails",
    "Stream",
    "Shift",
    "LowPass",
    "Resample",
    "DcBlock",
    "Agc",
    "IqCorrect",
    "LivePipeStream",
    "PipeSource",
    "SampleSource",
    "ToneGen",
    "open_capture",
    "Operation",
    "exec_operation",
    "run_pipeline",
    "StreamRunner",
    "WaterfallRunner",
    "RunStats",
    "ScanResult",
    "PipelineConfig",
    "PipelineModel",
    "WaterfallConfig",
    "WaterfallModel",
]
