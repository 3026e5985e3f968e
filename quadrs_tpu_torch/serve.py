"""CLI driver of the ``stream`` serving product.

Prints the JAX package's lines: one ``stream peak window=W bin=B mag=M``
line, a ``wrote PATH`` line per output file, and a closing
``stream: N samples, M windows, S.SSs, R.R Msps`` stats line.  ``-out
PREFIX`` streams results to files chunk by chunk: norms as raw f32 rows
(``PREFIX.norms.f32``), peaks as CSV (``PREFIX.peaks.csv``).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from quadrs_tpu_torch import args as argmod
from quadrs_tpu_torch.sources import open_capture
from quadrs_tpu_torch.stream_runner import RunStats

# stream flags whose paths are not ported yet, with the ROADMAP item that ports them
_NOT_PORTED = {
    "mesh": "-mesh (multi-GPU sharding, ROADMAP A13)",
    "stdin": "-stdin (live pipe input, ROADMAP A12)",
    "trigger": "-trigger (burst recorder, ROADMAP A12)",
    "scan": "-scan (band survey, ROADMAP A5)",
}


def _stats_line(name: str, stats: RunStats) -> str:
    return (
        f"{name}: {stats.samples_in} samples, {stats.windows_out} windows, "
        f"{stats.seconds:.2f}s, {stats.msps:.1f} Msps"
    )


class _PeakTracker:
    """Running (window, bin, mag) maximum across chunks."""

    def __init__(self):
        self.best = (-1, -1, float("-inf"))

    def update(self, w0: int, idx: np.ndarray, val: np.ndarray):
        if len(val) == 0:
            return
        i = int(np.argmax(val))
        if float(val[i]) > self.best[2]:
            self.best = (w0 + i, int(idx[i]), float(val[i]))

    def line(self, prefix: str) -> str:
        w, b, m = self.best
        return f"{prefix} peak window={w} bin={b} mag={m:.6g}"


def run_stream(cmd: argmod.StreamCmd, device: torch.device) -> int:
    """Drive the fused shift -> lowpass -> STFT chain over a capture on
    ``device``."""
    from quadrs_tpu_torch.models.receiver import PipelineConfig, PipelineModel
    from quadrs_tpu_torch.stream_runner import StreamRunner

    for flag, what in _NOT_PORTED.items():
        if getattr(cmd, flag) not in (None, False):
            raise NotImplementedError(f"stream {what} is not yet ported to quadrs_tpu_torch")
    src = open_capture(cmd.filename, cmd.sample_rate, cmd.format)
    cfg = PipelineConfig(
        sample_rate=src.sample_rate,
        shift_freq=cmd.shift,
        lp_freq=cmd.lowpass,
        decimate=cmd.decimate,
        taps=cmd.size,
        fft_width=cmd.fft_width,
        fmt=src.format,
    )
    runner = StreamRunner(src, PipelineModel(cfg), device, chunk_samples=cmd.chunk)
    tracker = _PeakTracker()
    wrote: list[str] = []

    # ExitStack so a mid-run failure (staging IO, callback, ^C) still
    # flushes and closes every output file
    with contextlib.ExitStack() as stack:
        if cmd.search:
            csv = None
            if cmd.out is not None:
                path = f"{cmd.out}.peaks.csv"
                csv = stack.enter_context(open(path, "w"))
                csv.write("window,bin,mag\n")
                wrote.append(path)

            def on_peaks(w0, out):
                idx, val = out
                tracker.update(w0, idx, val)
                if csv is not None:
                    for i in range(len(idx)):
                        csv.write(f"{w0 + i},{int(idx[i])},{float(val[i]):.9g}\n")

            stats = runner.run_search(on_peaks, max_chunks=cmd.chunks)
        else:
            f = None
            if cmd.out is not None:
                path = f"{cmd.out}.norms.f32"
                f = stack.enter_context(open(path, "wb"))
                wrote.append(path)

            def on_windows(w0, norms):
                tracker.update(w0, np.argmax(norms, axis=-1), np.max(norms, axis=-1))
                if f is not None:
                    f.write(np.ascontiguousarray(norms, dtype=np.float32).tobytes())

            stats = runner.run(on_windows, max_chunks=cmd.chunks)

    print(tracker.line("stream"))
    for path in wrote:
        print(f"wrote {path}")
    print(_stats_line("stream", stats))
    return 0
