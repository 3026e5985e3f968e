"""The CLI's serving products: ``stream``, ``waterfall``, ``scan``.

Their lines and files are the JAX package's (``quadrs_tpu.serve``): a
``<cmd> peak [stream=S] window=W bin=B mag=M`` line per stream, the
survey table of a scan, a ``wrote PATH`` line per output file, and a
closing ``<cmd>: N samples, M windows, S.SSs, R.R Msps`` stats line.
``-out PREFIX`` streams results to files chunk by chunk: norms as raw
f32 rows, peaks and survey tables as CSV.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from quadrs_tpu_torch import args as argmod
from quadrs_tpu_torch.sources import open_capture
from quadrs_tpu_torch.stream_runner import RunStats

# flags whose paths are not ported yet, per command, with the ROADMAP item that ports them
_NOT_PORTED = {
    "stream": {
        "mesh": "-mesh (multi-GPU sharding, ROADMAP A13)",
        "stdin": "-stdin (live pipe input, ROADMAP A12)",
        "trigger": "-trigger (burst recorder, ROADMAP A12)",
    },
    "waterfall": {
        "mesh": "-mesh (multi-GPU sharding, ROADMAP A13)",
        "stdin": "-stdin (live pipe input, ROADMAP A12)",
    },
    "scan": {
        "mesh": "-mesh (multi-GPU sharding, ROADMAP A13)",
        "stdin": "-stdin (live pipe input, ROADMAP A12)",
        "plot": "-plot (survey plots, ROADMAP A14)",
    },
}


def _refuse_not_ported(name: str, cmd) -> None:
    for flag, what in _NOT_PORTED[name].items():
        if getattr(cmd, flag) not in (None, False):
            raise NotImplementedError(f"{name} {what} is not yet ported to quadrs_tpu_torch")


def _stats_line(name: str, stats: RunStats) -> str:
    return (
        f"{name}: {stats.samples_in} samples, {stats.windows_out} windows, "
        f"{stats.seconds:.2f}s, {stats.msps:.1f} Msps"
    )


class _PeakTracker:
    """Running (stream, window, bin, mag) maxima across chunks."""

    def __init__(self, n_streams: int):
        self.best = [(-1, -1, float("-inf"))] * n_streams  # (window, bin, mag)

    def update(self, s: int, w0: int, idx: np.ndarray, val: np.ndarray):
        if len(val) == 0:
            return
        i = int(np.argmax(val))
        if float(val[i]) > self.best[s][2]:
            self.best[s] = (w0 + i, int(idx[i]), float(val[i]))

    def lines(self, prefix: str) -> list[str]:
        out = []
        for s, (w, b, m) in enumerate(self.best):
            tag = f" stream={s}" if len(self.best) > 1 else ""
            out.append(f"{prefix} peak{tag} window={w} bin={b} mag={m:.6g}")
        return out


def run_stream(cmd: argmod.StreamCmd, device: torch.device) -> int:
    """Drive the shift -> lowpass -> STFT chain over a capture on
    ``device``: through the fused frontend inside its envelope, through
    the chain of torch ops outside it (``StreamRunner``'s ``auto``)."""
    from quadrs_tpu_torch.models.receiver import PipelineConfig, PipelineModel
    from quadrs_tpu_torch.stream_runner import StreamRunner

    _refuse_not_ported("stream", cmd)
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
    if cmd.scan:
        # band survey of the DECIMATED channel: bins at the channel rate,
        # centred on the shift frequency (absolute Hz printed)
        result = runner.run_scan(threshold=cmd.threshold, max_chunks=cmd.chunks)
        width = cfg.fft_width
        ch_rate = src.sample_rate / cmd.decimate
        # shift f multiplies by e^{j 2pi f n / sr} (src/shift.rs:28), so
        # the tone that lands at DC is the one at -f: centre = -shift
        freq = -cmd.shift + (np.arange(width) - width // 2) * (ch_rate / width)
        if cmd.out is not None:
            path = f"{cmd.out}.scan.csv"
            with open(path, "w") as fh:
                fh.writelines(_scan_csv_lines(result, 0, freq))
            print(f"wrote {path}")
        _print_survey(result, freq, cmd.top, cmd.db, name="stream scan")
        print(_stats_line("stream", result.stats))
        return 0
    tracker = _PeakTracker(1)
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
                tracker.update(0, w0, idx, val)
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
                tracker.update(0, w0, np.argmax(norms, axis=-1), np.max(norms, axis=-1))
                if f is not None:
                    f.write(np.ascontiguousarray(norms, dtype=np.float32).tobytes())

            stats = runner.run(on_windows, max_chunks=cmd.chunks)

    for line in tracker.lines("stream"):
        print(line)
    for path in wrote:
        print(f"wrote {path}")
    print(_stats_line("stream", stats))
    return 0


def run_waterfall(cmd: argmod.WaterfallCmd, device: torch.device) -> int:
    """Stream a bank of captures through the waterfall kernels."""
    _refuse_not_ported("waterfall", cmd)
    sources, _, runner = _open_bank(cmd, device)
    tracker = _PeakTracker(len(sources))
    wrote: list[str] = []

    with contextlib.ExitStack() as stack:
        if cmd.search:
            csv = None
            if cmd.out is not None:
                path = f"{cmd.out}.peaks.csv"
                csv = stack.enter_context(open(path, "w"))
                csv.write("stream,window,bin,mag\n")
                wrote.append(path)

            def on_peaks(w0, out):
                idx, val = out  # (S, nw) each
                for s in range(idx.shape[0]):
                    tracker.update(s, w0, idx[s], val[s])
                    if csv is not None:
                        for i in range(idx.shape[1]):
                            csv.write(f"{s},{w0 + i},{int(idx[s, i])},{float(val[s, i]):.9g}\n")

            stats = runner.run_search(on_peaks, max_chunks=cmd.chunks)
        else:
            files = None
            if cmd.out is not None:
                files = []
                for s in range(len(sources)):
                    path = f"{cmd.out}.s{s}.norms.f32"
                    files.append(stack.enter_context(open(path, "wb")))
                    wrote.append(path)

            def on_norms(w0, norms):  # (S, nw, width)
                for s in range(norms.shape[0]):
                    tracker.update(s, w0, np.argmax(norms[s], axis=-1), np.max(norms[s], axis=-1))
                    if files is not None:
                        files[s].write(np.ascontiguousarray(norms[s], dtype=np.float32).tobytes())

            stats = runner.run(on_norms, max_chunks=cmd.chunks)

    for line in tracker.lines("waterfall"):
        print(line)
    for path in wrote:
        print(f"wrote {path}")
    print(_stats_line("waterfall", stats))
    return 0


def _open_bank(cmd, device: torch.device):
    """Sources, model and runner of a bank command (``waterfall`` and
    ``scan`` share the knobs: width, stride, window, chunk, filenames)."""
    from quadrs_tpu_torch.models.waterfall import WaterfallConfig, WaterfallModel
    from quadrs_tpu_torch.stream_runner import WaterfallRunner

    sources = [open_capture(f, cmd.sample_rate, cmd.format) for f in cmd.filenames]
    fmts = {s.format for s in sources}
    if len(fmts) != 1:
        raise ValueError(f"bank files disagree on format: {sorted(f.name for f in fmts)}")
    cfg = WaterfallConfig(
        n_streams=len(sources),
        fft_width=cmd.fft_width,
        stride=cmd.stride if cmd.stride is not None else cmd.fft_width,
        fmt=sources[0].format,
        windowing=cmd.windowing,
    )
    model = WaterfallModel(cfg)
    runner = WaterfallRunner(sources, model, device, chunk_windows=cmd.chunk_windows)
    return sources, model, runner


def _scan_csv_lines(result, s: int, freq) -> list[str]:
    """The survey CSV rows for stream ``s``."""
    avg, occ = result.avg, result.occupancy
    lines = ["bin,freq_hz,avg,max,above,occupancy\n"]
    for b in range(freq.shape[0]):
        lines.append(
            f"{b},{freq[b]:.6g},{avg[s, b]:.9g},"
            f"{result.max_norms[s, b]:.9g},{result.above[s, b]},"
            f"{occ[s, b]:.6g}\n"
        )
    return lines


def _print_survey(result, freq, top: int, db: bool, name: str = "scan") -> None:
    """Print the strongest-bins table of a :class:`ScanResult` (shared by
    ``scan`` and ``stream -scan``)."""
    width = freq.shape[0]
    avg, occ = result.avg, result.occupancy

    def fmt_pow(v: float) -> str:
        # norms are MAGNITUDES (sqrt(re^2+im^2)); power dB of a magnitude
        # is 20*log10, the rtl_power convention
        if not db:
            return f"{v:12.6g}"
        return f"{20.0 * np.log10(max(v, 1e-30)):9.2f} dB"

    for s in range(avg.shape[0]):
        tag = f" stream={s}" if avg.shape[0] > 1 else ""
        print(f"{name}{tag}: {result.windows} windows of {width} bins, threshold {result.threshold:g}")
        order = np.argsort(avg[s])[::-1][:top]
        print("   bin     freq_hz          avg          max  occupancy")
        for b in order:
            print(
                f"  {b:4d} {freq[b]:+11.1f} {fmt_pow(avg[s, b])} "
                f"{fmt_pow(float(result.max_norms[s, b]))} {occ[s, b]:9.1%}"
            )


def run_scan(cmd: argmod.ScanCmd, device: torch.device) -> int:
    """Band survey (the rtl_power product): per-bin average/max power and
    occupancy over every window, reduced on the device; prints the
    strongest bins with their frequency offsets, and ``-out`` writes the
    full per-bin table as CSV per stream."""
    _refuse_not_ported("scan", cmd)
    sources, model, runner = _open_bank(cmd, device)
    result = runner.run_scan(threshold=cmd.threshold, max_chunks=cmd.chunks)

    width = model.cfg.fft_width
    sr = sources[0].sample_rate
    # fftshifted bin b <-> frequency offset (b - width//2) * sr / width
    freq = (np.arange(width) - width // 2) * (sr / width)

    wrote: list[str] = []
    if cmd.out is not None:
        for s in range(len(sources)):
            path = f"{cmd.out}.s{s}.scan.csv"
            with open(path, "w" if cmd.overwrite else "x") as fh:
                fh.writelines(_scan_csv_lines(result, s, freq))
            wrote.append(path)

    _print_survey(result, freq, cmd.top, cmd.db, name="scan")
    for path in wrote:
        print(f"wrote {path}")
    print(_stats_line("scan", result.stats))
    return 0
