"""The CLI's serving products: ``stream``, ``waterfall``, ``scan``,
``info``, ``replay``, the receivers ``ook``, ``fsk``, ``psk``, ``fm``,
``am`` and ``ssb``, ``channelize``, and the TCP daemon ``serve``, which
serves ``stream``, ``waterfall``, ``scan``, ``find`` and the receivers
over its connections.

Their lines and files are the JAX package's (``quadrs_tpu.serve``): a
``<cmd> peak [stream=S] window=W bin=B mag=M`` line per stream, the
survey table of a scan (``-plot``: a survey PNG a stream), a ``wrote
PATH`` line per output file, and a
closing ``<cmd>: N samples, M windows, S.SSs, R.R Msps`` stats line.
``-out PREFIX`` streams results to files chunk by chunk: norms as raw
f32 rows, peaks and survey tables as CSV.  ``-stdin yes`` reads a live
pipe in place of a file; ``stream -trigger`` records bursts as byte-exact
slices of the capture; ``replay`` is the pipe's producer side.  The
receivers print bits, or write audio (``-out PREFIX``: raw mono f32 or,
with ``-wav yes``, a WAV; ``-out -``: the same bytes to stdout, the meter
line then to stderr) and print a meter line; ``psk -plot`` writes the
constellation.  ``channelize`` writes a file a channel (``-out``) and
prints an RMS meter.  ``serve`` answers each connection with what the
command of its ``-mode`` prints or writes (:func:`run_serve`).
"""

from __future__ import annotations

import contextlib
import math
import os
import stat
import sys
import time

import numpy as np
import torch

from quadrs_tpu_torch import args as argmod
from quadrs_tpu_torch.parallel.sharding import mesh_of
from quadrs_tpu_torch.sources import PipeSource, RawRing, SampleSource, open_capture
from quadrs_tpu_torch.stream_runner import BurstGate, RunStats, burst_spans
from quadrs_tpu_torch.utils.sniff import guess_details

def _refuse_mesh(name: str, cmd) -> None:
    """The receivers' and the daemon's ``-mesh`` parses but is not ported
    yet (ROADMAP A13)."""
    if cmd.mesh is not None:
        raise NotImplementedError(f"{name} -mesh (multi-GPU sharding, ROADMAP A13) is not yet ported to quadrs_tpu_torch")


def _stdin_pipe_source(cmd) -> PipeSource:
    """Live, unbuffered stdin as a :class:`PipeSource`.  The parser made
    sure of ``-sr`` and ``-format`` (a pipe has no filename to sniff), so
    the sniffed name never matters."""
    details = guess_details("-", cmd.sample_rate, cmd.format)
    return PipeSource(sys.stdin.buffer, details.format, details.sample_rate)


# the receivers buffer the whole piped burst in memory; the cap makes a
# live radio stream piped into one an error instead of unbounded growth
_STDIN_BUFFER_CAP = 1 << 30


def _cmd_source(cmd) -> SampleSource:
    """The capture behind a receiver command: a file, or all of stdin
    buffered into an in-memory :class:`SampleSource` (receiver captures are
    bursts; ``stream``/``waterfall`` read stdin as a live pipe instead)."""
    if not cmd.stdin:
        return open_capture(cmd.filename, cmd.sample_rate, cmd.format)
    details = guess_details("-", cmd.sample_rate, cmd.format)
    data = sys.stdin.buffer.read(_STDIN_BUFFER_CAP + 1)
    if len(data) > _STDIN_BUFFER_CAP:
        raise ValueError(
            "stdin capture exceeds the demod buffer cap (1 GiB); ook/fsk "
            "buffer the whole burst — use stream/waterfall for live streams"
        )
    return SampleSource(np.frombuffer(data, dtype=np.uint8), details.format, details.sample_rate)


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

    # live pipe input: rtl_sdr - | python -m quadrs_tpu_torch stream -stdin yes ...
    if cmd.stdin:
        src = _stdin_pipe_source(cmd)
    else:
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
    runner = StreamRunner(src, PipelineModel(cfg), device, chunk_samples=cmd.chunk, mesh=mesh_of(cmd.mesh))
    if cmd.trigger is not None:
        return _run_stream_trigger(cmd, src, runner)
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
                    f.write(np.ascontiguousarray(norms, dtype=np.float32))  # its buffer, with no copy

            stats = runner.run(on_windows, max_chunks=cmd.chunks)

    for line in tracker.lines("stream"):
        print(line)
    for path in wrote:
        print(f"wrote {path}")
    print(_stats_line("stream", stats))
    return 0


def _run_stream_trigger(cmd: argmod.StreamCmd, src, runner) -> int:
    """Burst recorder (the rtl_433-style squelch): gate on the decimated
    channel's per-window peak magnitude (the search output), widen each
    active run by ``-pre``/``-post`` windows, and write every burst as a
    byte-exact slice of the original capture that ``from`` can read back:
    ``{out}.bK.s{start}.sr{rate}.{fmt}`` (native format, no decode)."""
    if getattr(src, "is_pipe", False):
        return _run_stream_trigger_live(cmd, src, runner)

    vals: list[np.ndarray] = []
    stats = runner.run_search(lambda w0, out: vals.append(np.asarray(out[1])), max_chunks=cmd.chunks)
    val = np.concatenate(vals) if vals else np.zeros(0, np.float32)
    win_raw = cmd.decimate * cmd.fft_width
    spans = burst_spans(val > np.float32(cmd.trigger), cmd.pre, cmd.post)
    ext = src.format.value  # the enum values are the extensions
    for k, (a, b) in enumerate(spans):
        s0 = a * win_raw
        s1 = min((b + 1) * win_raw, src.length)
        path = f"{cmd.out}.b{k}.s{s0}.sr{src.sample_rate}.{ext}"
        with open(path, "wb") as fh:
            fh.write(src.raw_bytes(s0, s1))
        peak = float(val[a : b + 1].max())
        print(f"stream burst {k}: windows {a}..{b}, samples {s0}..{s1}, peak {peak:.6g}, wrote {path}")
    print(f"stream trigger: {len(spans)} bursts over {len(val)} windows, level {cmd.trigger:g}")
    print(_stats_line("stream", stats))
    return 0


def _run_stream_trigger_live(cmd: argmod.StreamCmd, src, runner) -> int:
    """The burst recorder off a live pipe (``stream -stdin -trigger``): the
    pipe keeps a rolling raw-byte ring (pruned to the earliest window an
    unresolved span might still need, so memory is O(open burst +
    context), capped), an incremental :class:`BurstGate` resolves spans
    with exactly :func:`burst_spans`'s semantics, and each burst file is
    written as it resolves: the same bytes and names as the file run over
    the same stream."""
    ring = RawRing(src.format.pair_bytes)
    src.byte_ring = ring
    gate = BurstGate(cmd.pre, cmd.post)
    win_raw = cmd.decimate * cmd.fft_width
    lvl = np.float32(cmd.trigger)
    ext = src.format.value
    # per-window peaks kept for the same horizon as the byte ring (the
    # summary line prints each burst's peak)
    vals: list[float] = []
    vals_base = 0
    state = {"k": 0, "windows": 0}

    def emit(a: int, b: int) -> None:
        s0 = a * win_raw
        s1 = min((b + 1) * win_raw, ring.end)
        path = f"{cmd.out}.b{state['k']}.s{s0}.sr{src.sample_rate}.{ext}"
        with open(path, "wb") as fh:
            fh.write(ring.slice(s0, s1))
        peak = max(vals[a - vals_base : b + 1 - vals_base])
        print(f"stream burst {state['k']}: windows {a}..{b}, samples {s0}..{s1}, peak {peak:.6g}, wrote {path}")
        state["k"] += 1

    def on_peaks(w0, out):
        nonlocal vals, vals_base
        val = np.asarray(out[1])
        vals.extend(float(v) for v in val)
        state["windows"] = w0 + len(val)
        for a, b in gate.feed(val > lvl):
            emit(a, b)
        keep = gate.earliest_needed()
        ring.prune(keep * win_raw)
        if keep > vals_base:
            vals = vals[keep - vals_base :]
            vals_base = keep

    stats = runner.run_search(on_peaks, max_chunks=cmd.chunks)
    for a, b in gate.finish(state["windows"]):
        emit(a, b)
    print(f"stream trigger: {state['k']} bursts over {state['windows']} windows, level {cmd.trigger:g}")
    print(_stats_line("stream", stats))
    return 0


def run_waterfall(cmd: argmod.WaterfallCmd, device: torch.device) -> int:
    """Stream a bank of captures through the waterfall kernels."""
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
                        files[s].write(np.ascontiguousarray(norms[s], dtype=np.float32))  # its buffer, with no copy

            stats = runner.run(on_norms, max_chunks=cmd.chunks)

    for line in tracker.lines("waterfall"):
        print(line)
    for path in wrote:
        print(f"wrote {path}")
    print(_stats_line("waterfall", stats))
    return 0


def _open_bank(cmd, device: torch.device):
    """Sources, model and runner of a bank command (``waterfall`` and
    ``scan`` share the knobs: width, stride, window, chunk, stdin,
    filenames)."""
    from quadrs_tpu_torch.models.waterfall import WaterfallConfig, WaterfallModel
    from quadrs_tpu_torch.stream_runner import WaterfallRunner

    if cmd.stdin:
        sources = [_stdin_pipe_source(cmd)]
    else:
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
    runner = WaterfallRunner(sources, model, device, chunk_windows=cmd.chunk_windows, mesh=mesh_of(cmd.mesh))
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
    if cmd.plot:
        from quadrs_tpu_torch.viz.survey import survey_render_file

        for s in range(len(sources)):
            path = f"{cmd.out or 'scan'}.s{s}.png"
            wrote.append(str(survey_render_file(result, s, path, overwrite=cmd.overwrite)))

    _print_survey(result, freq, cmd.top, cmd.db, name="scan")
    for path in wrote:
        print(f"wrote {path}")
    print(_stats_line("scan", result.stats))
    return 0


def run_info(cmd: argmod.InfoCmd, device: torch.device) -> int:
    """Per-capture statistics (``info``): the ``soxi`` of IQ files.  Prints
    format, rate and length from the header math, plus the device-reduced
    signal stats of :func:`quadrs_tpu_torch.sinks.capture_info`: DC offset
    (a direct-conversion tuner's centre spike), RMS, peak and crest, the
    circularity ratio (the IQ-image indicator: image level is ``|rho|/2``)
    and the raw-code clipping fraction (components at a rail: gain too
    hot)."""
    from quadrs_tpu_torch.sinks import capture_info

    def db(x: float) -> str:
        return f"{20.0 * math.log10(max(x, 1e-30)):.1f} dB"

    t0 = time.perf_counter()
    total = 0
    for name in cmd.filenames:
        src = open_capture(name, cmd.sample_rate, cmd.format)
        i = capture_info(src, chunk=cmd.chunk, limit=cmd.limit, device=device)
        total += i.analyzed
        scope = "" if i.analyzed == i.samples else f" (stats over the first {i.analyzed})"
        print(
            f"{name}: {i.format.value}, {i.sample_rate} Hz, "
            f"{i.samples} samples, {i.bytes} bytes, {i.seconds:.3f} s{scope}"
        )
        dc_rel = abs(i.dc) / max(i.rms, 1e-30)
        print(
            f"  dc {i.dc.real:+.5g}{i.dc.imag:+.5g}j"
            f" (|dc|/rms {db(dc_rel)})   rms {i.rms:.5g}   "
            f"peak {i.peak:.5g} (crest {db(i.peak / max(i.rms, 1e-30))})"
        )
        clip = "n/a (float format)" if i.clipped is None else f"{100.0 * i.clipped:.4g}% of components"
        print(
            f"  iq image |rho|/2 {abs(i.rho) / 2.0:.4g}"
            f" ({db(abs(i.rho) / 2.0)} image)   clipped: {clip}"
        )
    dt = max(time.perf_counter() - t0, 1e-9)
    print(f"info: {len(cmd.filenames)} files, {total} samples, {dt:.2f}s, {total / dt / 1e6:.0f} Msps")
    return 0


def run_replay(cmd: argmod.ReplayCmd, device: torch.device) -> int:
    """Stream a capture's raw bytes to stdout paced at its sample rate
    (``replay``): the producer side of the live-pipe story, so any
    ``-stdin`` consumer can be exercised against a recorded capture exactly
    as it would run against a radio.  The bytes are the file's own (no
    decode, no device work); pacing writes ``-chunk`` samples, then sleeps
    to the global schedule (cumulative, so jitter does not build up).
    Stats go to stderr: stdout is the data stream, and it is closed as soon
    as the last byte is written, so the consumer sees the end of the stream
    then and not when this process has finished exiting."""
    src = open_capture(cmd.filename, cmd.sample_rate, cmd.format)
    out = sys.stdout.buffer
    total = 0
    t0 = time.perf_counter()
    try:
        for _ in range(cmd.loop):
            off = 0
            while off < src.length:
                n = min(cmd.chunk, src.length - off)
                out.write(src.raw_bytes(off, off + n))
                off += n
                total += n
                if cmd.speed > 0:
                    due = t0 + total / (src.sample_rate * cmd.speed)
                    delay = due - time.perf_counter()
                    if delay > 0:
                        time.sleep(delay)
        out.flush()
        done = True
    except BrokenPipeError:
        # the consumer closed its end (piped into `head`, or a run bounded
        # by -chunks): stop quietly
        done = False
    # point a piped stdout at devnull: the pipe's write end closes now, and
    # interpreter shutdown does not raise on its flush after a broken pipe
    try:
        fd = sys.stdout.fileno()
    except (AttributeError, OSError, ValueError):
        fd = None  # not a file (a test's capture)
    if fd is not None and (not done or stat.S_ISFIFO(os.fstat(fd).st_mode)):
        null = os.open(os.devnull, os.O_WRONLY)
        os.dup2(null, fd)
        os.close(null)
    dt = max(time.perf_counter() - t0, 1e-9)
    print(f"replay: {total} samples, {dt:.2f}s, {total / dt / 1e6:.1f} Msps", file=sys.stderr)
    return 0


def run_ook(cmd: argmod.OokCmd, device: torch.device) -> int:
    """Demodulate an OOK capture and print the recovered bits."""
    from quadrs_tpu_torch.models.demod import OokDemod, manchester_decode

    _refuse_mesh("ook", cmd)
    src = _cmd_source(cmd)
    demod = OokDemod(width=cmd.width, stride=cmd.stride, threshold=cmd.threshold, samples_per_bit=cmd.bit)
    err, raw_bits = demod.demodulate(src, device=device)
    if cmd.raw:
        print("".join("1" if b else "0" for b in raw_bits))
    else:
        print("".join(str(b) for b in manchester_decode(raw_bits)))
    print(f"ook: {len(raw_bits)} raw bits, clock error {err:.3f}")
    return 0


def run_fsk(cmd: argmod.FskCmd, device: torch.device) -> int:
    """Demodulate a two-tone FSK capture and print the recovered symbols
    (one a window, without ``-bit``) or clock-recovered bits."""
    from quadrs_tpu_torch.models.demod import FskDemod

    _refuse_mesh("fsk", cmd)
    src = _cmd_source(cmd)
    demod = FskDemod(
        center=cmd.shift, bandwidth=cmd.lowpass, decimate=cmd.decimate, taps=cmd.size,
        fft_width=cmd.fft_width, stride=cmd.stride, samples_per_symbol=1.0 if cmd.bit is None else cmd.bit,
    )
    if cmd.bit is None:
        syms = demod.symbols(src, device=device)
        print("".join(str(int(s)) for s in syms))
        print(f"fsk: {len(syms)} symbols")
    else:
        err, bits = demod.demodulate(src, device=device)
        print("".join("1" if b else "0" for b in bits))
        print(f"fsk: {len(bits)} bits, clock error {err:.3f}")
    return 0


def run_psk(cmd: argmod.PskCmd, device: torch.device) -> int:
    """Demodulate a BPSK/QPSK capture and print the recovered bits and the
    estimates; ``-plot`` writes the constellation."""
    from quadrs_tpu_torch.models.demod import PskDemod

    _refuse_mesh("psk", cmd)
    src = _cmd_source(cmd)
    demod = PskDemod(
        center=cmd.shift, bandwidth=cmd.lowpass, decimate=cmd.decimate, taps=cmd.size, symbol_rate=cmd.symbol_rate,
        order=cmd.order, differential=cmd.differential, block=cmd.block,
    )
    est, sym = demod.symbols(src, device=device)
    bits = demod.slice(sym)
    print("".join(map(str, bits)))
    print(f"psk: {len(bits)} bits, freq {est.freq_hz:+.1f} Hz, phase {est.phase:+.3f} rad, tau {est.tau:.2f}, sps {est.sps:g}")
    if cmd.plot is not None:
        from quadrs_tpu_torch.viz.constellation import constellation_render_file

        path = constellation_render_file(sym, cmd.order, cmd.plot, overwrite=cmd.overwrite)
        print(f"psk: constellation -> {path}")
    return 0


def channel_center(ch: int, sample_rate: int, k: int) -> int:
    """Channel ``ch``'s centre in Hz: DFT-bin order, the upper half aliased
    to negative frequencies (odd K: bins from (K+1)//2 on)."""
    return ch * sample_rate // k if ch < (k + 1) // 2 else (ch - k) * sample_rate // k


def run_channelize(cmd: argmod.ChannelizeCmd, device: torch.device) -> int:
    """Split a capture into K channels in one polyphase-bank pass: write each
    selected channel as ``{prefix}.ch{k}.sr{rate}.cf32`` (``-out``), and
    print a channel RMS meter and the ``channelize: ... Msps`` line."""
    from quadrs_tpu_torch.models.channelizer import Channelize, run_channelize as run_bank

    src = _cmd_source(cmd)
    chan = Channelize(src, cmd.channels, frequency=cmd.frequency, size=cmd.size)
    k = chan.channels
    select = tuple(range(k)) if cmd.select is None else cmd.select
    rate = chan.sample_rate
    files = {}
    sumsq = np.zeros(k, dtype=np.float64)
    n_out = 0
    t0 = time.perf_counter()
    try:
        if cmd.out is not None:
            for ch in select:
                files[ch] = open(f"{cmd.out}.ch{ch}.sr{rate}.cf32", "wb" if cmd.overwrite else "xb")
        for piece in run_bank(chan, device=device, chunk=cmd.chunk, mesh=mesh_of(cmd.mesh)):
            n_out = piece.start + piece.data.shape[1]
            sumsq += np.sum(np.square(piece.data.real, dtype=np.float64) + np.square(piece.data.imag, dtype=np.float64), axis=1)
            for ch, fh in files.items():
                fh.write(piece.data[ch].astype("<c8").tobytes())  # interleaved re, im f32
    finally:
        for fh in files.values():
            fh.close()
    secs = time.perf_counter() - t0
    rms = np.sqrt(sumsq / max(n_out, 1))
    for ch in select:
        line = f"channel {ch}: center {channel_center(ch, src.sample_rate, k)} Hz, rms {rms[ch]:.6g}"
        if cmd.out is not None:
            line += f", wrote {cmd.out}.ch{ch}.sr{rate}.cf32"
        print(line)
    print(f"channelize: {k} channels @ {rate} Hz, {n_out} samples each, {secs:.2f}s, "
          f"{src.length / max(secs, 1e-9) / 1e6:.1f} Msps")
    return 0


def _write_audio(cmd, rate: int, audio: np.ndarray) -> str | None:
    """Write the audio as the command's flags say: raw mono LE f32
    (``{prefix}.sr{rate}.f32``) or, with ``-wav yes``, a mono float32 WAV
    (``{prefix}.wav``); ``-out -`` writes the same bytes to stdout (pipe
    them into a player) and returns None."""
    from quadrs_tpu_torch.utils.wav import wav_bytes, write_wav

    if cmd.out == "-":
        sys.stdout.buffer.write(wav_bytes(rate, audio) if cmd.wav else audio.astype("<f4").tobytes())
        sys.stdout.buffer.flush()
        return None
    if cmd.wav:
        return write_wav(f"{cmd.out}.wav", rate, audio, overwrite=cmd.overwrite)
    filename = f"{cmd.out}.sr{rate}.f32"
    with open(filename, "wb" if cmd.overwrite else "xb") as fh:
        fh.write(audio.astype("<f4").tobytes())
    return filename


def _emit_audio(cmd, rate: int, audio: np.ndarray):
    """Handle an audio command's output flags; returns where the meter line
    goes (stderr when the audio itself went to stdout)."""
    if cmd.out is None:
        return sys.stdout
    written = _write_audio(cmd, rate, audio)
    if written is None:
        return sys.stderr
    print(written)
    return sys.stdout


def _run_audio(cmd, demod, device: torch.device, meter) -> int:
    """Run an analog receiver over the command's capture, write its audio
    as the flags say, and print ``meter(rate, audio, peak, rms)`` with the
    capture's Msps (peak and rms of the audio, f64 mean square)."""
    src = _cmd_source(cmd)
    t0 = time.perf_counter()
    rate, audio = demod.demodulate(src, device=device)
    secs = time.perf_counter() - t0
    meter_out = _emit_audio(cmd, rate, audio)
    peak = np.max(np.abs(audio)) if len(audio) else 0.0
    rms = np.sqrt(np.mean(np.square(audio, dtype=np.float64))) if len(audio) else 0.0
    print(f"{meter(rate, audio, peak, rms)}, {src.length / max(secs, 1e-9) / 1e6:.1f} Msps", file=meter_out)
    return 0


def run_fm(cmd: argmod.FmCmd, device: torch.device) -> int:
    """Demodulate an analog-FM capture to audio: write it (``-out``) and
    print a deviation meter."""
    from quadrs_tpu_torch.models.demod import FmDemod

    _refuse_mesh("fm", cmd)
    demod = FmDemod(
        center=cmd.shift, bandwidth=cmd.lowpass, decimate=cmd.decimate, taps=cmd.size, deviation=cmd.deviation,
        audio_bandwidth=cmd.audio_lowpass, audio_decimate=cmd.audio_decimate, audio_taps=cmd.audio_size,
        audio_rate=cmd.audio_rate,
    )
    dev = np.float32(cmd.deviation)  # the audio's full scale in Hz

    def meter(rate, audio, peak, rms):
        return (f"fm: {len(audio)} audio samples @ {rate} Hz ({len(audio) / rate:.3f} s), peak deviation "
                f"{float(peak * dev):.0f} Hz, rms {float(rms * dev):.0f} Hz")

    return _run_audio(cmd, demod, device, meter)


def run_am(cmd: argmod.AmCmd, device: torch.device) -> int:
    """Demodulate an AM capture to audio in modulation-depth units: write it
    (``-out``) and print a modulation meter."""
    from quadrs_tpu_torch.models.demod import AmDemod

    _refuse_mesh("am", cmd)
    demod = AmDemod(
        center=cmd.shift, bandwidth=cmd.lowpass, decimate=cmd.decimate, taps=cmd.size,
        audio_bandwidth=cmd.audio_lowpass, audio_decimate=cmd.audio_decimate, audio_taps=cmd.audio_size,
        audio_rate=cmd.audio_rate,
    )

    def meter(rate, audio, peak, rms):
        return (f"am: {len(audio)} audio samples @ {rate} Hz ({len(audio) / rate:.3f} s), peak modulation "
                f"{float(peak):.3f}, rms {float(rms):.3f}")

    return _run_audio(cmd, demod, device, meter)


def run_ssb(cmd: argmod.SsbCmd, device: torch.device) -> int:
    """Demodulate a single-sideband capture to audio (usb or lsb)."""
    from quadrs_tpu_torch.models.demod import SsbDemod

    _refuse_mesh("ssb", cmd)
    demod = SsbDemod(
        center=cmd.shift, sideband=cmd.sideband, bandwidth=cmd.bandwidth, decimate=cmd.decimate, taps=cmd.size,
        audio_bandwidth=cmd.audio_lowpass, audio_decimate=cmd.audio_decimate, audio_taps=cmd.audio_size,
        audio_rate=cmd.audio_rate,
    )

    def meter(rate, audio, peak, rms):
        return (f"ssb: {len(audio)} audio samples @ {rate} Hz ({len(audio) / rate:.3f} s, {cmd.sideband}), "
                f"peak {float(peak):.3f}, rms {float(rms):.3f}")

    return _run_audio(cmd, demod, device, meter)


# -- the serve daemon ----------------------------------------------------------

_RECEIVERS = ("ook", "fsk", "psk", "fm", "am", "ssb")  # the modes that buffer a burst and answer with bits or audio


def _make_serve_demod(cmd: argmod.ServeCmd):
    """The receiver behind ``serve -mode ook|fsk|psk|fm|am|ssb``, made once
    at startup.  The receivers keep no device state between bursts (each
    burst builds its own channel step), so sessions share them as they are."""
    from quadrs_tpu_torch.models import demod as dm

    if cmd.mode == "ook":
        return dm.OokDemod(width=cmd.fft_width, stride=cmd.stride if cmd.stride is not None else 2,
                           threshold=cmd.threshold, samples_per_bit=cmd.bit if cmd.bit is not None else 8.0)
    audio = dict(audio_bandwidth=cmd.audio_lowpass, audio_decimate=cmd.audio_decimate, audio_taps=cmd.audio_size,
                 audio_rate=cmd.audio_rate)
    if cmd.mode == "am":
        return dm.AmDemod(center=cmd.shift, bandwidth=cmd.lowpass, decimate=cmd.decimate, taps=cmd.size, **audio)
    if cmd.mode == "fm":
        return dm.FmDemod(center=cmd.shift, bandwidth=cmd.lowpass, decimate=cmd.decimate, taps=cmd.size,
                          deviation=cmd.deviation, **audio)
    if cmd.mode == "ssb":
        return dm.SsbDemod(center=cmd.shift, sideband=cmd.sideband, bandwidth=cmd.bandwidth, decimate=cmd.decimate,
                           taps=cmd.size, **audio)
    if cmd.mode == "psk":
        return dm.PskDemod(center=cmd.shift, bandwidth=cmd.lowpass, decimate=cmd.decimate, taps=cmd.size,
                           symbol_rate=cmd.symbol_rate, order=cmd.order, differential=cmd.differential, block=cmd.block)
    return dm.FskDemod(center=cmd.shift, bandwidth=cmd.lowpass, decimate=cmd.decimate, taps=cmd.size,
                       fft_width=cmd.fft_width, stride=cmd.stride,
                       samples_per_symbol=1.0 if cmd.bit is None else cmd.bit)


@contextlib.contextmanager
def _socket_files(conn):
    """The connection's read and write files, closed at the end; a client
    gone before the final flush does not mask a completed session."""
    rf, wf = conn.makefile("rb"), conn.makefile("wb")
    try:
        yield rf, wf
    finally:
        try:
            wf.close()
        except OSError:
            pass
        finally:
            rf.close()


def _demod_connection(conn, demod, cmd: argmod.ServeCmd, fmt, sample_rate: int, device: torch.device) -> RunStats:
    """One receiver session: the client sends its whole burst and
    half-closes; the daemon buffers it (the 1 GiB cap of ``ook -stdin``),
    demodulates it, and answers with exactly the lines the receiver's
    command prints (or, for audio, :func:`_demod_reply`'s framing)."""
    with _socket_files(conn) as (rf, wf):
        data = rf.read(_STDIN_BUFFER_CAP + 1)
        if len(data) > _STDIN_BUFFER_CAP:
            msg = ("connection burst exceeds the demod buffer cap (1 GiB); demod modes buffer the whole burst — "
                   "use -mode stream/waterfall for unbounded streams")
            try:
                wf.write(f"# error: {msg}\n".encode())
                wf.flush()
            except OSError:
                pass
            raise ValueError(msg)
        src = SampleSource(np.frombuffer(data, dtype=np.uint8), fmt, sample_rate)
        t0 = time.perf_counter()
        try:
            return _demod_reply(wf, demod, cmd, src, t0, device)
        except ValueError as e:
            # a bad burst (empty, shorter than the filter or the window) is
            # the client's mistake, not the daemon's: answer why, and count
            # the session as served
            wf.write(f"# error: {e}\n".encode())
            wf.flush()
            return RunStats(samples_in=src.length, windows_out=0, seconds=time.perf_counter() - t0)


def _demod_reply(wf, demod, cmd: argmod.ServeCmd, src, t0: float, device: torch.device) -> RunStats:
    """Demodulate one buffered burst and write the answer: the bits or
    symbols line and a ``# <cmd>: ...`` trailer, or for audio a
    ``# MODE N RATE`` header, N little-endian f32 samples and a trailer."""
    if cmd.mode in ("fm", "am", "ssb"):
        rate, audio = demod.demodulate(src, device=device)
        wf.write(f"# {cmd.mode} {len(audio)} {rate}\n".encode())
        wf.write(audio.astype("<f4").tobytes())
        wf.write(f"\n# {cmd.mode}: {len(audio)} audio samples @ {rate} Hz\n".encode())
        wf.flush()
        return RunStats(samples_in=src.length, windows_out=len(audio), seconds=time.perf_counter() - t0)
    if cmd.mode == "psk":
        est, bits = demod.demodulate(src, device=device)
        line, n_out = "".join(map(str, bits)), len(bits)
        trailer = (f"psk: {len(bits)} bits, freq {est.freq_hz:+.1f} Hz, phase {est.phase:+.3f} rad, "
                   f"tau {est.tau:.2f}, sps {est.sps:g}")
    elif cmd.mode == "ook":
        from quadrs_tpu_torch.models.demod import manchester_decode

        err, raw_bits = demod.demodulate(src, device=device)
        if cmd.raw:
            line = "".join("1" if b else "0" for b in raw_bits)
        else:
            line = "".join(str(b) for b in manchester_decode(raw_bits))
        n_out = len(raw_bits)
        trailer = f"ook: {len(raw_bits)} raw bits, clock error {err:.3f}"
    elif cmd.bit is None:
        syms = demod.symbols(src, device=device)
        line, n_out = "".join(str(int(s)) for s in syms), len(syms)
        trailer = f"fsk: {len(syms)} symbols"
    else:
        err, bits = demod.demodulate(src, device=device)
        line, n_out = "".join("1" if b else "0" for b in bits), len(bits)
        trailer = f"fsk: {len(bits)} bits, clock error {err:.3f}"
    wf.write(f"{line}\n# {trailer}\n".encode())
    wf.flush()
    return RunStats(samples_in=src.length, windows_out=n_out, seconds=time.perf_counter() - t0)


def _serve_stream(rf, wf, model, cmd: argmod.ServeCmd, sample_rate: int, device: torch.device) -> RunStats:
    """Run ``stream``, ``waterfall`` or ``scan`` over the byte stream ``rf``
    (a :class:`PipeSource`) and write the answer to ``wf`` as each chunk
    completes: ``window,bin,mag`` CSV and a ``# <mode>: ...`` trailer
    (``-search yes``), raw f32 norms rows, or at EOF the survey CSV
    (``-mode scan``).  The runner is made here, so its rings record their
    events on the caller's current CUDA stream."""
    from quadrs_tpu_torch.stream_runner import StreamRunner, WaterfallRunner

    waterfall = cmd.mode in ("waterfall", "scan")
    src = PipeSource(rf, model.cfg.fmt, sample_rate)
    if waterfall:
        runner = WaterfallRunner([src], model, device, chunk_windows=cmd.chunk)
    else:
        runner = StreamRunner(src, model, device, chunk_samples=cmd.chunk)
    if cmd.mode == "scan":
        # the reduction streams on the device; the answer is one small CSV at EOF
        result = runner.run_scan(threshold=cmd.threshold)
        width = model.cfg.fft_width
        freq = (np.arange(width) - width // 2) * (sample_rate / width)
        wf.writelines(ln.encode() for ln in _scan_csv_lines(result, 0, freq))
        stats = result.stats
        wf.write(f"# {_stats_line('scan', stats)} ({result.windows} windows, threshold {cmd.threshold:g})\n".encode())
    elif cmd.search:
        wf.write(b"window,bin,mag\n")

        def on_peaks(w0, out):
            idx, val = out
            if waterfall:  # (1, nw) bank shapes -> flat
                idx, val = idx[0], val[0]
            wf.write("".join(f"{w0 + i},{int(idx[i])},{float(val[i]):.9g}\n" for i in range(len(idx))).encode())
            wf.flush()

        stats = runner.run_search(on_peaks)
        wf.write(f"# {_stats_line(cmd.mode, stats)}\n".encode())
    else:

        def on_windows(w0, norms):
            wf.write(np.ascontiguousarray(norms[0] if waterfall else norms, dtype=np.float32))
            wf.flush()

        stats = runner.run(on_windows)
    wf.flush()
    return stats


def _serve_connection(conn, model, cmd: argmod.ServeCmd, sample_rate: int, device: torch.device) -> RunStats:
    """One ``stream``/``waterfall``/``scan`` session: raw IQ bytes in,
    results back over the same socket as each chunk completes.

    The client sends its capture, half-closes its write side
    (``shutdown(SHUT_WR)``) to mark EOF, and reads to the daemon's close;
    it must read while it sends: results come back chunk by chunk, and a
    client that does not read them stalls the daemon's write, which stops
    the daemon reading, a deadlock on both sides."""
    with _socket_files(conn) as (rf, wf):
        return _serve_stream(rf, wf, model, cmd, sample_rate, device)


def _find_connection(conn, patterns, cmd: argmod.ServeCmd, fmt, sample_rate: int, device: torch.device) -> RunStats:
    """One matched-filter session: the connection's bytes run through
    :func:`quadrs_tpu_torch.sinks.find_pattern` as a live pipe (O(chunk)
    memory, no buffered burst), and the matches come back at EOF as
    exactly the lines ``find -stdin`` prints.  Each session makes its own
    template tables, so sessions share nothing on the device."""
    from quadrs_tpu_torch import sinks
    from quadrs_tpu_torch.sources import LivePipeStream

    t0 = time.perf_counter()
    with _socket_files(conn) as (rf, wf):
        try:
            res = sinks.find_pattern(
                LivePipeStream(PipeSource(rf, fmt, sample_rate)),
                patterns if len(patterns) > 1 else patterns[0],
                threshold=cmd.threshold, chunk=cmd.chunk, max_matches=cmd.top if cmd.top else None,
                min_distance=cmd.distance, freq_tol=cmd.freq_tol, freq_step=cmd.freq_step, device=device,
            )
        except ValueError as e:
            # a bad burst (shorter than the template) answers with the error
            wf.write(f"# error: {e}\n".encode())
            wf.flush()
            return RunStats(samples_in=0, windows_out=0, seconds=time.perf_counter() - t0)
        bank = len(patterns) > 1
        for o, s, a, f, w in zip(res.offsets, res.scores, res.scales, res.freqs, res.which):
            line = f"{int(o)},{float(s):.4f},{float(a):.6g},{float(f):+g}"
            wf.write((line + (f",{int(w)}" if bank else "") + "\n").encode())
        wf.write(f"# find: {len(res.offsets)} matches, pattern {res.pattern_len} samples, {res.scanned} scanned\n".encode())
        wf.flush()
        return RunStats(samples_in=res.scanned, windows_out=len(res.offsets), seconds=time.perf_counter() - t0)


def _log(line: str) -> None:
    """One line of the daemon's log in one write, so that the lines of
    sessions on several threads do not interleave."""
    sys.stdout.write(line + "\n")
    sys.stdout.flush()


def _serve_model(cmd: argmod.ServeCmd, details, device: torch.device):
    """The mode's model, made once, and everything its sessions will share
    made with it, before the first connection: the kernel library (nvcc)
    and the capture loader (g++) built and loaded; TF32 off; for
    ``stream``, ``waterfall`` and ``scan`` the model on the device and one
    warm session over a few zero samples, which makes the tables a model
    makes at its first call (the decode table, the DFT tables) and launches
    each kernel of the mode once.  On CUDA all of it runs on the default
    stream and is synchronized, so a session's stream reads finished
    tables.  A kernel that does not build or launch raises here."""
    import io

    from quadrs_tpu_torch import native

    native.library()
    if device.type == "cuda":
        from quadrs_tpu_torch.ops import _cuda
        from quadrs_tpu_torch.ops.frontend import no_tf32

        no_tf32()  # embedders call run_serve without cli.main
        _cuda.library()
    if cmd.mode in _RECEIVERS:
        model = _make_serve_demod(cmd)
    elif cmd.mode == "find":
        # the template bank, loaded once; each connection streams through it
        model = []
        for fname in cmd.patterns:
            psrc = SampleSource.from_file(fname, guess_details(fname, None, None))
            if psrc.sample_rate != details.sample_rate:
                raise ValueError(
                    f"pattern rate {psrc.sample_rate} != -sr {details.sample_rate}: resample one side first"
                )
            pat, valid = psrc.read_at(0, psrc.length, device)
            if valid != psrc.length:
                raise RuntimeError("short read loading the pattern capture")
            model.append(pat)
    else:
        if cmd.mode in ("waterfall", "scan"):
            from quadrs_tpu_torch.models.waterfall import WaterfallConfig, WaterfallModel

            model = WaterfallModel(WaterfallConfig(
                n_streams=1, fft_width=cmd.fft_width,
                stride=cmd.stride if cmd.stride is not None else cmd.fft_width, fmt=details.format,
            ))
            warm = cmd.fft_width  # one window
        else:
            from quadrs_tpu_torch.models.receiver import PipelineConfig, PipelineModel

            model = PipelineModel(PipelineConfig(
                sample_rate=details.sample_rate, shift_freq=cmd.shift, lp_freq=cmd.lowpass,
                decimate=cmd.decimate, taps=cmd.size, fft_width=cmd.fft_width, fmt=details.format,
            ))
            warm = model.cfg.window_raw + model.cfg.taps  # one window and its filter span
        model.to(device)
        zeros = io.BytesIO(bytes(warm * details.format.pair_bytes))
        _serve_stream(zeros, io.BytesIO(), model, cmd, details.sample_rate, device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return model


def run_serve(cmd: argmod.ServeCmd, device: torch.device, ready=None, max_connections=None) -> int:
    """The TCP daemon: one model made at startup (:func:`_serve_model`),
    many connections, served one after another, or up to ``-parallel N``
    at once on a pool of threads, each session inside a CUDA stream of its
    own.  ``-mode ook|fsk|psk|fm|am|ssb`` serves the receivers: each
    connection's burst is buffered whole (1 GiB cap) and answered with what
    the command prints.  ``-timeout S`` arms an idle timeout on every
    accepted socket: a peer that stops sending before its half-close, or
    stops draining its results, for S seconds has its session dropped and
    logged like any failed one; a read that times out on a runner's staging
    thread reaches the session as its exception.  ``ready(port)`` is called
    with the bound port once listening (tests bind port 0).  A failed
    session is logged (``serve: conn N failed: ...``) and the loop goes on;
    ``-once yes`` exits after one connection (``max_connections``
    generalizes it for embedders and tests; the CLI runs until killed).
    ``-mesh`` is refused before the socket binds (ROADMAP A13)."""
    import socket

    _refuse_mesh("serve", cmd)
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        # a model's tables are keyed by their tensors' device, which has an index
        device = torch.device("cuda", torch.cuda.current_device())
    details = guess_details("-", cmd.sample_rate, cmd.format)
    demod = cmd.mode in _RECEIVERS
    model = _serve_model(cmd, details, device)

    srv = socket.create_server((cmd.host, cmd.port))
    port = srv.getsockname()[1]
    answer = ("audio" if cmd.mode in ("fm", "am", "ssb") else "bits" if demod else "survey" if cmd.mode == "scan"
              else "matches" if cmd.mode == "find" else "search" if cmd.search else "norms")
    _log(
        f"serve: listening on {cmd.host}:{port} ({details.format.name.lower()}, sr {details.sample_rate}, "
        f"{cmd.mode} {answer}"
        + (f", parallel {cmd.parallel}" if cmd.parallel > 1 else "")
        + (f", timeout {cmd.timeout:g}s" if cmd.timeout > 0 else "")
        + ")"
    )
    if ready is not None:
        ready(port)
    if cmd.once:
        max_connections = 1

    def session(conn) -> RunStats:
        if demod:
            return _demod_connection(conn, model, cmd, details.format, details.sample_rate, device)
        if cmd.mode == "find":
            return _find_connection(conn, model, cmd, details.format, details.sample_rate, device)
        return _serve_connection(conn, model, cmd, details.sample_rate, device)

    def handle(n_conn: int, conn, peer) -> None:
        stream = torch.cuda.Stream(device) if device.type == "cuda" else None
        try:
            if cmd.timeout > 0:
                # any single blocked recv or send past this raises
                # TimeoutError; the clock is per socket operation, so a slow
                # but flowing client is never dropped
                conn.settimeout(cmd.timeout)
            with contextlib.nullcontext() if stream is None else torch.cuda.stream(stream):
                stats = session(conn)
            _log(f"serve: conn {n_conn} {peer[0]}:{peer[1]} " + _stats_line("done", stats))
        except Exception as e:  # a daemon survives any one session: client gone, bad bytes, a timeout
            _log(f"serve: conn {n_conn} failed: {type(e).__name__}: {e}")
        finally:
            if stream is not None:
                # a failed session's work too ends before the next session
                stream.synchronize()
            conn.close()

    n_conn = 0
    try:
        if cmd.parallel > 1:
            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(max_workers=cmd.parallel) as pool:
                while max_connections is None or n_conn < max_connections:
                    conn, peer = srv.accept()
                    n_conn += 1
                    pool.submit(handle, n_conn, conn, peer)
                # leaving the with-block waits for every session
        else:
            while max_connections is None or n_conn < max_connections:
                conn, peer = srv.accept()
                n_conn += 1
                handle(n_conn, conn, peer)
    finally:
        srv.close()
    return 0
