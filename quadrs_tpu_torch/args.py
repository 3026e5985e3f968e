"""The CLI grammar of the ported commands, mirroring the JAX package's
parser (itself the reference's, ``src/args.rs``): a sequence of
subcommands, each followed by ``-flag value`` pairs and then positional
arguments.

    from [-sr R] [-format F] FILE  shift [-]FREQ  lowpass [-power P]
    [-decimate D] FREQ  sparkfft [-width W] [-stride S] [-range LO:HI]
    bucket [-width W] [-stride S] -by freq COUNT  write [-overwrite B]
    PREFIX  gen [-cos F]* [-len SECS] RATE  resample UP/DOWN  dcblock
    agc  iqbal  find -pattern FILE ...  stream ...  waterfall ...
    scan ...  info FILE...  replay FILE  ook ...  fsk ...  psk ...  fm ...
    am ...  ssb ...  channelize ...  ui ...  eui ...  serve ...

``-mesh`` parses as in the JAX package; ``stream``, ``waterfall``,
``scan``, ``find`` and ``channelize`` run it, the receivers and ``serve``
raise naming ROADMAP A13.

Parsing rules preserved from ``read_just_args`` (``src/args.rs:404-445``):
flags are collected until the first non-flag token; a ``-``-prefixed
token whose *third* character is a digit is treated as a negative-number
positional rather than a flag (so ``-500`` is a shift frequency but
``-5k`` is read as a flag named ``5k``: the reference's quirk, kept);
duplicate flags are rejected except for the repeatable ``gen -cos``,
``find -pattern`` and ``serve -pattern``; numbers take SI suffixes.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Iterator, Sequence

from quadrs_tpu_torch import pipeline as ops
from quadrs_tpu_torch.utils.si import (
    parse_bool,
    parse_plain_float,
    parse_plain_uint,
    parse_si_float,
    parse_si_int,
    parse_si_uint,
)
from quadrs_tpu_torch.utils.sniff import guess_details


class Command:
    pass


@dataclass
class Octagon(Command):
    """A pipeline operation command (the reference's naming, src/args.rs:14)."""

    op: ops.Operation


@dataclass
class Ui(Command):
    """``ui``: the legacy GUI's waterfall as ``ui.png`` (``-frames N``: a
    sweep of fft widths), or live in the terminal (``-live yes``)."""

    fft_width: int = 8
    stretch: int = 4
    stride: int = 4
    frames: int = 1
    live: bool = False
    rows: int | None = None
    cols: int | None = None
    stdin: bool = False
    sample_rate: str | None = None
    format: str | None = None


@dataclass
class Eui(Command):
    """``eui``: the egui GUI's waterfall of a percentage slice of a file as
    ``eui.png`` (``-frames N``: a scrolling slice), or live in the terminal
    (``-live yes``, from a file or ``-stdin yes``)."""

    filename: Path | None
    start_pct: float = 46.0
    end_pct: float = 46.3
    fft_width: int = 512
    frames: int = 1
    live: bool = False
    stride: int | None = None
    rows: int | None = None
    cols: int | None = None
    stdin: bool = False
    sample_rate: str | None = None
    format: str | None = None


@dataclass
class StreamCmd(Command):
    """``stream``: drive the shift -> lowpass -> STFT chain over a capture
    file at full rate (the StreamRunner serving path)."""

    filename: str | None
    shift: int = 0
    lowpass: int = 200_000
    size: int = 400  # taps (2 * -power)
    decimate: int = 32
    fft_width: int = 64
    chunk: int = 4_000_000  # matches the CLI default "4M" (decimal SI)
    chunks: int | None = None
    search: bool = False
    scan: bool = False  # band survey of the decimated channel
    threshold: float = 0.0  # scan occupancy level
    top: int = 20  # scan: strongest bins to print
    db: bool = False  # scan: dB power columns
    trigger: float | None = None  # burst recorder: channel peak level
    pre: int = 1  # trigger: context windows before each burst
    post: int = 1  # trigger: context windows after each burst
    out: str | None = None
    sample_rate: str | None = None
    format: str | None = None
    mesh: tuple[int, int] | None = None  # (time, stream)
    stdin: bool = False  # live pipe input (rtl_sdr - | quadjax stream ...)


@dataclass
class WaterfallCmd(Command):
    """``waterfall``: stream a bank of capture files through the fused
    waterfall kernel (``WaterfallRunner``), optionally reducing each
    window to its peak in kernel (``-search``).  Terminal command: every
    remaining token is a capture filename."""

    filenames: list[str]
    fft_width: int = 1024
    stride: int | None = None  # defaults to width
    windowing: str = "rectangular"
    chunk_windows: int = 2_000  # matches the CLI default "2k" (decimal SI)
    chunks: int | None = None
    search: bool = False
    out: str | None = None
    sample_rate: str | None = None
    format: str | None = None
    mesh: tuple[int, int] | None = None
    stdin: bool = False  # single live pipe stream instead of files


@dataclass
class ScanCmd(Command):
    """``scan``: rtl_power-style band survey — per-bin average/max power
    and occupancy (fraction of windows above ``-threshold``) over every
    window of the capture(s), reduced on device chunk by chunk.
    Terminal command: every remaining token is a capture filename."""

    filenames: list[str]
    fft_width: int = 1024
    stride: int | None = None  # defaults to width
    windowing: str = "rectangular"
    chunk_windows: int = 2_000
    chunks: int | None = None
    threshold: float = 0.0
    top: int = 20  # report the N strongest bins per stream
    db: bool = False  # print power columns in dB (20*log10 of the magnitude)
    plot: bool = False  # render {out|scan}.sK.png survey plots
    out: str | None = None
    overwrite: bool = False
    sample_rate: str | None = None
    format: str | None = None
    mesh: tuple[int, int] | None = None
    stdin: bool = False  # single live pipe stream instead of files


@dataclass
class InfoCmd(Command):
    """``info``: per-capture statistics (the ``soxi`` of IQ files):
    format, rate and length plus device-reduced DC offset, RMS, peak,
    circularity (the IQ-image indicator) and raw-code clipping fraction.
    Terminal command: every remaining token is a capture filename."""

    filenames: list[str]
    chunk: int = 4_000_000
    limit: int | None = None  # analyze only the first N samples
    sample_rate: str | None = None
    format: str | None = None


@dataclass
class ReplayCmd(Command):
    """``replay``: stream a capture's raw bytes to stdout paced at its
    sample rate, turning any file into a live pipe for the ``-stdin``
    consumers (``... replay cap.sr2M.cu8 | ... stream -stdin yes -sr 2M
    -format cu8``), in place of the radio.  ``-speed X`` scales real time
    (0 = unthrottled), ``-loop N`` repeats the capture."""

    filename: str
    speed: float = 1.0
    loop: int = 1
    chunk: int = 65_536  # samples per write and pace step
    sample_rate: str | None = None
    format: str | None = None


@dataclass
class OokCmd(Command):
    """``ook``: demodulate an on-off-keyed capture to bits
    (:class:`~quadrs_tpu_torch.models.demod.OokDemod`; the README's
    shell-scripted OOK decode loop as one command)."""

    filename: str | None
    width: int = 4
    stride: int = 2
    threshold: float = 0.001
    bit: float = 8.0  # windows per bit
    raw: bool = False  # print raw pulse bits instead of Manchester
    sample_rate: str | None = None
    format: str | None = None
    stdin: bool = False  # buffer the capture from a pipe
    mesh: tuple[int, int] | None = None  # parsed; refused (ROADMAP A13)


@dataclass
class FskCmd(Command):
    """``fsk``: demodulate a two-tone FSK capture to symbols or bits
    (:class:`~quadrs_tpu_torch.models.demod.FskDemod`)."""

    filename: str | None
    shift: int = 0
    lowpass: int = 200_000
    size: int = 400
    decimate: int = 32
    fft_width: int = 64
    stride: int | None = None
    # windows per symbol for clock recovery; None prints the raw
    # discriminator symbols
    bit: float | None = None
    sample_rate: str | None = None
    format: str | None = None
    stdin: bool = False  # buffer the capture from a pipe
    mesh: tuple[int, int] | None = None  # parsed; refused (ROADMAP A13)


@dataclass
class PskCmd(Command):
    """``psk``: demodulate a BPSK/QPSK capture to bits
    (:class:`~quadrs_tpu_torch.models.demod.PskDemod`).  Block-coherent:
    carrier and symbol timing are recovered a burst (order-th-power FFT
    estimate + Oerder-Meyr), no PLL.  ``-differential yes`` (the default)
    decodes phase transitions, so the transmitter must encode
    differentially; coherent slicing otherwise (the bits then carry an
    unresolved ``2*pi/order`` rotation)."""

    filename: str | None
    shift: int = 0
    lowpass: int = 200_000
    size: int = 400
    decimate: int = 32
    symbol_rate: float = 0.0  # required: symbols per second
    order: int = 2  # 2 = BPSK, 4 = QPSK (Gray 00 01 11 10)
    differential: bool = True
    # re-estimate the carrier every N baseband samples (0 = one estimate
    # for the whole burst; see PskDemod.block)
    block: int = 0
    plot: str | None = None  # render the constellation PNG here
    overwrite: bool = False
    sample_rate: str | None = None
    format: str | None = None
    stdin: bool = False  # buffer the capture from a pipe
    mesh: tuple[int, int] | None = None  # parsed; refused (ROADMAP A13)


@dataclass
class ChannelizeCmd(Command):
    """``channelize``: split a capture into K equally spaced channels in one
    pass (:class:`~quadrs_tpu_torch.models.channelizer.Channelize`, the
    polyphase filter bank; channel ``k`` matches ``shift -{k*sr/K}`` +
    ``lowpass -decimate K``).  ``-out`` writes each selected channel as
    ``{prefix}.ch{k}.sr{rate}.cf32``; without it the command prints a
    channel RMS meter."""

    filename: str | None
    channels: int = 8
    size: int = 40  # prototype taps (2 * -power, the reference lowpass's default)
    frequency: int | None = None  # cutoff; defaults to sr/(2K)
    chunk: int = 1 << 18  # output samples per executor pull
    select: tuple[int, ...] | None = None  # channels to write and print (all)
    out: str | None = None
    overwrite: bool = False
    sample_rate: str | None = None
    format: str | None = None
    stdin: bool = False  # buffer the capture from a pipe
    mesh: tuple[int, int] | None = None  # -mesh T: time-shard the capture over the device mesh


@dataclass
class FmCmd(Command):
    """``fm``: demodulate an analog-FM capture to audio
    (:class:`~quadrs_tpu_torch.models.demod.FmDemod`).  With ``-out`` the
    normalized audio is written as ``{prefix}.sr{rate}.f32`` (mono LE
    f32); without it the command prints a deviation-meter summary."""

    filename: str | None
    shift: int = 0
    lowpass: int = 100_000
    size: int = 400
    decimate: int = 8
    deviation: float = 75_000.0
    audio_lowpass: int | None = None  # second-stage cutoff (Hz)
    audio_decimate: int = 1
    audio_size: int = 64
    audio_rate: int | None = None  # rational resample to this exact Hz
    out: str | None = None
    overwrite: bool = False
    wav: bool = False  # -out writes {prefix}.wav instead of raw f32
    sample_rate: str | None = None
    format: str | None = None
    stdin: bool = False  # buffer the capture from a pipe
    mesh: tuple[int, int] | None = None  # parsed; refused (ROADMAP A13)


@dataclass
class AmCmd(Command):
    """``am``: demodulate an amplitude-modulated capture to audio
    (:class:`~quadrs_tpu_torch.models.demod.AmDemod`) in modulation-depth
    units (``envelope / carrier - 1``); ``-out`` as ``fm``'s."""

    filename: str | None
    shift: int = 0
    lowpass: int = 10_000
    size: int = 400
    decimate: int = 8
    audio_lowpass: int | None = None
    audio_decimate: int = 1
    audio_size: int = 64
    audio_rate: int | None = None  # rational resample to this exact Hz
    out: str | None = None
    overwrite: bool = False
    wav: bool = False  # -out writes {prefix}.wav instead of raw f32
    sample_rate: str | None = None
    format: str | None = None
    stdin: bool = False  # buffer the capture from a pipe
    mesh: tuple[int, int] | None = None  # parsed; refused (ROADMAP A13)


@dataclass
class SsbCmd(Command):
    """``ssb``: single-sideband receiver (filter method, usb/lsb) to audio
    (:class:`~quadrs_tpu_torch.models.demod.SsbDemod`).  ``-shift``
    follows the house convention: bring the suppressed carrier to DC
    (``-shift -CARRIER_OFFSET``)."""

    filename: str | None
    shift: int = 0
    sideband: str = "usb"
    bandwidth: int = 3_000
    size: int = 400
    decimate: int = 8
    audio_lowpass: int | None = None
    audio_decimate: int = 1
    audio_size: int = 64
    audio_rate: int | None = None
    out: str | None = None
    overwrite: bool = False
    wav: bool = False
    sample_rate: str | None = None
    format: str | None = None
    stdin: bool = False
    mesh: tuple[int, int] | None = None  # parsed; refused (ROADMAP A13)


@dataclass
class ServeCmd(Command):
    """``serve``: a TCP daemon over one model.  The model and its tables
    are made once at startup; every accepted connection then streams raw
    IQ bytes in and gets results back over the same socket: peak CSV lines
    (``-search yes``), raw f32 norms rows, a survey CSV (``-mode scan``),
    match lines (``-mode find``), or, in the receiver modes, the bits text
    or the audio.  ``-sr``/``-format`` are required (a socket carries no
    filename to sniff)."""

    port: int = 7373
    host: str = "127.0.0.1"
    once: bool = False  # handle one connection then exit (tests, scripts)
    search: bool = False
    # "stream" = shift -> lowpass -> STFT chain; "waterfall" = the raw
    # spectrogram (no mixing or decimation), -width/-stride windows; "scan"
    # = the per-bin survey; "find" = the matched filter; "ook"/"fsk"/"psk"/
    # "fm"/"am"/"ssb" = the receivers: the connection's whole burst is
    # buffered (like `ook -stdin`), demodulated, and the answer sent back
    mode: str = "stream"
    shift: int = 0
    lowpass: int = 200_000
    size: int = 400  # taps (2 * -power)
    decimate: int = 32
    fft_width: int = 64
    stride: int | None = None  # waterfall mode; defaults to width
    # stream: samples per chunk (default 4M); waterfall: windows per chunk
    # (default 2k); find: None = find_pattern's auto block (max(4*l, 4096))
    chunk: int | None = 4_000_000
    sample_rate: str | None = None
    format: str | None = None
    mesh: tuple[int, int] | None = None  # parsed; refused (ROADMAP A13)
    # handle up to N connections at once, each on its own CUDA stream
    parallel: int = 1
    # per-socket-operation idle timeout in seconds (0 = none): a client
    # that neither sends nor drains for this long gets its session dropped
    # (logged, connection closed), so a stalled peer cannot hold a
    # -parallel slot, or the sequential accept loop, forever.  A trickling
    # client is never dropped: the clock restarts on every read and write.
    timeout: float = 0.0
    # receiver knobs (OokCmd/FskCmd counterparts)
    threshold: float = 0.001  # ook pulse threshold
    bit: float | None = None  # ook: windows/bit (default 8); fsk: windows/symbol
    raw: bool = False  # ook: raw pulse bits instead of Manchester
    # fm/am/ssb knobs (FmCmd counterparts)
    deviation: float = 75_000.0
    audio_lowpass: int | None = None
    audio_decimate: int = 1
    audio_size: int = 64
    audio_rate: int | None = None  # fm/am/ssb: rational resample to this Hz
    sideband: str = "usb"  # ssb: usb|lsb
    bandwidth: int = 3_000  # ssb: sideband width (filter at half)
    # psk knobs (PskCmd counterparts)
    symbol_rate: float = 0.0  # psk: symbols per second (required)
    order: int = 2  # psk: 2 = BPSK, 4 = QPSK
    differential: bool = True  # psk: decode phase transitions
    block: int = 0  # psk: carrier re-estimate every N baseband samples
    # find knobs (FindOp counterparts; -pattern repeatable)
    patterns: tuple[str, ...] = ()
    top: int = 0
    distance: int | None = None
    freq_tol: float = 0.0
    freq_step: float | None = None


def _parse_mesh(spec: str) -> tuple[int, int]:
    """``T`` or ``TxS`` -> (n_time, n_stream) mesh shape."""
    t, _, s = spec.partition("x")
    n_time = int(parse_si_uint(t))
    n_stream = int(parse_si_uint(s)) if s else 1
    if n_time < 1 or n_stream < 1:
        raise ValueError(f"mesh shape must be positive: {spec!r}")
    return n_time, n_stream


class _Args:
    """Peekable iterator over argv tokens."""

    def __init__(self, tokens: Sequence[str]):
        self._it: Iterator[str] = iter(tokens)
        self._peeked: str | None = None
        self._done = False

    def peek(self) -> str | None:
        if self._peeked is None and not self._done:
            try:
                self._peeked = next(self._it)
            except StopIteration:
                self._done = True
        return self._peeked

    def next(self) -> str | None:
        tok = self.peek()
        self._peeked = None
        return tok


def _read_just_args(args: _Args) -> dict[str, list[str]]:
    """Collect ``-flag value`` pairs (``src/args.rs:404-445``)."""
    ret: dict[str, list[str]] = {}
    while True:
        opt = args.peek()
        if opt is None or opt == "" or not opt.startswith("-"):
            break
        # a minus followed by something whose third char is a digit is a
        # negative number positional, not a flag
        if len(opt) >= 3 and opt[2].isdigit():
            break
        args.next()
        arg = args.next()
        if arg is None:
            raise ValueError(f"{opt} requires an argument")
        if arg == "":
            raise ValueError(f"{opt} requires a non-empty argument")
        ret.setdefault(opt[1:], []).append(arg)
    return ret


def _no_duplicates(map_: dict[str, list[str]]) -> dict[str, str]:
    ret = {}
    for k, v in map_.items():
        if len(v) != 1:
            raise ValueError(f"'-{k}' specified more than once: {v}")
        ret[k] = v[0]
    return ret


def _ensure_empty(map_: dict, cmd: str) -> None:
    if map_:
        raise ValueError(f"invalid flags for {cmd}: {sorted(map_)}")


def parse(tokens: Sequence[str]) -> list[Command]:
    """Parse argv into commands (``src/args.rs:19-45``)."""
    args = _Args(tokens)
    matched: list[Command] = []
    while True:
        cmd = args.next()
        if cmd is None:
            break
        raw_map = _read_just_args(args)
        parser = _PARSERS.get(cmd)
        if parser is None:
            raise ValueError(f"unrecognised command: {cmd!r}")
        try:
            matched.append(parser(args, raw_map))
        except ValueError as e:
            raise ValueError(f"processing command {cmd!r}: {e}") from e
    return matched


def _take_capture_arg(
    args: _Args, map_: dict, cmd: str, sr, fmt
) -> tuple[str | None, bool]:
    """Resolve a serve command's capture argument: the filename
    positional, or ``-stdin yes`` for live pipe input — which requires
    explicit ``-sr``/``-format`` (a pipe has no name to sniff)."""
    stdin = parse_bool(map_.pop("stdin", "no"))
    if stdin:
        if sr is None or fmt is None:
            raise ValueError(f"'{cmd} -stdin yes' requires -sr and -format")
        return None, True
    filename = args.next()
    if filename is None:
        raise ValueError(f"'{cmd}' requires a capture filename argument")
    return filename, False


def _parse_stream(args: _Args, raw_map) -> Command:
    map_ = _no_duplicates(raw_map)
    shift = parse_si_int(map_.pop("shift", "0"))
    lowpass = parse_si_uint(map_.pop("lowpass", "200k"))
    power = map_.pop("power", None)
    size = 2 * parse_si_uint(power) if power is not None else 400
    decimate = parse_si_uint(map_.pop("decimate", "32"))
    fft_width = int(parse_si_uint(map_.pop("width", "64")))
    chunk = int(parse_si_uint(map_.pop("chunk", "4M")))
    chunks = map_.pop("chunks", None)
    chunks = None if chunks is None else int(parse_si_uint(chunks))
    search = parse_bool(map_.pop("search", "no"))
    scan = parse_bool(map_.pop("scan", "no"))
    if search and scan:
        raise ValueError("'stream' takes -search or -scan, not both")
    scan_flags = {"threshold", "top", "db"} & set(map_)
    if scan_flags and not scan:
        raise ValueError(
            f"-{sorted(scan_flags)[0]} requires 'stream -scan yes'"
        )
    threshold = parse_si_float(map_.pop("threshold", "0"))
    top = int(parse_si_uint(map_.pop("top", "20")))
    db = parse_bool(map_.pop("db", "no"))
    trigger = map_.pop("trigger", None)
    trig_flags = {"pre", "post"} & set(map_)
    if trig_flags and trigger is None:
        raise ValueError(
            f"-{sorted(trig_flags)[0]} requires 'stream -trigger LEVEL'"
        )
    trigger = None if trigger is None else parse_si_float(trigger)
    if trigger is not None and (search or scan):
        raise ValueError("'stream -trigger' excludes -search/-scan")
    pre = int(parse_si_uint(map_.pop("pre", "1")))
    post = int(parse_si_uint(map_.pop("post", "1")))
    out = map_.pop("out", None)
    sr = map_.pop("sr", None)
    fmt = map_.pop("format", None)
    mesh = map_.pop("mesh", None)
    filename, stdin = _take_capture_arg(args, map_, "stream", sr, fmt)
    _ensure_empty(map_, "stream")
    if trigger is not None and out is None:
        raise ValueError("'stream -trigger' requires -out (burst files)")
    return StreamCmd(
        filename=filename, shift=shift, lowpass=lowpass, size=size,
        decimate=decimate, fft_width=fft_width, chunk=chunk, chunks=chunks,
        search=search, scan=scan, threshold=threshold, top=top, db=db,
        trigger=trigger, pre=pre, post=post,
        out=out, sample_rate=sr, format=fmt,
        mesh=None if mesh is None else _parse_mesh(mesh), stdin=stdin,
    )


def _bank_flags(map_: dict) -> tuple[int, int | None, str, int, int | None]:
    """(width, stride, window, chunk windows, chunks) of a bank command."""
    fft_width = int(parse_si_uint(map_.pop("width", "1024")))
    stride = map_.pop("stride", None)
    stride = None if stride is None else int(parse_si_uint(stride))
    windowing = map_.pop("window", "rectangular")
    if windowing not in ("rectangular", "blackman-harris", "blackmanharris"):
        raise ValueError(f"unknown -window: {windowing!r}")
    chunk_windows = int(parse_si_uint(map_.pop("chunk", "2k")))
    chunks = map_.pop("chunks", None)
    chunks = None if chunks is None else int(parse_si_uint(chunks))
    return fft_width, stride, windowing, chunk_windows, chunks


def _bank_files(args: _Args, cmd: str, stdin: bool, sr, fmt) -> list[str]:
    """A terminal bank command's capture files: every remaining token."""
    filenames = []
    while True:
        tok = args.next()
        if tok is None:
            break
        filenames.append(tok)
    if stdin:
        if sr is None or fmt is None:
            raise ValueError(f"'{cmd} -stdin yes' requires -sr and -format")
        if filenames:
            raise ValueError(f"'{cmd} -stdin yes' takes no filenames")
    elif not filenames:
        raise ValueError(f"'{cmd}' requires at least one capture filename")
    return filenames


def _parse_waterfall(args: _Args, raw_map) -> Command:
    map_ = _no_duplicates(raw_map)
    fft_width, stride, windowing, chunk_windows, chunks = _bank_flags(map_)
    search = parse_bool(map_.pop("search", "no"))
    out = map_.pop("out", None)
    sr = map_.pop("sr", None)
    fmt = map_.pop("format", None)
    mesh = map_.pop("mesh", None)
    stdin = parse_bool(map_.pop("stdin", "no"))
    _ensure_empty(map_, "waterfall")
    filenames = _bank_files(args, "waterfall", stdin, sr, fmt)
    return WaterfallCmd(
        filenames=filenames, fft_width=fft_width, stride=stride,
        windowing=windowing, chunk_windows=chunk_windows, chunks=chunks,
        search=search, out=out, sample_rate=sr, format=fmt,
        mesh=None if mesh is None else _parse_mesh(mesh), stdin=stdin,
    )


def _parse_scan(args: _Args, raw_map) -> Command:
    map_ = _no_duplicates(raw_map)
    fft_width, stride, windowing, chunk_windows, chunks = _bank_flags(map_)
    threshold = parse_si_float(map_.pop("threshold", "0"))
    top = int(parse_si_uint(map_.pop("top", "20")))
    db = parse_bool(map_.pop("db", "no"))
    plot = parse_bool(map_.pop("plot", "no"))
    out = map_.pop("out", None)
    overwrite = parse_bool(map_.pop("overwrite", "no"))
    sr = map_.pop("sr", None)
    fmt = map_.pop("format", None)
    mesh = map_.pop("mesh", None)
    stdin = parse_bool(map_.pop("stdin", "no"))
    _ensure_empty(map_, "scan")
    filenames = _bank_files(args, "scan", stdin, sr, fmt)
    return ScanCmd(
        filenames=filenames, fft_width=fft_width, stride=stride,
        windowing=windowing, chunk_windows=chunk_windows, chunks=chunks,
        threshold=threshold, top=top, db=db, plot=plot, out=out,
        overwrite=overwrite, sample_rate=sr, format=fmt,
        mesh=None if mesh is None else _parse_mesh(mesh), stdin=stdin,
    )


def _parse_info(args: _Args, raw_map) -> Command:
    map_ = _no_duplicates(raw_map)
    chunk = int(parse_si_uint(map_.pop("chunk", "4M")))
    if chunk < 1:
        raise ValueError("-chunk must be at least 1")
    limit = map_.pop("limit", None)
    limit = None if limit is None else int(parse_si_uint(limit))
    if limit is not None and limit < 1:
        raise ValueError("-limit must be at least 1")
    sr = map_.pop("sr", None)
    fmt = map_.pop("format", None)
    _ensure_empty(map_, "info")
    filenames = []
    while True:  # terminal command: everything left is a capture file
        tok = args.next()
        if tok is None:
            break
        filenames.append(tok)
    if not filenames:
        raise ValueError("'info' requires at least one capture filename")
    return InfoCmd(
        filenames=filenames, chunk=chunk, limit=limit, sample_rate=sr,
        format=fmt,
    )


def _parse_replay(args: _Args, raw_map) -> Command:
    map_ = _no_duplicates(raw_map)
    speed = parse_si_float(map_.pop("speed", "1"))
    if speed < 0:
        raise ValueError("-speed must be >= 0 (0 = unthrottled)")
    loop = int(parse_si_uint(map_.pop("loop", "1")))
    if loop < 1:
        raise ValueError("-loop must be at least 1")
    chunk = int(parse_si_uint(map_.pop("chunk", "64k")))
    if chunk < 1:
        raise ValueError("-chunk must be at least 1")
    sr = map_.pop("sr", None)
    fmt = map_.pop("format", None)
    _ensure_empty(map_, "replay")
    filename = args.next()
    if filename is None:
        raise ValueError("'replay' requires a capture filename argument")
    return ReplayCmd(
        filename=filename, speed=speed, loop=loop, chunk=chunk,
        sample_rate=sr, format=fmt,
    )


def _demod_mesh(map_: dict, cmd: str, stdin: bool) -> tuple[int, int] | None:
    """A receiver command's ``-mesh T`` (one capture over ``time``)."""
    mesh = map_.pop("mesh", None)
    mesh = None if mesh is None else _parse_mesh(mesh)
    if mesh is not None and mesh[1] != 1:
        raise ValueError(f"{cmd} -mesh shards one capture: use T or Tx1")
    if mesh is not None and stdin:
        raise ValueError(f"{cmd} -mesh needs a capture file, not -stdin")
    return mesh


def _parse_ook(args: _Args, raw_map) -> Command:
    map_ = _no_duplicates(raw_map)
    width = int(parse_si_uint(map_.pop("width", "4")))
    stride = int(parse_si_uint(map_.pop("stride", "2")))
    threshold = parse_si_float(map_.pop("threshold", "0.001"))
    bit = parse_si_float(map_.pop("bit", "8"))
    raw = parse_bool(map_.pop("raw", "no"))
    sr = map_.pop("sr", None)
    fmt = map_.pop("format", None)
    filename, stdin = _take_capture_arg(args, map_, "ook", sr, fmt)
    mesh = _demod_mesh(map_, "ook", stdin)
    _ensure_empty(map_, "ook")
    return OokCmd(
        filename=filename, width=width, stride=stride, threshold=threshold,
        bit=bit, raw=raw, sample_rate=sr, format=fmt, stdin=stdin,
        mesh=mesh,
    )


def _parse_fsk(args: _Args, raw_map) -> Command:
    map_ = _no_duplicates(raw_map)
    shift = parse_si_int(map_.pop("shift", "0"))
    lowpass = parse_si_uint(map_.pop("lowpass", "200k"))
    power = map_.pop("power", None)
    size = 2 * parse_si_uint(power) if power is not None else 400
    decimate = parse_si_uint(map_.pop("decimate", "32"))
    fft_width = int(parse_si_uint(map_.pop("width", "64")))
    stride = map_.pop("stride", None)
    stride = None if stride is None else int(parse_si_uint(stride))
    bit = map_.pop("bit", None)
    bit = None if bit is None else parse_si_float(bit)
    sr = map_.pop("sr", None)
    fmt = map_.pop("format", None)
    filename, stdin = _take_capture_arg(args, map_, "fsk", sr, fmt)
    mesh = _demod_mesh(map_, "fsk", stdin)
    _ensure_empty(map_, "fsk")
    return FskCmd(
        filename=filename, shift=shift, lowpass=lowpass, size=size,
        decimate=decimate, fft_width=fft_width, stride=stride, bit=bit,
        sample_rate=sr, format=fmt, stdin=stdin, mesh=mesh,
    )


def _parse_psk(args: _Args, raw_map) -> Command:
    map_ = _no_duplicates(raw_map)
    shift = parse_si_int(map_.pop("shift", "0"))
    lowpass = parse_si_uint(map_.pop("lowpass", "200k"))
    power = map_.pop("power", None)
    size = 2 * parse_si_uint(power) if power is not None else 400
    decimate = parse_si_uint(map_.pop("decimate", "32"))
    symbol_rate = map_.pop("symbol-rate", None)
    order = int(parse_si_uint(map_.pop("order", "2")))
    differential = parse_bool(map_.pop("differential", "yes"))
    block = int(parse_si_uint(map_.pop("block", "0")))
    plot = map_.pop("plot", None)
    overwrite = parse_bool(map_.pop("overwrite", "no"))
    sr = map_.pop("sr", None)
    fmt = map_.pop("format", None)
    filename, stdin = _take_capture_arg(args, map_, "psk", sr, fmt)
    mesh = _demod_mesh(map_, "psk", stdin)
    _ensure_empty(map_, "psk")
    if symbol_rate is None:
        raise ValueError("psk requires -symbol-rate (symbols per second)")
    symbol_rate = parse_si_float(symbol_rate)
    if symbol_rate <= 0:
        raise ValueError("-symbol-rate must be positive")
    if order not in (2, 4):
        raise ValueError("-order must be 2 (BPSK) or 4 (QPSK)")
    return PskCmd(
        filename=filename, shift=shift, lowpass=lowpass, size=size,
        decimate=decimate, symbol_rate=symbol_rate, order=order,
        differential=differential, block=block, plot=plot,
        overwrite=overwrite, sample_rate=sr, format=fmt, stdin=stdin,
        mesh=mesh,
    )


def _parse_channelize(args: _Args, raw_map) -> Command:
    map_ = _no_duplicates(raw_map)
    channels = int(parse_si_uint(map_.pop("channels", "8")))
    if channels < 2:
        raise ValueError("-channels must be at least 2")
    power = map_.pop("power", None)
    size = 2 * parse_si_uint(power) if power is not None else 40
    freq = map_.pop("freq", None)
    freq = None if freq is None else int(parse_si_uint(freq))
    chunk = int(parse_si_uint(map_.pop("chunk", "256k")))
    select_raw = map_.pop("select", None)
    select: tuple[int, ...] | None = None
    if select_raw is not None:
        try:
            select = tuple(int(parse_si_uint(tok)) for tok in select_raw.split(","))
        except ValueError:
            raise ValueError(f"bad -select list: {select_raw!r}")
        if not select:
            raise ValueError("empty -select list")
        bad = [ch for ch in select if ch >= channels]
        if bad:
            raise ValueError(f"-select channel {bad[0]} out of range (channels={channels})")
    out = map_.pop("out", None)
    overwrite = parse_bool(map_.pop("overwrite", "no"))
    sr = map_.pop("sr", None)
    fmt = map_.pop("format", None)
    mesh = map_.pop("mesh", None)
    mesh = None if mesh is None else _parse_mesh(mesh)
    if mesh is not None and mesh[1] != 1:
        raise ValueError("channelize -mesh shards one capture: use T or Tx1")
    filename, stdin = _take_capture_arg(args, map_, "channelize", sr, fmt)
    if mesh is not None and stdin:
        raise ValueError("channelize -mesh needs a capture file, not -stdin")
    _ensure_empty(map_, "channelize")
    return ChannelizeCmd(
        filename=filename, channels=channels, size=size, frequency=freq,
        chunk=chunk, select=select, out=out, overwrite=overwrite,
        sample_rate=sr, format=fmt, stdin=stdin, mesh=mesh,
    )


def _audio_flags(map_: dict, cmd: str) -> dict:
    """The audio tail's and the output's flags of ``fm``, ``am`` and ``ssb``."""
    audio_lowpass = map_.pop("audio-lowpass", None)
    audio_lowpass = None if audio_lowpass is None else parse_si_uint(audio_lowpass)
    audio_decimate = parse_si_uint(map_.pop("audio-decimate", "1"))
    audio_power = map_.pop("audio-power", None)
    audio_size = 2 * parse_si_uint(audio_power) if audio_power is not None else 64
    audio_rate = map_.pop("audio-rate", None)
    audio_rate = None if audio_rate is None else int(parse_si_uint(audio_rate))
    out = map_.pop("out", None)
    overwrite = parse_bool(map_.pop("overwrite", "no"))
    wav = parse_bool(map_.pop("wav", "no"))
    if wav and out is None:
        raise ValueError(f"{cmd} -wav requires -out")
    return dict(
        audio_lowpass=audio_lowpass, audio_decimate=audio_decimate,
        audio_size=audio_size, audio_rate=audio_rate, out=out,
        overwrite=overwrite, wav=wav,
    )


def _audio_capture(args: _Args, map_: dict, cmd: str) -> dict:
    """The capture argument, its ``-sr``/``-format`` and ``-mesh`` of an
    audio command."""
    sr = map_.pop("sr", None)
    fmt = map_.pop("format", None)
    filename, stdin = _take_capture_arg(args, map_, cmd, sr, fmt)
    mesh = _demod_mesh(map_, cmd, stdin)
    _ensure_empty(map_, cmd)
    return dict(filename=filename, sample_rate=sr, format=fmt, stdin=stdin, mesh=mesh)


def _parse_fm(args: _Args, raw_map) -> Command:
    map_ = _no_duplicates(raw_map)
    shift = parse_si_int(map_.pop("shift", "0"))
    lowpass = parse_si_uint(map_.pop("lowpass", "100k"))
    power = map_.pop("power", None)
    size = 2 * parse_si_uint(power) if power is not None else 400
    decimate = parse_si_uint(map_.pop("decimate", "8"))
    deviation = parse_si_float(map_.pop("deviation", "75k"))
    if deviation <= 0:
        raise ValueError("-deviation must be positive")
    audio = _audio_flags(map_, "fm")
    return FmCmd(
        shift=shift, lowpass=lowpass, size=size, decimate=decimate,
        deviation=deviation, **audio, **_audio_capture(args, map_, "fm"),
    )


def _parse_am(args: _Args, raw_map) -> Command:
    map_ = _no_duplicates(raw_map)
    shift = parse_si_int(map_.pop("shift", "0"))
    lowpass = parse_si_uint(map_.pop("lowpass", "10k"))
    power = map_.pop("power", None)
    size = 2 * parse_si_uint(power) if power is not None else 400
    decimate = parse_si_uint(map_.pop("decimate", "8"))
    audio = _audio_flags(map_, "am")
    return AmCmd(
        shift=shift, lowpass=lowpass, size=size, decimate=decimate,
        **audio, **_audio_capture(args, map_, "am"),
    )


def _parse_ssb(args: _Args, raw_map) -> Command:
    map_ = _no_duplicates(raw_map)
    shift = parse_si_int(map_.pop("shift", "0"))
    sideband = map_.pop("sideband", "usb")
    if sideband not in ("usb", "lsb"):
        raise ValueError(f"unknown -sideband: {sideband!r} (usb|lsb)")
    bandwidth = int(parse_si_uint(map_.pop("bandwidth", "3k")))
    power = map_.pop("power", None)
    size = 2 * parse_si_uint(power) if power is not None else 400
    decimate = parse_si_uint(map_.pop("decimate", "8"))
    audio = _audio_flags(map_, "ssb")
    return SsbCmd(
        shift=shift, sideband=sideband, bandwidth=bandwidth, size=size,
        decimate=decimate, **audio, **_audio_capture(args, map_, "ssb"),
    )


def _parse_from(args: _Args, raw_map) -> Command:
    map_ = _no_duplicates(raw_map)
    filename = args.next()
    if filename is None:
        raise ValueError("'from' requires a filename argument")
    sr = map_.pop("sr", None)
    fmt = map_.pop("format", None)
    _ensure_empty(map_, "from")
    details = guess_details(filename, sr, fmt)
    return Octagon(ops.From(details=details, filename=filename))


def _parse_shift(args: _Args, raw_map) -> Command:
    map_ = _no_duplicates(raw_map)
    _ensure_empty(map_, "shift")
    freq = args.next()
    if freq is None:
        raise ValueError("'shift' requires a frequency argument")
    return Octagon(ops.ShiftOp(frequency=parse_si_int(freq)))


def _parse_lowpass(args: _Args, raw_map) -> Command:
    map_ = _no_duplicates(raw_map)
    freq = args.next()
    if freq is None:
        raise ValueError("'lowpass' requires a frequency argument")
    frequency = parse_si_uint(freq)
    power = map_.pop("power", None)
    size = 2 * parse_si_uint(power) if power is not None else 40
    decimate = parse_si_uint(map_.pop("decimate", "8"))
    _ensure_empty(map_, "lowpass")
    return Octagon(ops.LowPassOp(size=size, decimate=decimate, frequency=frequency))


def _parse_find(args: _Args, raw_map) -> Command:
    # find keeps the repeatable -pattern (a template BANK, like gen -cos)
    map_all = dict(raw_map)
    patterns = map_all.pop("pattern", None)
    map_ = _no_duplicates(map_all)
    if patterns is None:
        raise ValueError("'find' requires -pattern FILE (the template capture)")
    threshold = parse_si_float(map_.pop("threshold", "0.5"))
    if not 0.0 < threshold <= 1.0:
        raise ValueError("-threshold must be in (0, 1]")
    top = int(parse_si_uint(map_.pop("top", "0")))
    distance = map_.pop("distance", None)
    distance = None if distance is None else int(parse_si_uint(distance))
    freq_tol = parse_si_float(map_.pop("freq-tol", "0"))
    if freq_tol < 0:
        raise ValueError("-freq-tol must be >= 0")
    freq_step = map_.pop("freq-step", None)
    freq_step = None if freq_step is None else parse_si_float(freq_step)
    if freq_step is not None and freq_step <= 0:
        raise ValueError("-freq-step must be positive")
    stdin = parse_bool(map_.pop("stdin", "no"))
    write = map_.pop("write", None)
    wr_flags = {"pre", "post"} & set(map_)
    if wr_flags and write is None:
        raise ValueError(
            f"-{sorted(wr_flags)[0]} requires 'find -write PREFIX'"
        )
    pre = int(parse_si_uint(map_.pop("pre", "0")))
    post = int(parse_si_uint(map_.pop("post", "0")))
    overwrite = parse_bool(map_.pop("overwrite", "no"))
    if write is not None and stdin:
        raise ValueError(
            "find -write needs a seekable capture file, not -stdin"
        )
    sr = map_.pop("sr", None)
    fmt = map_.pop("format", None)
    mesh = map_.pop("mesh", None)
    mesh = None if mesh is None else _parse_mesh(mesh)
    if mesh is not None and mesh[1] != 1:
        raise ValueError("find -mesh shards one capture: use T or Tx1")
    if mesh is not None and stdin:
        raise ValueError("find -mesh needs a capture file, not -stdin")
    _ensure_empty(map_, "find")
    if stdin:
        # -sr/-format describe the PIPE (it has no name to sniff);
        # the template files sniff from their own names
        if sr is None or fmt is None:
            raise ValueError("find -stdin requires -sr and -format")
        details = tuple(guess_details(p, None, None) for p in patterns)
    else:
        details = tuple(guess_details(p, sr, fmt) for p in patterns)
    return Octagon(
        ops.FindOp(
            details=details, filenames=tuple(patterns), threshold=threshold,
            top=top, distance=distance, freq_tol=freq_tol,
            freq_step=freq_step, stdin=stdin, sample_rate=sr, format=fmt,
            write=write, pre=pre, post=post, overwrite=overwrite,
            mesh=mesh,
        )
    )


def _parse_resample(args: _Args, raw_map) -> Command:
    map_ = _no_duplicates(raw_map)
    ratio = args.next()
    if ratio is None:
        raise ValueError("'resample' requires an UP/DOWN ratio argument")
    if "/" not in ratio:
        raise ValueError(f"resample ratio must be UP/DOWN (e.g. 3/2): '{ratio}'")
    up_s, down_s = ratio.split("/", 1)
    up, down = int(parse_si_uint(up_s)), int(parse_si_uint(down_s))
    if up == 0 or down == 0:
        raise ValueError(f"resample ratio terms must be positive: '{ratio}'")
    power = map_.pop("power", None)
    size = map_.pop("size", None)
    if power is not None and size is not None:
        raise ValueError("resample takes -power or -size, not both")
    _ensure_empty(map_, "resample")
    return Octagon(
        ops.ResampleOp(
            up=up,
            down=down,
            size=int(parse_si_uint(size)) if size is not None else None,
            power=int(parse_si_uint(power)) if power is not None else 8,
        )
    )


def _parse_dcblock(args: _Args, raw_map) -> Command:
    map_ = _no_duplicates(raw_map)
    window = int(parse_si_uint(map_.pop("window", "32k")))
    if window < 1:
        raise ValueError("-window must be at least 1")
    _ensure_empty(map_, "dcblock")
    return Octagon(ops.DcBlockOp(window=window))


def _parse_agc(args: _Args, raw_map) -> Command:
    map_ = _no_duplicates(raw_map)
    target = parse_si_float(map_.pop("target", "1"))
    if target <= 0:
        raise ValueError("-target must be positive")
    window = int(parse_si_uint(map_.pop("window", "4k")))
    if window < 1:
        raise ValueError("-window must be at least 1")
    max_gain = parse_si_float(map_.pop("max-gain", "1k"))
    if max_gain <= 0:
        raise ValueError("-max-gain must be positive")
    _ensure_empty(map_, "agc")
    return Octagon(ops.AgcOp(target=target, window=window, max_gain=max_gain))


def _parse_iqbal(args: _Args, raw_map) -> Command:
    map_ = _no_duplicates(raw_map)
    c_raw = map_.pop("c", None)
    c: complex | None = None
    if c_raw is not None:
        if ":" not in c_raw:
            raise ValueError(f"-c must be RE:IM (e.g. 0.01:-0.002): '{c_raw}'")
        re_s, im_s = c_raw.split(":", 1)
        c = complex(parse_plain_float(re_s), parse_plain_float(im_s))
    est = int(parse_si_uint(map_.pop("est", "256k")))
    if c_raw is not None and "est" in raw_map:
        raise ValueError("iqbal takes -c or -est, not both")
    if est < 2:
        raise ValueError("-est must be at least 2")
    _ensure_empty(map_, "iqbal")
    return Octagon(ops.IqbalOp(c=c, est=est))


def _parse_sparkfft(args: _Args, raw_map) -> Command:
    map_ = _no_duplicates(raw_map)
    width = int(parse_si_uint(map_.pop("width", "128")))
    stride = parse_si_uint(map_.pop("stride", str(width)))
    min_ = max_ = None
    rng = map_.pop("range", None)
    if rng is not None:
        if ":" not in rng:
            raise ValueError(f"range argument must contain a ':': '{rng}'")
        lo, hi = rng.split(":", 1)
        min_, max_ = parse_plain_float(lo), parse_plain_float(hi)
    _ensure_empty(map_, "sparkfft")
    return Octagon(ops.SparkFftOp(width=width, stride=stride, min=min_, max=max_))


def _parse_bucket(args: _Args, raw_map) -> Command:
    map_ = _no_duplicates(raw_map)
    levels = args.next()
    if levels is None:
        raise ValueError("bucket usage: bucket -by freq [number-of-buckets]")
    levels = parse_plain_uint(levels)  # no SI suffix (src/args.rs:225-228)
    width = int(parse_si_uint(map_.pop("width", "128")))
    stride = parse_si_uint(map_.pop("stride", str(width)))
    by = map_.pop("by", None)
    if by != "freq":
        raise ValueError(f"must bucket -by freq, not {by!r}")
    _ensure_empty(map_, "bucket")
    return Octagon(ops.BucketOp(fft_width=width, stride=stride, levels=levels))


def _parse_write(args: _Args, raw_map) -> Command:
    map_ = _no_duplicates(raw_map)
    overwrite = parse_bool(map_.pop("overwrite", "false"))
    fmt = map_.pop("format", None)
    if fmt is not None and fmt not in ("cf32", "cs8", "cu8", "cs16"):
        raise ValueError(f"unknown -format: {fmt!r} (cf32|cs8|cu8|cs16)")
    _ensure_empty(map_, "write")
    prefix = args.next()
    if prefix is None:
        raise ValueError("'write' requires a filename prefix argument")
    return Octagon(ops.WriteOp(overwrite=overwrite, prefix=prefix, format=fmt))


def _parse_gen(args: _Args, raw_map) -> Command:
    # gen keeps the repeatable -cos (src/args.rs:35,273-307)
    map_ = dict(raw_map)
    cos_vals = map_.pop("cos", None)
    if cos_vals is None:
        raise ValueError("gen requires at least one operation")
    cos = [parse_si_int(v) for v in cos_vals]
    len_vals = map_.pop("len", None)
    if len_vals is None:
        seconds = 1.0
    elif len(len_vals) == 1:
        seconds = parse_si_float(len_vals[0])
    else:
        raise ValueError("len requires exactly one value")

    def _one(name: str, default: str) -> str:
        vals = map_.pop(name, None)
        if vals is None:
            return default
        if len(vals) != 1:
            raise ValueError(f"{name} requires exactly one value")
        return vals[0]

    noise = parse_si_float(_one("noise", "0"))
    if noise < 0:
        raise ValueError("-noise must be >= 0")
    seed = int(parse_si_uint(_one("seed", "0")))
    _ensure_empty(map_, "gen")
    rate = args.next()
    if rate is None:
        raise ValueError("sample rate argument required")
    sample_rate = parse_si_uint(rate)
    return Octagon(
        ops.GenOp(
            seconds=seconds, sample_rate=sample_rate, cos=cos,
            noise=noise, seed=seed,
        )
    )


def _parse_ui(args: _Args, raw_map) -> Command:
    map_ = _no_duplicates(raw_map)
    fft_width = int(parse_si_uint(map_.pop("fft", "8")))
    stretch = int(parse_si_uint(map_.pop("stretch", "4")))
    stride = int(parse_si_uint(map_.pop("stride", "4")))
    frames = int(parse_si_uint(map_.pop("frames", "1")))
    live = parse_bool(map_.pop("live", "no"))
    rows = map_.pop("rows", None)
    rows = None if rows is None else int(parse_si_uint(rows))
    cols = map_.pop("cols", None)
    cols = None if cols is None else int(parse_si_uint(cols))
    stdin = parse_bool(map_.pop("stdin", "no"))
    sr = map_.pop("sr", None)
    fmt = map_.pop("format", None)
    if stdin:
        if not live:
            raise ValueError("'ui -stdin yes' requires -live yes (a pipe "
                             "cannot back the PNG renderer)")
        if sr is None or fmt is None:
            raise ValueError("'ui -stdin yes' requires -sr and -format")
    _ensure_empty(map_, "ui")
    return Ui(
        fft_width=fft_width, stretch=stretch, stride=stride, frames=frames,
        live=live, rows=rows, cols=cols, stdin=stdin, sample_rate=sr,
        format=fmt,
    )


def _parse_eui(args: _Args, raw_map) -> Command:
    map_ = _no_duplicates(raw_map)
    start = parse_si_float(map_.pop("start", "46.0"))
    end = parse_si_float(map_.pop("end", "46.3"))
    fft_width = int(parse_si_uint(map_.pop("fft", "512")))
    frames = int(parse_si_uint(map_.pop("frames", "1")))
    live = parse_bool(map_.pop("live", "no"))
    stride = map_.pop("stride", None)
    stride = None if stride is None else int(parse_si_uint(stride))
    rows = map_.pop("rows", None)
    rows = None if rows is None else int(parse_si_uint(rows))
    cols = map_.pop("cols", None)
    cols = None if cols is None else int(parse_si_uint(cols))
    stdin = parse_bool(map_.pop("stdin", "no"))
    sr = map_.pop("sr", None)
    fmt = map_.pop("format", None)
    if stdin:
        if not live:
            raise ValueError("'eui -stdin yes' requires -live yes (a pipe "
                             "cannot be percentage-sliced for a PNG render)")
        if sr is None or fmt is None:
            raise ValueError("'eui -stdin yes' requires -sr and -format")
    map_.clear()  # reference eui drops any other flags silently
    filename = args.next() if not stdin else None
    return Eui(
        filename=None if filename is None else Path(filename),
        start_pct=start,
        end_pct=end,
        fft_width=fft_width,
        frames=frames,
        live=live,
        stride=stride,
        rows=rows,
        cols=cols,
        stdin=stdin,
        sample_rate=sr,
        format=fmt,
    )


def _parse_serve(args: _Args, raw_map) -> Command:
    # serve keeps find's repeatable -pattern (a template bank)
    map_all = dict(raw_map)
    patterns = tuple(map_all.pop("pattern", ()))
    map_ = _no_duplicates(map_all)
    explicit = set(map_) | ({"pattern"} if patterns else set())
    port = int(parse_si_uint(map_.pop("port", "7373")))
    host = map_.pop("host", "127.0.0.1")
    once = parse_bool(map_.pop("once", "no"))
    search = parse_bool(map_.pop("search", "no"))
    shift = parse_si_int(map_.pop("shift", "0"))
    mode = map_.pop("mode", "stream")
    if mode not in ("stream", "waterfall", "scan", "ook", "fsk", "psk", "fm", "am", "ssb", "find"):
        raise ValueError(f"unknown -mode: {mode!r} (stream|waterfall|scan|ook|fsk|psk|fm|am|ssb|find)")
    # reject flags the chosen mode would silently ignore
    fm_flags = {"deviation", "audio-lowpass", "audio-decimate", "audio-power", "audio-rate"}
    ssb_flags = {"sideband", "bandwidth"}
    psk_flags = {"symbol-rate", "order", "differential", "block"}
    find_flags = {"pattern", "top", "distance", "freq-tol", "freq-step"}
    demod_flags = {"width", "stride", "threshold", "bit", "raw", "search", "chunk", "mesh"}
    inapplicable = {
        "stream": {"stride", "threshold", "bit", "raw"} | fm_flags | ssb_flags | psk_flags | find_flags,
        "waterfall": {"shift", "lowpass", "power", "decimate", "threshold", "bit", "raw"}
        | fm_flags | ssb_flags | psk_flags | find_flags,
        # scan is the waterfall bank reduced to per-bin stats: the channel
        # chain's and the receivers' knobs do not apply, nor does -search
        "scan": {"shift", "lowpass", "power", "decimate", "bit", "raw", "search"}
        | fm_flags | ssb_flags | psk_flags | find_flags,
        # the receivers buffer the whole burst: chunking, peak search and
        # mesh sharding do not apply (and -search would shadow the bits)
        "ook": {"shift", "lowpass", "power", "decimate", "search", "chunk", "mesh"}
        | fm_flags | ssb_flags | psk_flags | find_flags,
        "fsk": {"threshold", "raw", "search", "chunk", "mesh"} | fm_flags | ssb_flags | psk_flags | find_flags,
        "psk": demod_flags | fm_flags | ssb_flags | find_flags,
        "fm": demod_flags | ssb_flags | psk_flags | find_flags,
        "am": demod_flags | {"deviation"} | ssb_flags | psk_flags | find_flags,
        # ssb: -bandwidth replaces -lowpass (the filter is bandwidth/2)
        "ssb": demod_flags | {"deviation", "lowpass"} | psk_flags | find_flags,
        # find searches the raw connection stream: no channel chain, no
        # receiver knobs; -threshold and -chunk keep their find meanings
        "find": {"shift", "lowpass", "power", "decimate", "width", "stride", "bit", "raw", "search"}
        | fm_flags | ssb_flags | psk_flags,
    }
    bad = explicit & inapplicable[mode]
    if bad:
        raise ValueError(f"-{sorted(bad)[0]} does not apply to -mode {mode}")
    width_default = {"stream": "64", "waterfall": "1024", "scan": "1024", "ook": "4", "fsk": "64", "psk": "64",
                     "fm": "64", "am": "64", "ssb": "64", "find": "64"}
    fft_width = int(parse_si_uint(map_.pop("width", width_default[mode])))
    # channel-filter defaults match the standalone command of each mode
    lp_default = {"fm": "100k", "am": "10k"}
    lowpass = parse_si_uint(map_.pop("lowpass", lp_default.get(mode, "200k")))
    power = map_.pop("power", None)
    size = 2 * parse_si_uint(power) if power is not None else 400
    decimate = parse_si_uint(map_.pop("decimate", "8" if mode in ("fm", "am", "ssb") else "32"))
    deviation = parse_si_float(map_.pop("deviation", "75k"))
    if deviation <= 0:
        raise ValueError("-deviation must be positive")
    audio_lowpass = map_.pop("audio-lowpass", None)
    audio_lowpass = None if audio_lowpass is None else parse_si_uint(audio_lowpass)
    audio_decimate = parse_si_uint(map_.pop("audio-decimate", "1"))
    audio_power = map_.pop("audio-power", None)
    audio_size = 2 * parse_si_uint(audio_power) if audio_power is not None else 64
    audio_rate = map_.pop("audio-rate", None)
    audio_rate = None if audio_rate is None else int(parse_si_uint(audio_rate))
    sideband = map_.pop("sideband", "usb")
    if sideband not in ("usb", "lsb"):
        raise ValueError(f"unknown -sideband: {sideband!r} (usb|lsb)")
    bandwidth = int(parse_si_uint(map_.pop("bandwidth", "3k")))
    symbol_rate = map_.pop("symbol-rate", None)
    if mode == "psk" and symbol_rate is None:
        raise ValueError("-mode psk requires -symbol-rate (symbols per second)")
    symbol_rate = 0.0 if symbol_rate is None else parse_si_float(symbol_rate)
    if mode == "psk" and symbol_rate <= 0:
        raise ValueError("-symbol-rate must be positive")
    order = int(parse_si_uint(map_.pop("order", "2")))
    if order not in (2, 4):
        raise ValueError("-order must be 2 (BPSK) or 4 (QPSK)")
    differential = parse_bool(map_.pop("differential", "yes"))
    block = int(parse_si_uint(map_.pop("block", "0")))
    stride = map_.pop("stride", "2" if mode == "ook" else None)
    stride = None if stride is None else int(parse_si_uint(stride))
    if mode == "find" and not patterns:
        raise ValueError("-mode find requires -pattern FILE (repeatable)")
    top = int(parse_si_uint(map_.pop("top", "0")))
    distance = map_.pop("distance", None)
    distance = None if distance is None else int(parse_si_uint(distance))
    freq_tol = parse_si_float(map_.pop("freq-tol", "0"))
    if freq_tol < 0:
        raise ValueError("-freq-tol must be >= 0")
    freq_step = map_.pop("freq-step", None)
    freq_step = None if freq_step is None else parse_si_float(freq_step)
    if freq_step is not None and freq_step <= 0:
        raise ValueError("-freq-step must be positive")
    thr_default = {"scan": "0", "find": "0.5"}
    threshold = parse_si_float(map_.pop("threshold", thr_default.get(mode, "0.001")))
    bit = map_.pop("bit", "8" if mode == "ook" else None)
    bit = None if bit is None else parse_si_float(bit)
    raw_bits = parse_bool(map_.pop("raw", "no"))
    raw_chunk = map_.pop("chunk", None)
    if raw_chunk is None and mode == "find":
        chunk = None  # find_pattern's auto block: max(4*l, 4096)
    else:
        chunk = int(parse_si_uint(raw_chunk if raw_chunk is not None else "4M" if mode == "stream" else "2k"))
    sr = map_.pop("sr", None)
    fmt = map_.pop("format", None)
    mesh = map_.pop("mesh", None)
    parallel = int(parse_si_uint(map_.pop("parallel", "1")))
    if parallel < 1:
        raise ValueError("-parallel must be >= 1")
    timeout = parse_si_float(map_.pop("timeout", "0"))
    if timeout < 0:
        raise ValueError("-timeout must be >= 0 seconds (0 = none)")
    _ensure_empty(map_, "serve")
    if sr is None or fmt is None:
        raise ValueError("'serve' requires -sr and -format (a socket has no filename to sniff)")
    return ServeCmd(
        port=port, host=host, once=once, search=search, mode=mode, shift=shift, lowpass=lowpass, size=size,
        decimate=decimate, fft_width=fft_width, stride=stride, chunk=chunk, sample_rate=sr, format=fmt,
        mesh=None if mesh is None else _parse_mesh(mesh), parallel=parallel, timeout=timeout,
        threshold=threshold, bit=bit, raw=raw_bits, deviation=deviation, audio_lowpass=audio_lowpass,
        audio_decimate=audio_decimate, audio_size=audio_size, audio_rate=audio_rate, sideband=sideband,
        bandwidth=bandwidth, symbol_rate=symbol_rate, order=order, differential=differential, block=block,
        patterns=patterns, top=top, distance=distance, freq_tol=freq_tol, freq_step=freq_step,
    )


_PARSERS = {
    "from": _parse_from,
    "shift": _parse_shift,
    "lowpass": _parse_lowpass,
    "resample": _parse_resample,
    "dcblock": _parse_dcblock,
    "agc": _parse_agc,
    "iqbal": _parse_iqbal,
    "sparkfft": _parse_sparkfft,
    "bucket": _parse_bucket,
    "find": _parse_find,
    "write": _parse_write,
    "gen": _parse_gen,
    "ui": _parse_ui,
    "eui": _parse_eui,
    "stream": _parse_stream,
    "waterfall": _parse_waterfall,
    "scan": _parse_scan,
    "info": _parse_info,
    "replay": _parse_replay,
    "ook": _parse_ook,
    "fsk": _parse_fsk,
    "psk": _parse_psk,
    "fm": _parse_fm,
    "am": _parse_am,
    "ssb": _parse_ssb,
    "channelize": _parse_channelize,
    "serve": _parse_serve,
}
