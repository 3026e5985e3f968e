"""The CLI grammar of the ported commands, mirroring the JAX package's
parser (itself the reference's, ``src/args.rs``): a sequence of
subcommands, each followed by ``-flag value`` pairs and then positional
arguments.  Only ``stream`` is ported so far.

Parsing rules preserved from ``read_just_args`` (``src/args.rs:404-445``):
flags are collected until the first non-flag token; a ``-``-prefixed
token whose *third* character is a digit is treated as a negative-number
positional rather than a flag; duplicate flags are rejected; numbers
take SI suffixes.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Sequence

from quadrs_tpu_torch.utils.si import (
    parse_bool,
    parse_si_float,
    parse_si_int,
    parse_si_uint,
)


class Command:
    pass


@dataclass
class StreamCmd(Command):
    """``stream``: drive the fused shift -> lowpass -> STFT chain over a
    capture file at full rate (the StreamRunner serving path)."""

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


_PARSERS = {
    "stream": _parse_stream,
    "waterfall": _parse_waterfall,
    "scan": _parse_scan,
}
