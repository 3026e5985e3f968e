"""The operation model: chainable pipeline commands and their fold.

The counterpart of ``quadrs_tpu.pipeline``, after the reference's
``Operation`` enum and ``exec`` fold (``src/lib.rs:25-176``): ``From`` and
``Gen`` create the stream accumulator, ``Shift`` and ``LowPass`` wrap it
lazily, and the sinks (``SparkFft``, ``Bucket``, ``Write``) consume it and
pass it on unchanged, so several sinks can be chained.  The JAX package's
additions are here too: the stages ``resample``, ``dcblock``, ``agc`` and
``iqbal``, and the pattern search ``find`` (a sink).  Every device
computation runs on the ``device`` the caller passes in (the CLI chooses
it once).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Sequence

import torch

from quadrs_tpu_torch import sinks
from quadrs_tpu_torch.formats import FileDetails
from quadrs_tpu_torch.sources import SampleSource, ToneGen
from quadrs_tpu_torch.stream import Agc, DcBlock, IqCorrect, LowPass, Resample, Shift, Stream


class Operation:
    """Base class of the pipeline operations (reference ``src/lib.rs:25-59``)."""


@dataclass
class From(Operation):
    details: FileDetails
    filename: str


@dataclass
class ShiftOp(Operation):
    frequency: int


@dataclass
class LowPassOp(Operation):
    size: int
    decimate: int
    frequency: int


@dataclass
class SparkFftOp(Operation):
    width: int = 128
    stride: int | None = None
    min: float | None = None
    max: float | None = None


@dataclass
class BucketOp(Operation):
    fft_width: int = 128
    stride: int | None = None
    levels: int = 2


@dataclass
class WriteOp(Operation):
    overwrite: bool
    prefix: str
    # quantize to an integer wire format (the JAX package's addition; the
    # reference writes cf32 only); None writes cf32
    format: str | None = None


@dataclass
class GenOp(Operation):
    seconds: float
    sample_rate: int
    cos: Sequence[int] = field(default_factory=list)
    # seeded complex Gaussian noise (per-component sigma); the reference
    # generator is noiseless
    noise: float = 0.0
    seed: int = 0


# -- the JAX package's additions ---------------------------------------------


@dataclass
class ResampleOp(Operation):
    up: int
    down: int
    size: int | None = None
    power: int = 8


@dataclass
class DcBlockOp(Operation):
    window: int = 32_000


@dataclass
class AgcOp(Operation):
    target: float = 1.0
    window: int = 4_000
    max_gain: float = 1000.0


@dataclass
class IqbalOp(Operation):
    c: complex | None = None
    est: int = 256_000


@dataclass
class FindOp(Operation):
    details: Sequence[FileDetails]
    filenames: Sequence[str]
    threshold: float = 0.5
    top: int = 0
    distance: int | None = None
    freq_tol: float = 0.0
    freq_step: float | None = None
    stdin: bool = False
    sample_rate: str | None = None
    format: str | None = None
    write: str | None = None
    pre: int = 0
    post: int = 0
    overwrite: bool = False
    mesh: tuple[int, int] | None = None


def _need(stream: Stream | None, what: str) -> Stream:
    if stream is None:
        raise ValueError(f"{what} requires an input")
    return stream


def exec_operation(
    op: Operation,
    stream: Stream | None,
    emit: Callable[[str], None] = print,
    write_dir: str | None = None,
    *,
    device: torch.device | str,
) -> Stream | None:
    """Execute one operation against the accumulator (``src/lib.rs:82-176``)."""
    if isinstance(op, From):
        return SampleSource.from_file(op.filename, op.details)
    if isinstance(op, GenOp):
        return ToneGen(op.cos, op.sample_rate, op.seconds, noise=op.noise, seed=op.seed)
    if isinstance(op, ShiftOp):
        stream = _need(stream, "shift")
        return Shift(stream, op.frequency, stream.sample_rate)
    if isinstance(op, LowPassOp):
        return LowPass(_need(stream, "lowpass"), op.frequency, op.decimate, op.size)
    if isinstance(op, ResampleOp):
        return Resample(_need(stream, "resample"), op.up, op.down, size=op.size, power=op.power)
    if isinstance(op, DcBlockOp):
        return DcBlock(_need(stream, "dcblock"), op.window)
    if isinstance(op, AgcOp):
        return Agc(_need(stream, "agc"), target=op.target, window=op.window, max_gain=op.max_gain)
    if isinstance(op, IqbalOp):
        return IqCorrect(_need(stream, "iqbal"), c=op.c, est_samples=op.est, device=device)
    if isinstance(op, FindOp):
        stream = _need(stream, "find")
        _find(op, stream, emit, device)
        return stream
    if isinstance(op, SparkFftOp):
        stream = _need(stream, "sparkfft")
        # print takes a batch's rows as one string: one write per batch
        sinks.spark_fft(stream, op.width, op.stride, op.min, op.max, out=emit, device=device, batched=emit is print)
        return stream
    if isinstance(op, BucketOp):
        stream = _need(stream, "bucket -by freq")
        levels = sinks.freq_levels(stream, op.fft_width, op.stride, op.levels, device=device)
        emit("".join(str(v) for v in levels.vals))
        return stream
    if isinstance(op, WriteOp):
        stream = _need(stream, "write")
        sinks.do_write(stream, op.overwrite, op.prefix, directory=write_dir, fmt=op.format, device=device)
        return stream
    raise ValueError(f"unknown operation: {op!r}")


def _find(op: FindOp, stream: Stream, emit: Callable[[str], None], device) -> None:
    """``find``: search ``stream`` for the pattern files, print one line a
    match and a closing line, and with ``-write`` save each match as a
    slice of the original capture."""
    pats = []
    for fname, details in zip(op.filenames, op.details):
        psrc = SampleSource.from_file(fname, details)
        if psrc.sample_rate != stream.sample_rate:
            raise ValueError(
                f"pattern rate {psrc.sample_rate} != stream rate "
                f"{stream.sample_rate}: resample one side first"
            )
        pat, valid = psrc.read_at(0, psrc.length, device)
        if valid != psrc.length:
            raise RuntimeError("short read loading the pattern capture")
        pats.append(pat)
    res = sinks.find_pattern(
        stream,
        pats if len(pats) > 1 else pats[0],
        threshold=op.threshold,
        max_matches=op.top if op.top else None,
        min_distance=op.distance,
        freq_tol=op.freq_tol,
        freq_step=op.freq_step,
        mesh=op.mesh,
        device=device,
    )
    bank = len(pats) > 1
    for o, s, a, f, w in zip(res.offsets, res.scores, res.scales, res.freqs, res.which):
        line = f"{int(o)},{float(s):.4f},{float(a):.6g},{float(f):+g}"
        emit(line + f",{int(w)}" if bank else line)  # a bank adds which
    if op.write is not None:
        root = stream.root()
        if not hasattr(root, "raw_bytes"):
            raise ValueError(
                "find -write needs a seekable capture file behind the "
                "chain (a pipe keeps no history to slice)"
            )
        ext = root.format.value  # the enum values are the extensions
        for k, (o, w) in enumerate(zip(res.offsets, res.which)):
            # widen in searched-stream samples, then map the span through the
            # chain (FIR lookahead included), so the slice re-demodulates
            a = max(0, int(o) - op.pre)
            n = int(o) + len(pats[int(w)]) + op.post - a
            s0, sn = stream.span(a, n)
            s0 = max(0, s0)
            s1 = min(s0 + sn, root.length)
            path = f"{op.write}.m{k}.s{s0}.sr{root.sample_rate}.{ext}"
            with open(path, "wb" if op.overwrite else "xb") as fh:
                fh.write(root.raw_bytes(s0, s1))
            emit(f"find match {k}: samples {s0}..{s1}, wrote {path}")
    emit(f"find: {len(res.offsets)} matches, pattern {res.pattern_len} samples, {res.scanned} scanned")


def run_pipeline(
    ops: Sequence[Operation],
    emit: Callable[[str], None] = print,
    write_dir: str | None = None,
    *,
    device: torch.device | str,
    stream: Stream | None = None,
) -> Stream | None:
    """Fold operations left to right (``src/bin/quadrs.rs:48-57``),
    starting from the accumulator ``stream``."""
    for op in ops:
        stream = exec_operation(op, stream, emit=emit, write_dir=write_dir, device=device)
    return stream
