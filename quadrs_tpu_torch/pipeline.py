"""The operation model: chainable pipeline commands and their fold.

The counterpart of ``quadrs_tpu.pipeline``, after the reference's
``Operation`` enum and ``exec`` fold (``src/lib.rs:25-176``): ``From`` and
``Gen`` create the stream accumulator, ``Shift`` and ``LowPass`` wrap it
lazily, and the sinks (``SparkFft``, ``Bucket``, ``Write``) consume it and
pass it on unchanged, so several sinks can be chained.  Every device
computation runs on the ``device`` the caller passes in (the CLI chooses
it once).

The JAX package's other operations (``resample``, ``dcblock``, ``agc``,
``iqbal``, ``find``) parse as there and raise "not yet ported" here.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Sequence

import torch

from quadrs_tpu_torch import sinks
from quadrs_tpu_torch.formats import FileDetails
from quadrs_tpu_torch.sources import SampleSource, ToneGen
from quadrs_tpu_torch.stream import LowPass, Shift, Stream


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


# -- parsed, not yet ported (the JAX package's additions) --------------------


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


# operation -> (command, the ROADMAP item that ports it)
NOT_PORTED = {
    ResampleOp: ("resample", "A10"),
    DcBlockOp: ("dcblock", "A10"),
    AgcOp: ("agc", "A10"),
    IqbalOp: ("iqbal", "A10"),
    FindOp: ("find", "A9"),
}


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
    if type(op) in NOT_PORTED:
        name, item = NOT_PORTED[type(op)]
        raise NotImplementedError(f"{name} is not yet ported to quadrs_tpu_torch (ROADMAP {item})")
    raise ValueError(f"unknown operation: {op!r}")


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
