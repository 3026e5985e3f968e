"""Sinks: the terminal spectrogram, the frequency bucketer, the writer.

The counterpart of ``quadrs_tpu.sinks``.  Each sink pulls windows through
batched device work (:class:`~quadrs_tpu_torch.runtime.Executor`) and
does only presentation on the host.  Pull sizes mirror the reference
sinks exactly, because the reference's per-read convolution truncation
makes the output depend on how sinks pull (see
:mod:`quadrs_tpu_torch.stream`): sparkfft pulls ``width`` samples per
window (``src/fft.rs:27-30``), the writer ``0x1000``-sample chunks
(``src/lib.rs:199-210``), bucket ``width`` at ``reading*stride``
(``src/fft.rs:89-91``).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from quadrs_tpu_torch.formats import FileFormat, encode_cf32, encode_samples
from quadrs_tpu_torch.ops.stft import stft_norms
from quadrs_tpu_torch.runtime import Executor, root_step_of, window_batches
from quadrs_tpu_torch.stream import Stream

# The 9 display levels: blank below min, full block at/above max,
# seven partial blocks between (src/fft.rs:34-36).
SPARK_GLYPHS = np.array([" ", "▁", "▂", "▃", "▄", "▅", "▆", "▇", "█"])

DEFAULT_SPARK_MIN = 0.08  # src/fft.rs:22
DEFAULT_SPARK_MAX = 1.0  # src/fft.rs:23
WRITE_CHUNK = 0x1000  # src/lib.rs:201


def glyph_rows(norms: np.ndarray, lo: float, hi: float) -> list[str]:
    """Map magnitude rows to sparkline strings (``src/fft.rs:45-61``):
    ``< lo`` is blank, ``>= hi`` the full block, otherwise the value
    truncates into one of seven partial blocks."""
    distinction = np.float32((np.float32(hi) - np.float32(lo)) / np.float32(7.0))
    mid = ((norms - np.float32(lo)) / distinction).astype(np.int64)
    idx = 1 + np.clip(mid, 0, 6)
    idx = np.where(norms < np.float32(lo), 0, idx)
    idx = np.where(norms >= np.float32(hi), 8, idx)
    return ["".join(row) for row in SPARK_GLYPHS[idx]]


def spark_fft(
    stream: Stream,
    width: int = 128,
    stride: int | None = None,
    lo: float | None = None,
    hi: float | None = None,
    out: Callable[[str], None] | None = None,
    *,
    device: torch.device | str,
) -> list[str] | None:
    """Terminal Unicode spectrogram (reference ``src/fft.rs:12-69``):
    strided rectangular-window STFT, each row the fftshifted magnitudes on
    nine glyph levels, framed by ``│``.  With ``out`` None the rows are
    returned; otherwise each line (the header first) goes to ``out`` as
    it is made."""
    stride = width if stride is None else stride
    lo = DEFAULT_SPARK_MIN if lo is None else lo
    hi = DEFAULT_SPARK_MAX if hi is None else hi

    collected: list[str] | None = [] if out is None else None

    def emit(line: str) -> None:
        if collected is not None:
            collected.append(line)
        else:
            out(line)

    emit(f"sparkfft sample_rate={stream.sample_rate}")

    if stream.length <= width:
        # reference src/fft.rs:28 underflows here; this refuses cleanly
        if stream.length < width:
            raise ValueError("input shorter than fft width")
        return collected

    offsets = np.arange(0, stream.length - width, stride, dtype=np.int64)
    batch, batches = window_batches(offsets, width, root_step=root_step_of(stream))
    ex = Executor(stream, width, device, batch=batch, post=stft_norms)
    for offs in batches:
        norms, valid = ex.run(offs)
        if not np.all(valid == width):
            bad = offs[valid != width][0]
            raise RuntimeError(
                f"read-exact messed up: {width} (wanted) != "
                f"{int(valid[valid != width][0])} (read) at {int(bad)}"
            )
        for line in glyph_rows(norms, lo, hi):
            emit(f"│{line}│")
    return collected


@dataclass
class Levels:
    vals: list[int]


def freq_levels(
    stream: Stream,
    fft_width: int = 128,
    stride: int | None = None,
    levels: int = 2,
    *,
    device: torch.device | str,
) -> Levels:
    """Two-level frequency discriminator (reference ``src/fft.rs:77-101``):
    per strided window, compare the total magnitude of the lower and the
    upper half of the (unshifted) spectrum; 1 if lower >= upper.

    The JAX package also has a streaming route for receiver-shaped chains
    (``models.demod._strided_windows_dev``), which places and truncates
    windows as this one does; it is ported with the receivers (ROADMAP
    A10).  Here every chain takes the per-window Executor route."""
    if levels != 2:
        raise ValueError("only supporting two levels for now")
    stride = fft_width if stride is None else stride

    total = (stream.length - fft_width) // stride
    if total <= 0:
        return Levels(vals=[])
    offsets = np.arange(total, dtype=np.int64) * stride
    half = fft_width // 2

    def post(x):
        norms = stft_norms(x, shift=False)
        return norms[:, :half].sum(dim=1), norms[:, half:].sum(dim=1)

    batch, batches = window_batches(offsets, fft_width, root_step=root_step_of(stream))
    ex = Executor(stream, fft_width, device, batch=batch, post=post)
    vals: list[int] = []
    for offs in batches:
        (first, second), valid = ex.run(offs)
        if not np.all(valid == fft_width):
            raise RuntimeError("read-exact messed up in bucket")
        vals.extend(int(v) for v in np.where(first < second, 0, 1))
    return Levels(vals=vals)


def do_write(
    stream: Stream,
    overwrite: bool,
    prefix: str,
    directory: str | None = None,
    fmt: str | None = None,
    *,
    device: torch.device | str,
) -> str:
    """Write the stream as ``{prefix}.sr{rate}.cf32`` (``src/lib.rs:178-213``).

    ``fmt`` writes an integer wire format instead,
    ``{prefix}.sr{rate}.{fmt}``, quantized by
    :func:`~quadrs_tpu_torch.formats.encode_samples` (the JAX package's
    addition; the reference writes cf32 only).

    The 0x1000-sample pull is semantics (each pull sees the per-read
    truncated convolution at its own edges), but the pulls are
    independent windows, so many run per batch: the reference's offsets
    are ``0, 0x1000, 0x2000, …`` because every read but the last comes
    back full.  A short read falls back to the sequential loop so the
    ``off += read`` advance stays faithful, and a zero-length read raises
    like the reference's short-read assert (a decimated file stream's
    claimed last sample is unreadable: its raw span runs past the file).
    With ``overwrite`` the file is opened without truncation, as the
    reference's create-without-truncate does: a longer old file keeps its
    tail.
    """
    if prefix == "-":
        raise NotImplementedError("stdout writing is unimplemented in the reference")

    wire = FileFormat.COMPLEX_FLOAT32 if fmt is None else FileFormat(fmt)
    filename = f"{prefix}.sr{stream.sample_rate}.{wire.value}"
    if directory is not None:
        filename = os.path.join(directory, filename)

    if overwrite:
        fh = open(filename, "r+b" if os.path.exists(filename) else "wb")
    else:
        fh = open(filename, "xb")  # create_new

    def encode(x):
        return encode_samples(x, wire)

    offsets = np.arange(0, stream.length, WRITE_CHUNK, dtype=np.int64)
    with fh:
        if len(offsets) == 0:
            return filename
        batch, batches = window_batches(offsets, WRITE_CHUNK, root_step=root_step_of(stream))
        ex = Executor(stream, WRITE_CHUNK, device, batch=batch)
        for offs in batches:
            samples, valid = ex.run(offs)
            for i in range(len(offs)):
                read = int(valid[i])
                if read == 0:
                    raise RuntimeError(f"short read at offset {int(offs[i])} of {stream.length}")
                fh.write(encode(samples[i][:read]))
                if read < WRITE_CHUNK:
                    # resume the reference's sequential advance from here
                    next_off = int(offs[i]) + read
                    if next_off < stream.length:
                        _write_sequential(fh, stream, next_off, encode, device=device)
                    return filename
    return filename


def _write_sequential(fh, stream: Stream, off: int, encode=encode_cf32, *, device) -> None:
    """The reference's literal pull loop (``src/lib.rs:199-210``)."""
    ex = Executor(stream, WRITE_CHUNK, device, batch=1)
    while off < stream.length:
        samples, valid = ex.run(np.asarray([off], dtype=np.int64))
        read = int(valid[0])
        if read == 0:
            raise RuntimeError(f"short read at offset {off} of {stream.length}")
        fh.write(encode(samples[0][:read]))
        off += read
