"""IQ capture formats and bit-exact sample codecs.

The four wire formats and their decode formulas mirror the reference
(``src/lib.rs:61-74`` for the enum, ``src/lib.rs:215-256`` for the byte
widths and decode math) exactly, including the mathematically odd cu8 /
cs16 offsets:

    cf32:  little-endian IEEE f32 pairs            (GNU-Radio, gqrx)
    cs8 :  f32(int8)  / 127.0                      (HackRF)
    cu8 :  f32(uint8) / 255.0 - 127.5              (RTL-SDR)
    cs16:  f32(int16) / 65535.0 - 32767.5          (Fancy)

Every decode is a widening to f32 followed by an IEEE-754 f32 division
and subtraction, so numpy arrays and torch tensors decode to identical
bits.  On a CUDA tensor the divisor is a device tensor, never a Python
scalar: PyTorch turns division by a host scalar into multiplication by
its reciprocal there, which can land 1 ulp off.

The host stages raw capture bytes as numpy planes in their native narrow
dtype (int8 / uint8 / int16 / f32), so integer formats cross to the
device at 1/4 to 1/2 the bytes of f32, and decode there.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass

import numpy as np
import torch


class FileFormat(enum.Enum):
    """Wire format of a raw IQ capture (reference ``src/lib.rs:61-74``)."""

    COMPLEX_FLOAT32 = "cf32"
    COMPLEX_INT8 = "cs8"
    COMPLEX_UINT8 = "cu8"
    COMPLEX_INT16 = "cs16"

    @property
    def type_bytes(self) -> int:
        # reference src/lib.rs:217-224
        return {
            FileFormat.COMPLEX_FLOAT32: 4,
            FileFormat.COMPLEX_INT8: 1,
            FileFormat.COMPLEX_UINT8: 1,
            FileFormat.COMPLEX_INT16: 2,
        }[self]

    @property
    def pair_bytes(self) -> int:
        # reference src/lib.rs:226-229
        return self.type_bytes * 2

    @property
    def raw_dtype(self) -> np.dtype:
        """Native numpy dtype for zero-copy staging of one scalar component."""
        return {
            FileFormat.COMPLEX_FLOAT32: np.dtype("<f4"),
            FileFormat.COMPLEX_INT8: np.dtype("i1"),
            FileFormat.COMPLEX_UINT8: np.dtype("u1"),
            FileFormat.COMPLEX_INT16: np.dtype("<i2"),
        }[self]

    @property
    def torch_dtype(self) -> torch.dtype:
        """The torch dtype of :attr:`raw_dtype` (what ``torch.from_numpy``
        gives for staged planes)."""
        return {
            FileFormat.COMPLEX_FLOAT32: torch.float32,
            FileFormat.COMPLEX_INT8: torch.int8,
            FileFormat.COMPLEX_UINT8: torch.uint8,
            FileFormat.COMPLEX_INT16: torch.int16,
        }[self]


# Extension spellings accepted by the reference (src/args.rs:392-402).
_EXTENSIONS = {
    "cf32": FileFormat.COMPLEX_FLOAT32,
    "fc32": FileFormat.COMPLEX_FLOAT32,
    "cs8": FileFormat.COMPLEX_INT8,
    "sc8": FileFormat.COMPLEX_INT8,
    "c8": FileFormat.COMPLEX_INT8,
    "cu8": FileFormat.COMPLEX_UINT8,
    "su8": FileFormat.COMPLEX_UINT8,
    "cs16": FileFormat.COMPLEX_INT16,
    "sc16": FileFormat.COMPLEX_INT16,
    "c16": FileFormat.COMPLEX_INT16,
}


def format_from_extension(ext: str) -> FileFormat | None:
    """Map a filename extension to a format (reference ``src/args.rs:392-402``)."""
    return _EXTENSIONS.get(ext)


@dataclass(frozen=True)
class FileDetails:
    """Resolved capture metadata (reference ``src/lib.rs:76-80``)."""

    format: FileFormat
    sample_rate: int


# (divisor, offset) of each integer decode (reference src/lib.rs:248-253)
_INT_DECODE = {
    FileFormat.COMPLEX_INT8: (127.0, None),
    FileFormat.COMPLEX_UINT8: (255.0, 127.5),
    FileFormat.COMPLEX_INT16: (65535.0, 32767.5),
}


def _decode_components(raw, fmt: FileFormat, about: float = 0.0):
    """Raw component values -> f32, on a numpy array or a torch tensor,
    less ``about`` (folded into the decode's own offset: one subtraction)."""
    if fmt not in _INT_DECODE and fmt is not FileFormat.COMPLEX_FLOAT32:
        raise ValueError(f"unknown format: {fmt}")
    div, off = _INT_DECODE.get(fmt, (None, None))
    shift = (off or 0.0) + about if about else off
    if isinstance(raw, torch.Tensor):
        x = raw.to(torch.float32)
        if div is not None:
            x = x / torch.full((), div, dtype=torch.float32, device=x.device)
        return x if not shift else x - torch.full((), shift, dtype=torch.float32, device=x.device)
    x = raw.astype(np.float32) if raw.dtype != np.float32 else raw
    if div is not None:
        x = x / np.float32(div)
    return x if not shift else x - np.float32(shift)


def decode_plane(raw, fmt: FileFormat, about: float = 0.0):
    """Decode one deinterleaved component plane (numpy array or torch
    tensor, any device) to f32 with the reference's bit-exact formulas.

    ``about``: a value to measure from (``info``'s neutral value of the
    format).  It is folded into the decode's own offset, so that a cs16
    sample is not first rounded to f32's 2^-8 grid at -32767.5; with the
    default 0 the result is the reference's decode, bit for bit."""
    return _decode_components(raw, fmt, about)


def decode_to_complex64(raw, fmt: FileFormat):
    """Decode interleaved raw component values, ``(..., 2*n)`` of the
    format's native dtype (a numpy array or a torch tensor on any device),
    to ``(..., n)`` complex64 of the same kind.  The (re, im) pack does no
    arithmetic, so cf32's NaN payloads survive."""
    comps = _decode_components(raw, fmt)
    re, im = comps[..., 0::2], comps[..., 1::2]
    if isinstance(comps, torch.Tensor):
        return torch.complex(re, im)
    out = np.empty(np.broadcast(re, im).shape, dtype=np.complex64)
    out.real, out.imag = re, im
    return out


def decode_bytes(buf: bytes | np.ndarray, fmt: FileFormat) -> np.ndarray:
    """Raw capture bytes to complex64 on the host (numpy).  Trailing
    partial sample pairs are truncated, as the reference does
    (``src/samples.rs:84``)."""
    flat = buf if isinstance(buf, np.ndarray) else np.frombuffer(buf, dtype=np.uint8)
    return decode_to_complex64(view_raw(flat, fmt), fmt)


def view_raw(buf: np.ndarray, fmt: FileFormat) -> np.ndarray:
    """Zero-copy view of a uint8 byte buffer as the format's native dtype."""
    pair = fmt.pair_bytes
    n = len(buf) // pair
    return buf[: n * pair].view(fmt.raw_dtype)


def planes_from_bytes(buf: np.ndarray, fmt: FileFormat) -> np.ndarray:
    """Host-side deinterleave: uint8 capture bytes -> (2, n) native-dtype
    planes (one memory pass, contiguous output)."""
    comps = view_raw(np.asarray(buf), fmt)
    n = len(comps) // 2
    return np.ascontiguousarray(comps[: 2 * n].reshape(n, 2).T)


def encode_cf32(samples: np.ndarray) -> bytes:
    """Encode complex64 samples as little-endian interleaved f32 pairs
    (reference ``src/lib.rs:197-209``)."""
    samples = np.ascontiguousarray(samples, dtype=np.complex64)
    return samples.view(np.float32).astype("<f4", copy=False).tobytes()


def encode_samples(samples: np.ndarray, fmt: FileFormat) -> bytes:
    """Encode complex64 samples as a format's interleaved wire bytes: the
    inverse of the decode formulas (round to the nearest representable
    code, clamped to the dtype's range).  cs16 is computed in f64, since
    its decode is not injective.  Warns when more than 0.1% of the
    samples saturate (cu8/cs16 carry the reference decode's DC offset)."""
    if fmt is FileFormat.COMPLEX_FLOAT32:
        return encode_cf32(samples)
    samples = np.ascontiguousarray(samples, dtype=np.complex64)
    comps = samples.view(np.float32)
    if fmt is FileFormat.COMPLEX_INT8:
        raw = np.rint(comps * np.float32(127.0))
        lo, hi, dtype = -128, 127, "<i1"
    elif fmt is FileFormat.COMPLEX_UINT8:
        raw = np.rint((comps + np.float32(127.5)) * np.float32(255.0))
        lo, hi, dtype = 0, 255, "u1"
    elif fmt is FileFormat.COMPLEX_INT16:
        raw = np.rint((comps.astype(np.float64) + 32767.5) * 65535.0)
        lo, hi, dtype = -32768, 32767, "<i2"
    else:
        raise ValueError(f"unknown format: {fmt}")
    q = np.clip(raw, lo, hi)
    clipped = float(np.mean(raw != q)) if raw.size else 0.0
    if clipped > 0.001:
        import warnings

        warnings.warn(
            f"{clipped:.1%} of samples saturate {fmt.value}'s representable "
            f"range — cu8/cs16 carry the reference decode's DC offset, so "
            f"offset-free (shifted/filtered) signals cannot be stored in "
            f"them losslessly",
            stacklevel=2,
        )
    return q.astype(dtype).tobytes()


def synth_planes(
    fmt: FileFormat, n_samples: int, seed: int = 0, n_streams: int | None = None
) -> np.ndarray:
    """Deterministic synthetic capture planes in a format's native dtype:
    shape (2, n) or (n_streams, 2, n), from numpy's ``default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    shape = (2, n_samples) if n_streams is None else (n_streams, 2, n_samples)
    if fmt is FileFormat.COMPLEX_FLOAT32:
        return rng.normal(scale=0.3, size=shape).astype(np.float32)
    if fmt is FileFormat.COMPLEX_INT8:
        return rng.integers(-127, 128, shape, dtype=np.int64).astype(np.int8)
    if fmt is FileFormat.COMPLEX_UINT8:
        return rng.integers(0, 256, shape, dtype=np.int64).astype(np.uint8)
    return rng.integers(-32768, 32768, shape, dtype=np.int64).astype(np.int16)
