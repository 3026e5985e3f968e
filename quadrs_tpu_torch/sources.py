"""Stream sources: file-backed captures and the multi-tone generator.

``SampleSource`` is the counterpart of the reference's ``SampleFile``
(``src/samples.rs:44-94``): length is the byte length over the pair
width, trailing partial pairs are truncated, and reads stage raw bytes
as (2, n) native-dtype planes (deinterleaved on the host in one pass),
which the device decodes.

``ToneGen`` is the counterpart of ``Gen`` (``src/gen.rs``): sample ``m``
is ``sum_f e^(j*2π*f*m/sr)``, with exact host-side phase reduction and
f32 trig on the device, plus the JAX package's seeded counter-based
noise.  Like the reference (``src/gen.rs:35``) it fills every requested
buffer: reads never come up short, even past the nominal length.
"""

from __future__ import annotations

from typing import Any, Sequence

import numpy as np
import torch

from quadrs_tpu_torch.formats import FileDetails, FileFormat, decode_plane, planes_from_bytes
from quadrs_tpu_torch.ops.nco import ExactNCO
from quadrs_tpu_torch.stream import Plan, Stream
from quadrs_tpu_torch.utils.sniff import guess_details


class SampleSource(Stream):
    """A raw IQ capture, staged lazily as native-dtype planes and decoded
    on the device."""

    has_staging = True

    def __init__(self, data: np.ndarray, fmt: FileFormat, sample_rate: int):
        """``data``: 1-D uint8 byte buffer (memmap or array) of the capture."""
        if sample_rate <= 0:
            raise ValueError("sample rate must be positive")
        self._bytes = data
        self.format = fmt
        self.sample_rate = int(sample_rate)
        # reference src/samples.rs:64-66
        self.length = len(data) // fmt.pair_bytes

    @classmethod
    def from_file(cls, path: str, details: FileDetails | None = None) -> "SampleSource":
        if details is None:
            details = guess_details(str(path))
        data = np.memmap(path, dtype=np.uint8, mode="r")
        return cls(data, details.format, details.sample_rate)

    def raw_bytes(self, lo: int, hi: int) -> bytes:
        """The capture's original interleaved bytes for samples [lo, hi)."""
        lo = max(0, min(lo, self.length))
        hi = max(lo, min(hi, self.length))
        pair = self.format.pair_bytes
        return bytes(self._bytes[lo * pair : hi * pair])

    def stage(self, lo: int, hi: int) -> np.ndarray:
        """Materialize samples [lo, hi) as (2, hi-lo) native-dtype planes
        (clipped to the capture)."""
        lo = max(0, min(lo, self.length))
        hi = max(lo, min(hi, self.length))
        pair = self.format.pair_bytes
        return planes_from_bytes(self._bytes[lo * pair : hi * pair], self.format)

    # -- Stream interface -------------------------------------------------
    def span(self, off: int, n: int) -> tuple[int, int]:
        return off, n

    def plan(self, offs: np.ndarray, n: int, base: int) -> Plan:
        offs = np.asarray(offs, dtype=np.int64)
        valid = np.clip(self.length - offs, 0, n)
        return Plan(prep={"off_rel": offs - base, "valid": valid}, valid=valid)

    def read_batch(self, ctx: dict, prep: Any, n: int) -> torch.Tensor:
        buf = ctx["buf"]  # (2, staged) native-dtype planes
        idx = prep["off_rel"][:, None] + torch.arange(n, device=buf.device)[None, :]
        idx = idx.clamp_(0, buf.shape[1] - 1)
        x = torch.complex(decode_plane(buf[0][idx], self.format), decode_plane(buf[1][idx], self.format))
        keep = torch.arange(n, device=buf.device)[None, :] < prep["valid"][:, None]
        return torch.where(keep, x, 0)


_SM_C1 = np.uint64(0xBF58476D1CE4E5B9)
_SM_C2 = np.uint64(0x94D049BB133111EB)
_SM_GAMMA = np.uint64(0x9E3779B97F4A7C15)


def _splitmix64(x: np.ndarray) -> np.ndarray:
    """Vectorized splitmix64 finalizer: a stateless uint64 hash, so a noise
    value depends only on (seed, absolute index) and random access stays
    coherent at any offset.  uint64 wraparound is the algorithm."""
    with np.errstate(over="ignore"):
        z = (np.asarray(x, dtype=np.uint64) + _SM_GAMMA).astype(np.uint64)
        z = (z ^ (z >> np.uint64(30))) * _SM_C1
        z = (z ^ (z >> np.uint64(27))) * _SM_C2
        return z ^ (z >> np.uint64(31))


class ToneGen(Stream):
    """Multi-tone complex exponential generator (``src/gen.rs``), plus the
    JAX package's seeded complex Gaussian noise (``noise`` = per-component
    standard deviation).  The noise is counter-based, a splitmix64 hash of
    the absolute sample index through an f64 two-uniform Box-Muller on the
    host, so the same sample always gets the same noise whatever the pull
    size or order."""

    def __init__(
        self,
        cos: Sequence[int],
        sample_rate: int,
        seconds: float,
        noise: float = 0.0,
        seed: int = 0,
    ):
        # reference src/gen.rs:17-27
        if not cos:
            raise ValueError("cos cannot be empty")
        if sample_rate == 0:
            raise ValueError("sample rate may not be zero")
        if not seconds > 0.0:
            raise ValueError("seconds may not be <= 0")
        if noise < 0.0:
            raise ValueError("noise must be >= 0")
        self.cos = [int(f) for f in cos]
        self.sample_rate = int(sample_rate)
        self.seconds = float(seconds)
        self.noise = float(noise)
        self.seed = int(seed)
        # reference src/gen.rs:31-33 (f64 multiply, truncate)
        self.length = int(self.seconds * float(self.sample_rate))
        self._ncos = [ExactNCO(f, self.sample_rate) for f in self.cos]

    def span(self, off: int, n: int) -> tuple[int, int]:
        return 0, 0

    def _delta(self, n: int) -> np.ndarray:
        i = np.arange(n, dtype=np.int64)
        return np.stack([nc.angles(i) for nc in self._ncos], axis=0)  # (F, n)

    def _noise_planes(self, offs: np.ndarray, n: int):
        """(B, n) f32 (re, im) noise planes for absolute sample indices
        ``offs[b] + j``: two hashed uniforms -> Box-Muller (exactly two
        draws per sample, so the mapping index -> noise is total)."""
        with np.errstate(over="ignore"):
            idx = (offs[:, None].astype(np.uint64) + np.arange(n, dtype=np.uint64)) * np.uint64(2)
            key = _splitmix64(np.uint64(self.seed) ^ np.uint64(0xA5A5A5A55A5A5A5A))
            h1 = _splitmix64(idx ^ key)
            h2 = _splitmix64((idx + np.uint64(1)) ^ key)
        # (0, 1] / [0, 1) uniforms from the top 53 bits
        u1 = ((h1 >> np.uint64(11)).astype(np.float64) + 1.0) * 2.0**-53
        u2 = (h2 >> np.uint64(11)).astype(np.float64) * 2.0**-53
        r = self.noise * np.sqrt(-2.0 * np.log(u1))
        ang = 2.0 * np.pi * u2
        return (r * np.cos(ang)).astype(np.float32), (r * np.sin(ang)).astype(np.float32)

    def plan(self, offs: np.ndarray, n: int, base: int) -> Plan:
        offs = np.asarray(offs, dtype=np.int64)
        # Gen always fills the whole buffer (src/gen.rs:35-47)
        valid = np.full(len(offs), n, dtype=np.int64)
        prep = {"theta0": np.stack([nc.angles(offs) for nc in self._ncos], axis=1)}  # (B, F)
        if self.noise:
            prep["noise_re"], prep["noise_im"] = self._noise_planes(offs, n)
        return Plan(prep=prep, valid=valid)

    def read_batch(self, ctx: dict, prep: Any, n: int) -> torch.Tensor:
        delta = torch.as_tensor(self._delta(n), device=ctx["device"])  # (F, n)
        theta = prep["theta0"][:, :, None] + delta[None, :, :]  # (B, F, n)
        out = torch.complex(torch.cos(theta), torch.sin(theta)).sum(dim=1)
        if self.noise:
            out = out + torch.complex(prep["noise_re"], prep["noise_im"])
        return out


def open_capture(
    path: str,
    sample_rate: str | int | None = None,
    fmt: str | None = None,
) -> SampleSource:
    """Open a capture with filename sniffing and optional overrides."""
    details = guess_details(
        str(path),
        override_sample_rate=None if sample_rate is None else str(sample_rate),
        override_format=fmt,
    )
    return SampleSource.from_file(path, details)
