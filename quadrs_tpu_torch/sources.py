"""Stream sources: file-backed captures and the multi-tone generator.

``SampleSource`` is the counterpart of the reference's ``SampleFile``
(``src/samples.rs:44-94``): length is the byte length over the pair
width, trailing partial pairs are truncated, and reads stage raw bytes
as (2, n) native-dtype planes (deinterleaved on the host in one pass),
which the device decodes.  A file-backed source reads through the C++
capture loader (:mod:`quadrs_tpu_torch.native`); one made from a byte
buffer stages with numpy.

``PipeSource`` is a live sequential capture (a pipe, FIFO or socket);
``RawRing`` its rolling raw-byte history for the burst recorder;
``LivePipeStream`` a forward-only random-access facade over it.

``ToneGen`` is the counterpart of ``Gen`` (``src/gen.rs``): sample ``m``
is ``sum_f e^(j*2π*f*m/sr)``, with exact host-side phase reduction and
f32 trig on the device, plus the JAX package's seeded counter-based
noise.  Like the reference (``src/gen.rs:35``) it fills every requested
buffer: reads never come up short, even past the nominal length.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Sequence

import numpy as np
import torch

from quadrs_tpu_torch.formats import FileDetails, FileFormat, decode_plane, planes_from_bytes
from quadrs_tpu_torch.ops.nco import ExactNCO
from quadrs_tpu_torch.ops.tables import device_table
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
        self._native = None
        self.format = fmt
        self.sample_rate = int(sample_rate)
        # reference src/samples.rs:64-66
        self.length = len(data) // fmt.pair_bytes

    @classmethod
    def from_file(cls, path: str, details: FileDetails | None = None) -> "SampleSource":
        if details is None:
            details = guess_details(str(path))
        from quadrs_tpu_torch.native import NativeCapture

        data = np.memmap(path, dtype=np.uint8, mode="r")
        src = cls(data, details.format, details.sample_rate)
        # the byte path of a file is the loader's: C++ pread + deinterleave,
        # ring readahead for the runners; a loader that cannot be built raises
        src._native = NativeCapture(path, details.format)
        return src

    @property
    def native(self):
        """The :class:`~quadrs_tpu_torch.native.NativeCapture` behind a
        file-backed source, or None for one made from a byte buffer."""
        return self._native

    def raw_bytes(self, lo: int, hi: int) -> bytes:
        """The capture's original interleaved bytes for samples [lo, hi)."""
        lo = max(0, min(lo, self.length))
        hi = max(lo, min(hi, self.length))
        pair = self.format.pair_bytes
        return bytes(self._bytes[lo * pair : hi * pair])

    def stage(self, lo: int, hi: int, out: np.ndarray | None = None) -> np.ndarray:
        """Materialize samples [lo, hi) as (2, hi-lo) native-dtype planes
        (clipped to the capture).  ``out``: a writable (2, >= hi-lo) array
        with contiguous rows to stage into (a page-locked slot); its
        leading columns are returned."""
        lo = max(0, min(lo, self.length))
        hi = max(lo, min(hi, self.length))
        if self._native is not None:
            return self._native.read_planes(lo, hi - lo, out=out)
        pair = self.format.pair_bytes
        planes = planes_from_bytes(self._bytes[lo * pair : hi * pair], self.format)
        if out is None:
            return planes
        out = out[:, : hi - lo]
        out[...] = planes
        return out

    # -- Stream interface -------------------------------------------------
    def span(self, off: int, n: int) -> tuple[int, int]:
        return off, n

    def reads(self, off: int, n: int) -> int:
        return n

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


class PipeSource:
    """A live sequential capture: interleaved IQ bytes from a pipe, FIFO
    or socket (``rtl_sdr - | python -m quadrs_tpu_torch stream -stdin yes``).

    Unlike :class:`SampleSource` there is no length up front and no random
    access: only the runners' sequential chunk loops can drive it, and the
    effective capture length is discovered at EOF.  Reads block until a
    full chunk arrives or the writer closes, so a slow producer throttles
    the pipeline instead of dropping samples.  A trailing partial sample
    pair at EOF is truncated, as ``SampleFile``'s length rule does
    (``src/samples.rs:64-66``); pipes deliver arbitrary byte boundaries
    mid-stream, so partial pairs are carried between reads.
    """

    is_pipe = True
    native = None
    length = None  # unknown until EOF

    def __init__(self, fileobj, fmt: FileFormat, sample_rate: int):
        """``fileobj``: a binary file object (``sys.stdin.buffer``, a
        socket ``makefile('rb')``, an ``os.fdopen`` of a pipe)."""
        if sample_rate <= 0:
            raise ValueError("sample rate must be positive")
        self._f = fileobj
        self.format = fmt
        self.sample_rate = int(sample_rate)
        self._tail = b""
        self.eof = False
        # optional rolling raw-byte history (the live burst recorder slices
        # closed spans out of it); every consumed sample's bytes enter
        # exactly once, in stream order
        self.byte_ring: RawRing | None = None

    def read_planes(self, n: int) -> np.ndarray:
        """Read up to ``n`` samples as (2, m) native-dtype planes; ``m < n``
        only at EOF (reads loop until satisfied)."""
        pair = self.format.pair_bytes
        want = n * pair
        parts = [self._tail]
        got = len(self._tail)
        while got < want and not self.eof:
            b = self._f.read(want - got)
            if b is None:
                # a non-blocking source signals "no data yet" with None:
                # wait, a momentary gap is not the end of the stream
                time.sleep(0.001)
                continue
            if not b:
                self.eof = True
                break
            parts.append(b)
            got += len(b)
        buf = b"".join(parts)
        m = len(buf) // pair
        self._tail = buf[m * pair :]
        if self.byte_ring is not None and m:
            # the previous tail was never appended (it held no full
            # sample), so this is each byte's single entry
            self.byte_ring.append(buf[: m * pair])
        return planes_from_bytes(np.frombuffer(buf[: m * pair], dtype=np.uint8), self.format)


class RawRing:
    """Rolling raw-byte history of a live pipe, addressed in absolute
    sample positions: the burst recorder slices closed spans out of it and
    prunes everything below the earliest sample still needed, so memory
    stays O(open burst + context) on an endless stream.

    ``cap_bytes`` bounds the retained history: a trigger level below the
    noise floor would otherwise hold the whole stream, and exceeding the
    cap raises with guidance rather than growing without bound.
    """

    def __init__(self, pair_bytes: int, cap_bytes: int = 1 << 30):
        self.pair = int(pair_bytes)
        self.cap = int(cap_bytes)
        self.base = 0  # absolute sample index of the first retained byte
        self._chunks: list[bytes] = []
        self._nbytes = 0
        # the runner's staging thread appends while the consumer thread
        # slices and prunes resolved spans
        self._lock = threading.Lock()

    @property
    def end(self) -> int:
        """Absolute sample index one past the retained history."""
        with self._lock:
            return self.base + self._nbytes // self.pair

    def append(self, b: bytes) -> None:
        if not b:
            return
        with self._lock:
            self._chunks.append(b)
            self._nbytes += len(b)
            over = self._nbytes > self.cap
        if over:
            raise ValueError(
                f"burst history exceeds {self.cap} bytes: the trigger "
                "level holds a span open indefinitely — raise -trigger "
                "or lower -pre/-post"
            )

    def slice(self, s0: int, s1: int) -> bytes:
        """Bytes of samples [s0, s1): absolute positions, clipped to the
        retained end; rewinding below the pruned base raises."""
        with self._lock:
            if s0 < self.base:
                raise ValueError(f"burst slice at sample {s0} was pruned (ring base {self.base})")
            s1 = min(s1, self.base + self._nbytes // self.pair)
            if s1 <= s0:
                return b""
            buf = b"".join(self._chunks)
            self._chunks = [buf]  # keep the coalescing work
            return buf[(s0 - self.base) * self.pair : (s1 - self.base) * self.pair]

    def prune(self, keep_from_sample: int) -> None:
        """Discard history below ``keep_from_sample`` (absolute)."""
        with self._lock:
            end = self.base + self._nbytes // self.pair
            drop = max(0, min(keep_from_sample, end) - self.base)
            if drop == 0:
                return
            buf = b"".join(self._chunks)
            self._chunks = [buf[drop * self.pair :]]
            self._nbytes -= drop * self.pair
            self.base += drop


class LivePipeStream(SampleSource):
    """Random-access facade over a :class:`PipeSource` for forward-moving
    consumers: a sliding planes buffer grows by reading the pipe on demand
    and discards everything below the last staged ``lo``, so memory stays
    O(batch span) on an endless stream.  ``length`` reads as a huge
    sentinel until EOF, then becomes the real capture length, so
    downstream valid clipping works unchanged.  Rewinding below discarded
    data raises (pipes cannot seek)."""

    is_live = True

    def __init__(self, pipe: PipeSource):
        # SampleSource.__init__ is not called: there is no backing byte
        # buffer, and length is a property here
        self._pipe = pipe
        self._native = None
        self.format = pipe.format
        self.sample_rate = pipe.sample_rate
        self._base = 0
        self._buf = planes_from_bytes(np.zeros(0, dtype=np.uint8), pipe.format)
        self._eof_len: int | None = None

    @property
    def length(self) -> int:
        return self._eof_len if self._eof_len is not None else (1 << 60)

    def stage(self, lo: int, hi: int, out: np.ndarray | None = None) -> np.ndarray:
        if lo < self._base:
            raise ValueError(f"live pipe stream cannot rewind to {lo} (discarded below {self._base})")
        have_hi = self._base + self._buf.shape[1]
        if hi > have_hi and self._eof_len is None:
            new = self._pipe.read_planes(hi - have_hi)
            self._buf = np.concatenate([self._buf, new], axis=1)
            if new.shape[1] < hi - have_hi:
                self._eof_len = self._base + self._buf.shape[1]
        if lo > self._base:
            self._buf = self._buf[:, lo - self._base :]
            self._base = lo
        hi_eff = min(hi, self._base + self._buf.shape[1])
        planes = self._buf[:, : max(0, hi_eff - lo)]
        if out is None:
            return planes
        out = out[:, : planes.shape[1]]
        out[...] = planes
        return out


NOISE_BLOCK = 1 << 22  # generated noise samples the host makes at a time
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
        return 0, 0  # it stages nothing

    def reads(self, off: int, n: int) -> int:
        # what a read generates: each window's (F, n) phases and its noise
        return n

    def _delta(self, n: int) -> np.ndarray:
        """A window's (F, n) in-window angles."""
        i = np.arange(n, dtype=np.int64)
        return np.stack([nc.angles(i) for nc in self._ncos], axis=0)

    def _noise_planes(self, offs: np.ndarray, n: int):
        """(B, n) f32 (re, im) noise planes for absolute sample indices
        ``offs[b] + j``: two hashed uniforms -> Box-Muller (exactly two
        draws per sample, so the mapping index -> noise is total).  Made
        ``NOISE_BLOCK`` samples at a time: the f64 steps take about 76
        bytes of host memory a sample, the planes 8."""
        offs = np.asarray(offs, dtype=np.int64)
        re, im = np.empty((len(offs), n), np.float32), np.empty((len(offs), n), np.float32)
        rows, cols = max(1, NOISE_BLOCK // max(n, 1)), max(1, min(n, NOISE_BLOCK))
        for r in range(0, len(offs), rows):
            for c in range(0, n, cols):
                k = min(cols, n - c)
                re[r : r + rows, c : c + k], im[r : r + rows, c : c + k] = self._noise_block(offs[r : r + rows] + c, k)
        return re, im

    def _noise_block(self, offs: np.ndarray, n: int):
        """:meth:`_noise_planes` of one block."""
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
        # (F, n), planned once and kept on the device
        delta = device_table("gen.delta", (tuple(self.cos), self.sample_rate, n), ctx["device"], lambda: self._delta(n))
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
