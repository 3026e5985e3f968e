"""Sinks: the terminal spectrogram, the frequency bucketer, the writer,
the GUI waterfall's evenly spaced STFT (``take_fft``), the pattern search
behind ``find``, and the capture statistics behind ``info``.

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

from quadrs_tpu_torch.formats import FileFormat, decode_plane, encode_cf32, encode_samples
from quadrs_tpu_torch.ops.stft import blackman_harris_window, stft_norms
from quadrs_tpu_torch.runtime import Executor, root_step_of, window_batches
from quadrs_tpu_torch.stream import Stream

# The 9 display levels: blank below min, full block at/above max,
# seven partial blocks between (src/fft.rs:34-36).
SPARK_GLYPHS = np.array([" ", "▁", "▂", "▃", "▄", "▅", "▆", "▇", "█"])

DEFAULT_SPARK_MIN = 0.08  # src/fft.rs:22
DEFAULT_SPARK_MAX = 1.0  # src/fft.rs:23
WRITE_CHUNK = 0x1000  # src/lib.rs:201


# the glyphs' UTF-8 bytes, zero-padded to 3: the blank is 1 byte, every
# block 3; no byte of any of them is zero, so the padding can be masked out
_GLYPH_BYTES = np.zeros((9, 3), dtype=np.uint8)
for _i, _g in enumerate(SPARK_GLYPHS):
    _GLYPH_BYTES[_i, : len(_g.encode())] = np.frombuffer(_g.encode(), dtype=np.uint8)
_FRAME = np.frombuffer("│".encode(), dtype=np.uint8)


def glyph_levels(norms: np.ndarray, lo: float, hi: float) -> np.ndarray:
    """Each magnitude's display level 0-8 (``src/fft.rs:45-61``): ``< lo``
    is the blank, ``>= hi`` the full block, otherwise the value truncates
    into one of seven partial blocks."""
    lo32, hi32 = np.float32(lo), np.float32(hi)
    distinction = np.float32((hi32 - lo32) / np.float32(7.0))
    norms = np.asarray(norms, dtype=np.float32)
    # truncate into 0..6; NaN (every comparison false) lands on 0, as its
    # cast to an integer and clip did; a value past 6 is >= hi or < lo
    with np.errstate(all="ignore"):
        mid = (norms - lo32) / distinction
        idx = np.where(mid >= 0, np.minimum(mid, np.float32(6.0)), np.float32(0.0)).astype(np.uint8)
    idx += 1
    np.putmask(idx, norms < lo32, 0)
    np.putmask(idx, norms >= hi32, 8)
    return idx


def glyph_lines(norms: np.ndarray, lo: float, hi: float, frame: bool = True) -> str:
    """(R, W) magnitude rows as R sparkline lines joined by newlines (none
    after the last), each framed by ``│`` unless ``frame`` is False.  The
    whole block is built as one UTF-8 byte buffer: a (9, 3) byte table
    indexed by level, its zero padding masked out."""
    idx = glyph_levels(np.atleast_2d(norms), lo, hi)
    rows, width = idx.shape
    if rows == 0:
        return ""
    edge = 3 if frame else 0
    buf = np.zeros((rows, edge + 3 * width + edge + 1), dtype=np.uint8)
    if frame:
        buf[:, :3] = _FRAME
        buf[:, -4:-1] = _FRAME
    buf[:, edge : edge + 3 * width] = np.take(_GLYPH_BYTES, idx, axis=0).reshape(rows, 3 * width)
    buf[:-1, -1] = ord("\n")
    return buf[buf != 0].tobytes().decode()


def glyph_rows(norms: np.ndarray, lo: float, hi: float) -> list[str]:
    """Map magnitude rows to sparkline strings, one per row, unframed."""
    norms = np.atleast_2d(norms)
    return glyph_lines(norms, lo, hi, frame=False).split("\n") if norms.shape[0] else []


def spark_fft(
    stream: Stream,
    width: int = 128,
    stride: int | None = None,
    lo: float | None = None,
    hi: float | None = None,
    out: Callable[[str], None] | None = None,
    *,
    device: torch.device | str,
    batched: bool = False,
) -> list[str] | None:
    """Terminal Unicode spectrogram (reference ``src/fft.rs:12-69``):
    strided rectangular-window STFT, each row the fftshifted magnitudes on
    nine glyph levels, framed by ``│``.  With ``out`` None the rows are
    returned; otherwise each line (the header first) goes to ``out`` as
    it is made, or with ``batched`` each batch's lines in one call, joined
    by newlines (one write per batch for ``print``)."""
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
    for offs, norms, valid in ex.run_each(batches):  # a batch's rows are made while the next computes
        if not np.all(valid == width):
            bad = offs[valid != width][0]
            raise RuntimeError(
                f"read-exact messed up: {width} (wanted) != "
                f"{int(valid[valid != width][0])} (read) at {int(bad)}"
            )
        block = glyph_lines(norms, lo, hi)
        if batched and out is not None:
            out(block)
        else:
            for line in block.split("\n"):
                emit(line)
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

    A receiver-shaped chain (``[shift ->] lowpass``, or the bare capture)
    over a staging source takes the streaming route, as the JAX package's
    does (:func:`quadrs_tpu_torch.models.demod._strided_windows_dev`: the
    raw span of many windows staged once a dispatch, each window placed
    and truncated as a per-window read would be); other chains (user
    stages, live pipes, ``gen``) take the per-window Executor route."""
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

    # lazy import: the receivers' module imports this one
    from quadrs_tpu_torch.models.demod import _strided_windows_dev

    fast = _strided_windows_dev(stream, fft_width, stride, total, post, device=device)
    if fast is not None:
        first, second = fast
        return Levels(vals=[int(v) for v in np.where(first < second, 0, 1)])

    batch, batches = window_batches(offsets, fft_width, root_step=root_step_of(stream))
    ex = Executor(stream, fft_width, device, batch=batch, post=post)
    vals: list[int] = []
    for _, (first, second), valid in ex.run_each(batches):
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


@dataclass
class FftResult:
    """Flat magnitude rows, the GUI waterfall's data (``src/ffts.rs:86-108``)."""

    norms: np.ndarray  # (output_len, fft_width) f32, fftshifted
    fft_width: int

    def get(self, index: int) -> np.ndarray:
        if not 0 <= index < self.output_len:
            raise IndexError(f"index out of bounds: {index}")
        return self.norms[index]

    @property
    def output_len(self) -> int:
        return self.norms.shape[0]

    def max(self) -> float:
        return float(np.max(self.norms, initial=0.0))

    def min(self) -> float:
        return float(np.min(self.norms, initial=np.inf))


def take_fft_offsets(start: int, visible: int, output_len: int) -> np.ndarray:
    """``output_len`` window positions spread over ``visible`` samples from
    ``start``: ``start + round(step * i)`` with ``step = visible /
    output_len`` in f64, rounded half away from zero like Rust's
    ``f64::round`` (``np.round`` would round half to even)."""
    step = visible / output_len
    return start + np.floor(step * np.arange(output_len, dtype=np.float64) + 0.5).astype(np.int64)


def take_fft(
    stream: Stream,
    slice_: tuple[int, int] | None,
    width: int,
    output_len: int,
    windowing: str = "blackman-harris",
    *,
    device: torch.device | str,
) -> FftResult:
    """Evenly spaced windowed STFT (reference ``src/ffts.rs:18-85``): the
    magnitudes of ``output_len`` windows of ``width`` samples across the
    visible span, optionally Blackman-Harris windowed, computed on the
    device through the Executor."""
    if slice_ is not None:
        start, end = slice_
    else:
        start, end = 0, stream.length - width

    if not end > start:
        raise ValueError(f"Invalid slice: end ({end}) must be greater than start ({start})")
    if not end < stream.length:
        raise ValueError(f"Slice end ({end}) exceeds sample length ({stream.length})")
    visible = end - start
    if not visible > output_len:
        raise ValueError(f"Visible samples ({visible}) must be greater than output length ({output_len})")
    offsets = take_fft_offsets(start, visible, output_len)

    window = None
    if windowing in ("blackman-harris", "blackmanharris"):
        window = torch.from_numpy(blackman_harris_window(width)).to(device)
    elif windowing != "rectangular":
        raise ValueError(f"unknown windowing: {windowing}")

    batch, batches = window_batches(offsets, width, root_step=root_step_of(stream))
    ex = Executor(stream, width, device, batch=batch, post=lambda x: stft_norms(x, window=window))
    rows: list[np.ndarray] = []
    for _, norms, valid in ex.run_each(batches):
        if not np.all(valid == width):
            raise RuntimeError("read-exact messed up in take_fft")
        rows.append(norms)
    return FftResult(norms=np.concatenate(rows, axis=0), fft_width=width)


# A near-constant score track (a CW-like template over its own carrier)
# makes every lag a rounding-noise "local max": find_pattern bounds its
# candidate list, so that a pathological search fails fast with guidance.
FIND_CANDIDATE_CAP = 1 << 20

# Per-dispatch lag budget for find_pattern, and the device candidate
# scan's top-k width (a dispatch with more candidates than this falls back
# to the full-score path).  Module-level so tests can shrink them.
FIND_DISPATCH_BUDGET = 1 << 22
FIND_TOPK = 1024


def _round_up_pow2(n: int) -> int:
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


@dataclass
class FindResult:
    """Matches from :func:`find_pattern`, sorted by offset."""

    offsets: np.ndarray  # int64 sample offsets into the searched stream
    scores: np.ndarray  # f32 normalized correlation in [0, 1]
    scales: np.ndarray  # f32 |match amplitude| relative to its template
    freqs: np.ndarray  # f64 carrier offset of each match (Hz; 0 without a grid)
    which: np.ndarray  # int64 index of the matching template (0 without a bank)
    pattern_len: int  # the longest template
    scanned: int  # stream samples scanned


def find_block(l: int, length: int, chunk: int | None = None, live: bool = False) -> int:
    """:func:`find_pattern`'s window (the FFT block) for a longest template
    of ``l`` samples over a stream of ``length``: a power of two, at least
    ``2*l``, and ``chunk`` unless the stream is shorter; on a live pipe
    ``chunk`` itself.

    The default ``chunk`` is the JAX package's ``max(4*l, 4096)``, measured
    on a TPU v5e, on every device: on an NVIDIA H100 80GB HBM3 at 700.00 W
    (``chip_smoke.py`` phase 5, the device's own time of a dispatch of 2^22
    samples of windows) the best block of 4096 to 65536 took 1.02-1.11x
    less time a lag than it, short of a reason to differ."""
    if chunk is None:
        chunk = max(4 * l, 4096)
    return _round_up_pow2(max(2 * l, chunk if live else min(chunk, length)))


def _too_many(cap: int, threshold: float, upto: int) -> ValueError:
    return ValueError(
        f"more than {cap} candidate peaks above threshold {threshold:g} in the "
        f"first {upto} samples: the pattern matches nearly everywhere — raise "
        "the threshold or use a more distinctive template"
    )


def find_pattern(
    stream: Stream,
    pattern,
    threshold: float = 0.5,
    chunk: int | None = None,
    max_matches: int | None = None,
    min_distance: int | None = None,
    freq_tol: float = 0.0,
    freq_step: float | None = None,
    mesh=None,
    *,
    device: torch.device | str,
) -> FindResult:
    """Find every occurrence of a complex ``pattern`` in ``stream`` by
    gain- and phase-invariant normalized cross-correlation
    (:mod:`quadrs_tpu_torch.ops.correlate`).  ``pattern`` may be a sequence
    of templates (a sync-word bank, lengths may differ): every lag keeps its
    best normalized row, and each match reports its template in ``which``.

    Windows of ``c = pow2(max(2*l_max, min(chunk, length)))`` samples step
    by ``c - l_max + 1`` (overlap-save: every lag is scored once); a
    streaming local-maximum scanner keeps candidates ``>= threshold`` and
    greedy non-maximum suppression within ``min_distance`` (default: the
    longest template) picks the matches.  ``chunk=None`` takes
    ``max(4*l_max, 4096)`` (:func:`find_block`).  Matches do not depend on
    the block.

    ``freq_tol`` (Hz) also searches a symmetric carrier-offset grid of step
    ``freq_step`` (default ``0.4 * rate / l``, at most 256 rows); each match
    reports its grid frequency in ``freqs``.

    Full batches whose last window fits run the device-side candidate scan
    (top-k candidates and boundary scalars come back, not the score rows);
    the ragged tail, and any dispatch whose candidate count overflows
    :data:`FIND_TOPK`, run the full-score path, and :class:`PeakScan`
    bridges the two exactly.  ``find_pattern.dispatches`` counts them:
    ``extract`` the dispatches the device scan decided, ``overflow`` those
    it gave back to the full-score path, ``full`` the full-score ones.
    ``mesh``: an optional Tx1 mesh
    (:func:`quadrs_tpu_torch.parallel.sharding.make_mesh`).  The capture's
    sample axis time-shards over it, each shard staged with its ``l-1``
    sample halo (:func:`~quadrs_tpu_torch.parallel.sharding.make_sharded_find_step`),
    over the same window partition as the single-device program, so
    offsets and ``which`` are exact and scores agree to f32 summation
    order; each shard's candidate scan runs on its device, as a
    single-device dispatch's does (a shard whose candidates overflow the
    top-k gives its full scores); the unaligned tail of the capture runs through the
    single-device path on ``device``, and the candidate scan bridges the
    two exactly.  It needs a raw capture stream."""
    from quadrs_tpu_torch.ops.correlate import PeakScan, make_xcorr_post, suppress

    pats = [np.asarray(q) for q in pattern] if isinstance(pattern, (list, tuple)) else [np.asarray(pattern)]
    lens = [len(q) for q in pats]
    l = max(lens)  # the common lag range uses the longest template
    if min(lens) < 2:
        raise ValueError("pattern must have at least 2 samples")
    if stream.length < l:  # a live pipe reads as a huge sentinel here
        raise ValueError(f"stream ({stream.length} samples) shorter than the pattern ({l})")
    if not 0.0 < threshold <= 1.0:
        raise ValueError("threshold must be in (0, 1]")
    if freq_tol < 0.0:
        raise ValueError("freq_tol must be >= 0")
    rate = stream.sample_rate
    if freq_tol > 0.0:
        step = 0.4 * rate / l if freq_step is None else float(freq_step)
        if step <= 0.0:
            raise ValueError("freq_step must be positive")
        n_side = int(np.ceil(freq_tol / step))
        if 2 * n_side + 1 > 256:
            raise ValueError(
                f"frequency grid of {2 * n_side + 1} rows (tol {freq_tol:g} "
                f"Hz / step {step:g} Hz) exceeds 256: raise freq_step or "
                "shift the stream closer first"
            )
        grid_hz = np.arange(-n_side, n_side + 1, dtype=np.float64) * step
        grid = grid_hz / rate  # cycles per sample for the ops
    else:
        grid_hz = np.zeros(1)
        grid = None
    live = bool(getattr(stream, "is_live", False)) and stream.length >= (1 << 59)
    c = find_block(l, stream.length, chunk, live)
    n_out = c - l + 1

    # one f32 threshold for both comparison sites: the device scan compares
    # in f32, the host's pending logic in f64
    threshold = float(np.float32(threshold))
    budget = max(c, FIND_DISPATCH_BUDGET)
    scan = PeakScan(threshold)
    cand_cap = FIND_CANDIDATE_CAP
    counts = find_pattern.dispatches

    def feed_batch(outs, offs, n_lags) -> None:
        (score, scale, ridx), valid = outs
        aux = np.stack([scale, ridx], axis=-1)
        last = 0
        for i in range(len(offs)):
            o, v = int(offs[i]), int(valid[i])
            m = min(max(0, v - l + 1), n_lags - o)
            scan.feed(o, score[i][:m], aux[i][:m])
            last = o + m
        if len(scan.offsets) > cand_cap:
            raise _too_many(cand_cap, threshold, last)

    if live:
        # a pipe's length is a sentinel until EOF: walk forward one window
        # batch at a time (the facade reads the pipe on demand and discards
        # behind), and when EOF surfaces mid-batch, run that batch again:
        # the first run planned its valid counts against the sentinel
        b = max(1, int(min(8, budget // c)))
        ex = Executor(stream, c, device, batch=b, post=make_xcorr_post(pats, c, grid))
        o = 0
        while True:
            offs = o + n_out * np.arange(b, dtype=np.int64)
            outs = ex.run(offs)  # advances the pipe; may find EOF
            counts["full"] += 1
            if stream.length < (1 << 59):  # the EOF position is known
                n_lags = stream.length - l + 1
                if n_lags < 1:
                    raise ValueError(f"stream ({stream.length} samples) shorter than the pattern ({l})")
                offs = offs[offs < n_lags]
                if len(offs):
                    feed_batch(ex.run(offs), offs, n_lags)
                    counts["full"] += 1
                break
            feed_batch(outs, offs, 1 << 60)
            o += b * n_out
    else:
        n_lags = stream.length - l + 1
        lag0 = 0
        if mesh is not None:
            # time-shard the aligned prefix over the mesh; the rest goes on
            # through the single-device path below (the candidate scan's
            # pending element bridges the two exactly)
            from quadrs_tpu_torch.ops.correlate import XCorr
            from quadrs_tpu_torch.parallel.sharding import make_sharded_find_step, shard_span
            from quadrs_tpu_torch.staging import Download

            if stream.root() is not stream or not getattr(stream, "has_staging", False):
                raise ValueError(
                    "find -mesh shards a raw capture's sample axis; "
                    "shift/lowpass the result instead, or drop -mesh "
                    "(chained stages shard via the stream runner)"
                )
            n_time = int(mesh.shape["time"])
            # windows a shard per dispatch: the fat-dispatch budget, cut to
            # what the capture holds (a short capture still runs on the mesh)
            avail = (stream.length - (l - 1)) // (n_time * n_out)
            b_shard = max(1, min(FIND_DISPATCH_BUDGET // (n_time * c), avail))
            step_lags = n_time * b_shard * n_out
            step = make_sharded_find_step(pats, c, stream.format, mesh, grid)
            n_loc = step_lags // n_time
            o = 0
            while o + step_lags + l - 1 <= stream.length:
                outs = step(shard_span(stream.stage(o, o + step_lags + l - 1), mesh, l - 1))[0]
                # each shard's candidate scan on its device, as a dispatch of
                # the single-device path: its left neighbour is the score
                # before it (the carried pending score for the first shard)
                lefts = [torch.tensor(scan.carry, dtype=torch.float32, device=outs[0][0].device)]
                lefts += [prev[0][-1].to(cur[0].device) for prev, cur in zip(outs, outs[1:])]
                found = Download(tuple(a for out, left in zip(outs, lefts)
                                       for a in XCorr.extract(*out, left, threshold, FIND_TOPK))).wait()
                for t, out in enumerate(outs):
                    if not scan.feed_extract(o + t * n_loc, n_loc, found[10 * t : 10 * t + 10]):
                        # more candidates than the top-k holds: this shard's
                        # full scores, fed as the full-score path feeds them
                        score, scale, ridx = Download(out).wait()
                        scan.feed(o + t * n_loc, score, np.stack([scale, ridx], axis=-1))
                    if len(scan.offsets) > cand_cap:
                        raise _too_many(cand_cap, threshold, o + (t + 1) * n_loc)
                o += step_lags
            lag0 = o
        offsets = np.arange(lag0, n_lags, n_out, dtype=np.int64)
        batch, batches = window_batches(offsets, c, budget=budget, root_step=root_step_of(stream))
        ex_x = Executor(
            stream, c, device, batch=batch,
            post=make_xcorr_post(pats, c, grid, extract=(threshold, FIND_TOPK)),
            post_takes_aux=True,
        )
        ex_full = None
        for offs in batches:
            if len(offs) == batch and int(offs[-1]) + c <= stream.length:
                res, _ = ex_x.run(offs, aux=scan.carry)
                if scan.feed_extract(int(offs[0]), len(offs) * n_out, res):
                    counts["extract"] += 1
                    if len(scan.offsets) > cand_cap:
                        raise _too_many(cand_cap, threshold, int(offs[-1]) + n_out)
                    continue
                counts["overflow"] += 1
            if ex_full is None:
                ex_full = Executor(stream, c, device, batch=batch, post=make_xcorr_post(pats, c, grid))
            feed_batch(ex_full.run(offs), offs, n_lags)
            counts["full"] += 1
    scan.finish()

    cand_off = np.asarray(scan.offsets, dtype=np.int64)
    cand_score = np.asarray(scan.scores, dtype=np.float32)
    cand_aux = np.asarray(scan.aux, dtype=np.float64) if scan.aux else np.zeros((0, 2))
    keep = suppress(cand_off, cand_score, min_distance if min_distance is not None else l, max_matches)
    ridx = cand_aux[keep, 1].astype(np.int64)  # pattern_index * F + f_index
    return FindResult(
        offsets=cand_off[keep],
        scores=cand_score[keep],
        scales=cand_aux[keep, 0].astype(np.float32),
        freqs=grid_hz[ridx % len(grid_hz)],
        which=ridx // len(grid_hz),
        pattern_len=l,
        scanned=stream.length,
    )


find_pattern.dispatches = {"extract": 0, "overflow": 0, "full": 0}


@dataclass
class CaptureInfo:
    """Per-capture statistics from :func:`capture_info` (the ``info``
    command): decoded-domain signal stats about the format's neutral
    value, plus raw-code clipping counts."""

    format: FileFormat
    sample_rate: int
    samples: int
    bytes: int
    seconds: float
    analyzed: int  # samples the stats below actually cover
    dc: complex  # mean deviation from the format's neutral value
    rms: float  # sqrt(E |x - neutral|^2)
    peak: float  # max |x - neutral|
    rho: complex  # circularity ratio E[z^2]/E[|z|^2] of z = x - mean(x)
    clipped: float | None  # fraction of raw components at a rail (int formats)


_RAILS = {
    FileFormat.COMPLEX_INT8: (-128, 127),
    FileFormat.COMPLEX_UINT8: (0, 255),
    FileFormat.COMPLEX_INT16: (-32768, 32767),
}

# decode of each format's idle code (the centre of its decoded range): the
# reference's cu8/cs16 formulas park the signal near -127 / -32767.5
# (src/lib.rs:250-253), so meaningful DC and RMS statistics subtract this
# neutral value first.  cs8/cs16 idle at code 0, cu8 at 127.5 (an idle rtl
# dongle dithers 127/128).
_NEUTRAL = {
    FileFormat.COMPLEX_FLOAT32: 0.0,
    FileFormat.COMPLEX_INT8: 0.0,  # decode(0)
    FileFormat.COMPLEX_UINT8: 127.5 / 255.0 - 127.5,  # decode(127.5) = -127.0
    FileFormat.COMPLEX_INT16: -32767.5,  # decode(0)
}


def _info_reduce(planes: torch.Tensor, fmt: FileFormat) -> tuple[torch.Tensor, torch.Tensor | None]:
    """One chunk's f32 reductions on its device: (sum re, sum im, sum p,
    max p, centred power, Re and Im of the centred unconjugated square),
    and the count of raw components at a rail (None for cf32)."""
    # decode about the neutral value, the two constants folded into one as
    # XLA folds the JAX package's (x / d - c) - neutral: a ripple of a few
    # cs16 codes then reads at its true scale
    re, im = decode_plane(planes, fmt, about=_NEUTRAL[fmt])
    p = re * re + im * im
    # second moments about the chunk's own mean (the host recombines them
    # exactly by the parallel-variance identity): E[x^2] - mu^2 cancels to
    # f32 rounding noise on a capture that is mostly DC
    cre = re - re.mean()
    cim = im - im.mean()
    sums = torch.stack([
        re.sum(), im.sum(), p.sum(), p.max().clamp_min(0.0),
        (cre * cre + cim * cim).sum(), (cre * cre - cim * cim).sum(), (2.0 * cre * cim).sum(),
    ])
    rails = _RAILS.get(fmt)
    if rails is None:
        return sums, None
    # an integer count stays exact past 2^24 components a chunk
    return sums, ((planes == rails[0]) | (planes == rails[1])).sum()


def capture_info(
    source, chunk: int = 1 << 22, limit: int | None = None, *, device: torch.device | str
) -> CaptureInfo:
    """Analyze a capture (the ``info`` command): DC offset, RMS, peak,
    circularity ratio (the IQ-imbalance indicator) and raw-code clipping
    fraction, reduced on ``device`` chunk by chunk (f32 per-chunk
    reductions, f64 recombination on the host), so a multi-GB file costs
    one pass of native-dtype staging."""
    if chunk < 1:
        raise ValueError("chunk must be at least 1")
    device = torch.device(device)
    fmt = source.format
    rails = _RAILS.get(fmt)

    total = source.length if limit is None else min(limit, source.length)
    slot = torch.empty(2 * min(chunk, max(total, 1)), dtype=fmt.torch_dtype, pin_memory=device.type == "cuda")
    acc = np.zeros(3, dtype=np.float64)  # sum re, sum im, sum p
    chunks: list[tuple[int, complex, float, complex]] = []  # per-chunk moments
    max_p = 0.0
    clips = 0.0
    off = 0
    while off < total:
        n_k = min(chunk, total - off)
        host = slot[: 2 * n_k].view(2, n_k)
        source.stage(off, off + n_k, out=host.numpy())
        sums, clip = _info_reduce(host.to(device, non_blocking=True), fmt)
        # fetching the sums waits for the chunk: the slot is free again
        parts = [float(v) for v in sums.cpu()]
        acc += parts[:3]
        max_p = max(max_p, parts[3])
        mu_k = complex(parts[0] / n_k, parts[1] / n_k)
        chunks.append((n_k, mu_k, parts[4], complex(parts[5], parts[6])))
        if rails is not None:
            clips += float(clip)
        off += n_k
    n = max(1, total)
    mu = complex(acc[0] / n, acc[1] / n)
    # combine the chunk-centred second moments about the global mean (exact
    # identity: sum|x-mu|^2 = sum|x-mu_k|^2 + n_k|mu_k-mu|^2, and likewise
    # for the unconjugated square): circularity is about the mean, because
    # a DC offset is not an IQ image
    s_pc = sum(cp + n_k * abs(mu_k - mu) ** 2 for n_k, mu_k, cp, _ in chunks)
    s_z2 = sum(cz + n_k * (mu_k - mu) ** 2 for n_k, mu_k, _, cz in chunks)
    rms = float(np.sqrt(acc[2] / n))
    # a (near-)constant capture has no AC power to be circular about: its
    # centred sums are f32 rounding noise, so report no image below ~100
    # ulp of the signal scale; |rho| <= 1 mathematically, so clamp what
    # rounding leaves
    if np.sqrt(s_pc / n) < 1e-5 * (abs(mu) + rms + 1e-30):
        rho = 0j
    else:
        rho = s_z2 / s_pc
        if abs(rho) > 1.0:
            rho /= abs(rho)
    return CaptureInfo(
        format=fmt,
        sample_rate=source.sample_rate,
        samples=source.length,
        bytes=source.length * fmt.pair_bytes,
        seconds=source.length / source.sample_rate,
        analyzed=total,
        dc=mu,
        rms=rms,
        peak=float(np.sqrt(max_p)),
        rho=rho,
        clipped=None if rails is None else clips / (2.0 * n),
    )
