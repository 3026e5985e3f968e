"""Sustained streaming: capture files or live pipes -> device programs
-> spectrograms.

:class:`StreamRunner` processes one capture as one continuous stream:
each chunk carries the FIR's lookahead past its end (so the filter sees
the true continuation) and runs through the receiver model on the
runner's device, by one of two routes: the fused frontend
(``PipelineModel.step_stream_fused``) or the chain of torch ops
(``PipelineModel.step_stream``).  Every chunk's NCO phase is planned
exactly on the host from its absolute offset, so chunking is invisible
in the output.

:class:`WaterfallRunner` streams a bank of equal-length captures (or one
live pipe) through the waterfall model, a whole number of window starts
per chunk.

Either runner takes a ``(stream, time)`` device mesh
(:mod:`quadrs_tpu_torch.parallel.sharding`): each chunk's sample axis
shards over the mesh's ``time`` devices, each shard staged with the halo
its last windows read, and a bank's sources over its ``stream`` rows.

Both stage through :mod:`quadrs_tpu_torch.staging`: a staging thread
fills page-locked slots (a file through the C++ loader's ring
prefetcher, which re-reads the lookahead in C; a bank file by file
straight into its row of one slot; a pipe by carrying the lookahead on
the host), the slot crosses on a copy stream, and each chunk's output
comes back through page-locked memory while the next chunk computes.

:func:`burst_spans` and :class:`BurstGate` segment per-window activity
into bursts for ``stream -trigger``.
"""

from __future__ import annotations

import collections
import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Callable, Iterator

import numpy as np
import torch

from quadrs_tpu_torch.models.receiver import PipelineModel
from quadrs_tpu_torch.models.waterfall import WaterfallModel
from quadrs_tpu_torch.ops.waterfall import scan_of
from quadrs_tpu_torch.parallel.sharding import (
    FRONTENDS,
    halo_samples,
    join,
    make_sharded_stream_step,
    make_sharded_waterfall_step,
    shard_bases,
    waterfall_halo,
)
from quadrs_tpu_torch.sources import LivePipeStream, SampleSource
from quadrs_tpu_torch.staging import Download, RingClosed, RingSet, UploadRing


@dataclass
class RunStats:
    samples_in: int = 0
    windows_out: int = 0
    seconds: float = 0.0

    @property
    def msps(self) -> float:
        return self.samples_in / self.seconds / 1e6 if self.seconds else 0.0


@dataclass
class ScanResult:
    """Per-bin power statistics over every window of a scan run, the
    rtl_power-style band survey.  Bins are fftshifted (bin ``width//2``
    is DC).

    Per-chunk sums, maxima and counts reduce on the device (f32) and
    accumulate across chunks on the host in f64/int64, so the error is
    bounded by the windows of one chunk, not the capture length."""

    sum_norms: np.ndarray  # (S, width) f64: sum of norms over valid windows
    max_norms: np.ndarray  # (S, width) f32: max norm over valid windows
    above: np.ndarray  # (S, width) int64: windows with norm > threshold
    windows: int  # valid windows per stream
    threshold: float
    stats: RunStats

    @property
    def avg(self) -> np.ndarray:
        """(S, width) f64 mean norm per bin (zeros when no windows)."""
        return self.sum_norms / max(self.windows, 1)

    @property
    def occupancy(self) -> np.ndarray:
        """(S, width) f64 fraction of windows with norm > threshold."""
        return self.above / max(self.windows, 1)


class _ScanTotals:
    """Host accumulation of per-chunk (sum, max, count) device stats."""

    def __init__(self, n_streams: int, width: int):
        self.sum = np.zeros((n_streams, width), np.float64)
        self.max = np.full((n_streams, width), -np.inf, np.float32)
        self.above = np.zeros((n_streams, width), np.int64)

    def add(self, _w0: int, out: tuple[np.ndarray, np.ndarray, np.ndarray]) -> None:
        """The runners' emit callback for one chunk's (sum, max, count)."""
        s, mx, above = out
        self.sum += s.astype(np.float64)
        np.maximum(self.max, mx, out=self.max)
        self.above += above.astype(np.int64)

    def result(self, threshold: float, stats: RunStats, windows: int) -> ScanResult:
        if windows == 0:
            self.max.fill(0.0)
        return ScanResult(self.sum, self.max, self.above, windows, float(threshold), stats)


def burst_spans(active, pre: int = 0, post: int = 0) -> list[tuple[int, int]]:
    """Contiguous True runs of a per-window activity mask, each widened by
    ``pre``/``post`` context windows and merged where the widened spans
    touch: the burst segmentation behind ``stream -trigger``.  Returns
    ``[(first_window, last_window)]``, inclusive."""
    spans: list[tuple[int, int]] = []
    n = len(active)
    i = 0
    while i < n:
        if not active[i]:
            i += 1
            continue
        j = i
        while j + 1 < n and active[j + 1]:
            j += 1
        lo, hi = max(0, i - pre), min(n - 1, j + post)
        if spans and lo <= spans[-1][1] + 1:
            spans[-1] = (spans[-1][0], hi)
        else:
            spans.append((lo, hi))
        i = j + 1
    return spans


class BurstGate:
    """Incremental mirror of :func:`burst_spans` for live input: feed
    per-window activity in stream order; a widened span comes back as soon
    as no future window can merge into it (an active window at ``w``
    reaches back to ``w - pre``, so a pending span ``(lo, hi)`` is final
    once the cursor passes ``hi + pre + 1``).  ``finish(n)`` closes the
    tail with :func:`burst_spans`'s end-clipping.  Feeding any mask in
    pieces yields exactly ``burst_spans`` of the whole."""

    def __init__(self, pre: int = 0, post: int = 0):
        self.pre, self.post = int(pre), int(post)
        self._w = 0  # next window index to consume
        self._run_start: int | None = None  # open raw run's first index
        self._pending: tuple[int, int] | None = None  # widened, mergeable
        self._closed: list[tuple[int, int]] = []

    def _close_run(self, i: int, j: int) -> None:
        lo, hi = max(0, i - self.pre), j + self.post
        if self._pending is not None and lo <= self._pending[1] + 1:
            self._pending = (self._pending[0], hi)
        else:
            if self._pending is not None:
                self._closed.append(self._pending)
            self._pending = (lo, hi)

    def feed(self, active) -> list[tuple[int, int]]:
        """Consume the next window-activity values; returns the spans that
        became final (widened, inclusive, in order)."""
        active = np.asarray(active, dtype=bool)
        if len(active) == 0:
            return []
        w0 = self._w
        if self._run_start is not None and not active[0]:
            # the run ended exactly at the previous feed's last window
            self._close_run(self._run_start, w0 - 1)
            self._run_start = None
        elif active[0] and self._run_start is None:
            self._run_start = w0
        for e in np.flatnonzero(np.diff(active.astype(np.int8))):
            if active[e]:  # True -> False: a run ends at w0 + e
                self._close_run(self._run_start, w0 + int(e))
                self._run_start = None
            else:  # False -> True: a run starts at w0 + e + 1
                self._run_start = w0 + int(e) + 1
        self._w = w0 + len(active)
        # spans in _closed were superseded by a later run that did not
        # merge: final.  The pending span is final once the cursor passes
        # hi + pre + 1 with no open run left to merge into it.
        out = list(self._closed)
        self._closed.clear()
        if self._run_start is None and self._pending is not None and self._w > self._pending[1] + self.pre + 1:
            out.append(self._pending)
            self._pending = None
        return out

    def finish(self, n: int | None = None) -> list[tuple[int, int]]:
        """Close the stream after ``n`` total windows (defaults to the fed
        count): flush the open run and clip the final span's end like
        :func:`burst_spans`."""
        n = self._w if n is None else int(n)
        if self._run_start is not None:
            self._close_run(self._run_start, self._w - 1)
            self._run_start = None
        out = list(self._closed)
        self._closed.clear()
        if self._pending is not None:
            out.append(self._pending)
            self._pending = None
        return [(lo, min(hi, n - 1)) for lo, hi in out]

    def earliest_needed(self) -> int:
        """The smallest window index a future or unresolved span might
        still reference: everything below can be pruned."""
        cands = [self._w - self.pre]
        if self._pending is not None:
            cands.append(self._pending[0])
        if self._closed:
            cands.append(self._closed[0][0])
        if self._run_start is not None:
            cands.append(max(0, self._run_start - self.pre))
        return max(0, min(cands))


def _background(gen, depth: int = 2):
    """Run a generator on a daemon thread, yielding its items through a
    bounded queue: staging (file reads, copies into slots) overlaps the
    consumer's device work.  If the consumer abandons the generator, the
    producer notices (stop event) and closes its generator; producer
    exceptions surface in the consumer."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    _DONE = object()
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def fill():
        try:
            for item in gen:
                if not put(item):
                    return
            put(_DONE)
        except RingClosed:
            pass  # the consumer closed the ring: it is gone
        except BaseException as e:  # surface staging errors to the consumer
            put(e)
        finally:
            gen.close()  # stops a loader's prefetcher with its generator

    t = threading.Thread(target=fill, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is _DONE:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        while not q.empty():
            q.get_nowait()
        # the producer sees the stop within its put timeout; a reader blocked
        # on a silent pipe is left to its daemon thread
        t.join(timeout=2.0)


def _check_pipe_sources(sources) -> None:
    """Pipe sources are sequential-only: one per runner, never part of a
    bank."""
    if any(getattr(s, "is_pipe", False) for s in sources) and len(sources) != 1:
        raise ValueError("a pipe source cannot be part of a bank")


def _pipelined(ring, staged, step, emit, devices, max_chunks: int | None) -> None:
    """The runners' consumer loop.  ``staged`` yields ``(slot, first
    window, shapes, account)`` for slots the staging thread has filled;
    each slot is uploaded, ``step(first window, buffers)`` launches its
    work, its output starts back to the host, and only then is the
    previous chunk's output awaited and handed to ``emit``: a chunk's
    ``emit`` runs while the next one computes.  ``account()`` runs as the
    chunk is launched.  ``max_chunks`` stops after that many.  ``ring``:
    an :class:`UploadRing`, or a :class:`RingSet` of a mesh's shards;
    ``devices``: the devices the work runs on."""
    chunks = _background(staged)
    pending = None
    done = 0
    try:
        for k, w0, shapes, account in chunks:
            out = step(w0, ring.upload(k, **shapes))
            ring.consumed(k)
            account()
            result = (w0, Download(out)) if emit is not None else None
            if pending is not None:
                emit(pending[0], pending[1].wait())
            pending = result
            ring.recycle(k)
            done += 1
            if max_chunks is not None and done >= max_chunks:
                break  # before pulling (and staging) the next chunk
        if pending is not None:
            emit(pending[0], pending[1].wait())
    finally:
        ring.close()
        chunks.close()
    for device in devices:
        if device.type == "cuda":
            # this run's streams, not the devices: the serve daemon's other
            # sessions run on streams of their own
            torch.cuda.current_stream(device).synchronize()


def _stack_streams(mode: str, outs: list):
    """Per-stream outputs of one chunk (each in a single stream's layout)
    as the bank's: norms and peaks stacked on a leading stream axis, scan
    statistics (already (1, width)) concatenated on it."""
    if mode == "scan":
        return tuple(np.concatenate(parts, axis=0) for parts in zip(*outs))
    if mode == "search":
        return tuple(np.stack(parts) for parts in zip(*outs))
    return np.stack(outs)


def _shard_stats(outs, threshold, n_valid=None):
    """Each shard's scan statistics (``scan_of`` over its norms, its first
    ``n_valid(t)`` windows where given) joined on the first shard's
    device: sum, max and count, each (n_rows * n_time, S_l, W) in (row,
    time) order."""
    return join([[tuple(a[None] for a in scan_of(out, threshold, None if n_valid is None else n_valid(t)))
                  for t, out in enumerate(row)] for row in outs])


def _join_scan(stats, n_rows: int, n_time: int):
    """:func:`_shard_stats` on the host as the chunk's (S, W) sum in f64,
    max and count: each stream's shards summed over time."""
    total, peak, count = (a.reshape(n_rows, n_time, *a.shape[1:]) for a in stats)
    width = total.shape[-1]
    return (total.astype(np.float64).sum(axis=1).reshape(-1, width), peak.max(axis=1).reshape(-1, width),
            count.astype(np.int64).sum(axis=1).reshape(-1, width))


class StreamRunner:
    """Drive one capture (or a bank of them over a mesh) through the
    receiver chain on ``device``.

    ``source``: a :class:`~quadrs_tpu_torch.sources.SampleSource` (a file
    reads through the loader's ring prefetcher, a byte buffer through
    ``stage``) or a :class:`~quadrs_tpu_torch.sources.PipeSource`; or a
    sequence of sources of equal length and format, a bank, which needs a
    mesh with one ``stream`` row a source.  ``chunk_samples`` is rounded
    down to a whole number of STFT windows.  ``on_windows(first_window_index,
    norms)`` receives (windows, fft_width) f32 rows per chunk of one
    source, (n_stream, windows, fft_width) of a bank.

    ``frontend``: ``auto`` (what the CLI uses) takes the fused frontend
    inside its envelope and the chain of torch ops outside it (decimate
    above 64, or more than 128 subfilters).  ``fused`` and ``chain``
    force one route, as the JAX runner's knob does, so that tests can
    hold the two routes against each other; ``fused`` outside the
    envelope is refused.

    ``mesh``: a ``(stream, time)`` mesh
    (:func:`quadrs_tpu_torch.parallel.sharding.make_mesh`).  Each chunk's
    time axis is sharded over the mesh's ``time`` devices, each shard
    staged with its halo (the true continuation for the last), so every
    window is exact and chunks advance by their full length; the ragged
    tail runs on ``device``, stream by stream.  A pipe is wrapped in a
    :class:`~quadrs_tpu_torch.sources.LivePipeStream`, whose forward reads
    serve the sharded staging.
    """

    def __init__(
        self,
        source,
        model: PipelineModel,
        device: torch.device | str,
        chunk_samples: int = 1 << 22,
        frontend: str = "auto",
        mesh=None,
    ):
        sources = list(source) if isinstance(source, (list, tuple)) else [source]
        for src in sources:
            if src.format is not model.cfg.fmt:
                raise ValueError(f"source format {src.format} != model format {model.cfg.fmt}")
        if frontend not in FRONTENDS:
            raise ValueError(f"frontend must be one of {FRONTENDS}, got {frontend!r}")
        if frontend == "fused" and not model.fused_supported():
            raise ValueError(
                f"decimate {model.cfg.decimate} with {model.cfg.taps} taps is outside the fused "
                "frontend's envelope: use frontend='chain' or 'auto'"
            )
        _check_pipe_sources(sources)
        if mesh is not None and getattr(sources[0], "is_pipe", False):
            # a live pipe shards over time: the sharded staging reads
            # strictly forward, which the sliding facade serves; EOF turns
            # its sentinel length real and the ragged tail runs as on files
            sources = [LivePipeStream(sources[0])]
        if len({src.length for src in sources}) != 1:
            raise ValueError("bank sources must have equal lengths")
        self.fused = frontend == "fused" or (frontend == "auto" and model.fused_supported())
        cfg = model.cfg
        self.sources = sources
        self.source = sources[0]
        self.device = torch.device(device)
        self.model = model.to(self.device)
        self.mesh = mesh
        self._win_raw = cfg.decimate * cfg.fft_width
        # lookahead: the last FIR output of a chunk reads ceil(taps/2) +
        # taps past its decimation point (group delay), and the window
        # reshape floor-drops the few extra decimated outputs
        self._lookahead = cfg.taps + (cfg.taps - cfg.taps // 2)
        if cfg.taps // 2 // cfg.decimate >= cfg.fft_width:
            raise ValueError("fft window shorter than the FIR group delay span")
        quantum = self._win_raw
        if mesh is not None:
            if mesh.shape["stream"] != len(sources):
                raise ValueError(f"mesh has {mesh.shape['stream']} stream shards for {len(sources)} sources")
            self._halo = halo_samples(cfg)
            # each time shard's slice must cover the halo it reads past it
            quantum = mesh.shape["time"] * -(-self._halo // self._win_raw) * self._win_raw
        elif len(sources) != 1:
            raise ValueError("a source bank needs a mesh with a 'stream' axis")
        self.chunk_samples = max(quantum, chunk_samples // quantum * quantum)
        self._ring: UploadRing | None = None
        self._shard_rings: RingSet | None = None

    def _chunks(self, start_off: int = 0, out=None, source=None) -> Iterator[tuple[int, np.ndarray, int]]:
        """(offset, (2, chunk+lookahead) planes, real samples) per chunk of
        ``source`` (by default the runner's), staged with ``source.stage``.
        ``out``: a callable giving the array each chunk is staged into (a
        slot); by default a new one."""
        source = self.source if source is None else source
        la = self._lookahead
        length = source.length
        off = start_off
        while off < length - self.model.cfg.taps:
            n = min(self.chunk_samples, (length - off) // self._win_raw * self._win_raw)
            if n <= 0:
                return
            if out is None:
                planes = source.stage(off, off + n + la)
                valid = planes.shape[1]
                if valid < n + la:
                    # raw zero bytes decode to nonzero values for cu8/cs16,
                    # so the model masks [valid:] in the decoded domain
                    planes = np.pad(planes, ((0, 0), (0, n + la - valid)))
            else:
                buf = out()
                valid = source.stage(off, off + n + la, out=buf).shape[1]
                planes = buf[:, : n + la]
                planes[:, valid:] = 0  # a reused slot holds an earlier chunk's bytes
            yield off, planes, valid
            off += n

    def _chunks_native(self, start_off: int, out, source=None) -> Iterator[tuple[int, np.ndarray, int]]:
        """Chunks through the loader's ring prefetcher: its reader threads
        pread and deinterleave upcoming chunks while the current one
        computes, each delivered into the array ``out()`` gives (a slot),
        the lookahead re-read in C.  The same ``(off, planes, valid)``
        triples as :meth:`_chunks`."""
        source = self.source if source is None else source
        la = self._lookahead
        length = source.length
        slots: collections.deque[np.ndarray] = collections.deque()  # lent to the loader, in stream order

        def lend():
            slots.append(out())
            return slots[-1]

        # the loader holds two slots while a third is on its way to the device
        it = source.native.prefetch(self.chunk_samples, n_buffers=3, start_off=start_off, overlap=la, out=lend)
        try:
            for off, full in it:
                slot = slots.popleft()
                if off >= length - self.model.cfg.taps:
                    return
                n = min(self.chunk_samples, (length - off) // self._win_raw * self._win_raw)
                if n <= 0:
                    return
                valid = min(full.shape[1], n + la)
                planes = slot[:, : n + la]
                planes[:, valid:] = 0  # a reused slot holds an earlier chunk's bytes
                yield off, planes, int(valid)
        finally:
            it.close()

    def _chunks_pipe(self, start_off: int = 0) -> Iterator[tuple[int, np.ndarray, int]]:
        """Sequential chunks from a :class:`~quadrs_tpu_torch.sources.PipeSource`:
        the same ``(off, planes, valid)`` triples and tail and window-floor
        semantics as :meth:`_chunks`, with the effective capture length
        discovered at EOF.  The lookahead is carried between chunks on the
        host (a pipe cannot re-read), and a nonzero ``start_off`` drains
        the skipped samples (a pipe cannot seek); resume phases stay exact
        because offsets are absolute."""
        la = self._lookahead
        src = self.source
        taps = self.model.cfg.taps
        win = self._win_raw
        off = 0
        while off < start_off:
            m = src.read_planes(min(self.chunk_samples, start_off - off)).shape[1]
            if m == 0:
                return
            off += m
        buf = None
        while True:
            need = self.chunk_samples + la - (0 if buf is None else buf.shape[1])
            if need > 0:
                new = src.read_planes(need)
                buf = new if buf is None else np.concatenate([buf, new], axis=1)
            avail = buf.shape[1]
            if avail == self.chunk_samples + la and not src.eof:
                n = self.chunk_samples
                yield off, buf, n + la
                buf = buf[:, n:]
                off += n
                continue
            # EOF: the stream's effective length is known now; mirror
            # _chunks' end-of-capture math (floor to whole windows, pad
            # the staged tail, stop inside the final taps span)
            length = off + avail
            while off < length - taps:
                n = min(self.chunk_samples, (length - off) // win * win)
                if n <= 0:
                    break
                planes = buf[:, : n + la]
                valid = planes.shape[1]
                if valid < n + la:
                    planes = np.pad(planes, ((0, 0), (0, n + la - valid)))
                yield off, planes, valid
                buf = buf[:, n:]
                off += n
            return

    def _slot_buffers(self) -> dict[str, tuple[int, torch.dtype]]:
        """The ring's buffers: a full chunk's planes and, on the fused
        route, its per-tile NCO bases (a few KB)."""
        width = self.chunk_samples + self._lookahead
        buffers = {"planes": (2 * width, self.model.cfg.fmt.torch_dtype)}
        if self.fused:
            bases = self.model.stream_bases(0, width)
            buffers["bases"] = (bases.size, torch.from_numpy(bases).dtype)
        return buffers

    def _staged(self, ring: UploadRing, start_off: int, account, source=None):
        """The staging thread's generator: fill a free slot with each
        chunk of ``source`` (by default the runner's; and, on the fused
        route, its NCO bases, planned here from the chunk's absolute
        offset) and yield what :func:`_pipelined` takes."""
        source = self.source if source is None else source
        width = self.chunk_samples + self._lookahead
        pipe = getattr(source, "is_pipe", False)
        taken: collections.deque[int] = collections.deque()  # slots handed out, in stream order

        def slot():
            taken.append(ring.take())
            return ring.host(taken[-1], "planes", (2, width))

        if pipe:
            chunks = self._chunks_pipe(start_off)
        elif getattr(source, "native", None) is not None:
            chunks = self._chunks_native(start_off, slot, source)
        else:
            chunks = self._chunks(start_off, slot, source)
        try:
            for off, planes, valid in chunks:
                cols = planes.shape[1]
                if pipe:
                    slot()[:, :cols] = planes
                k = taken.popleft()
                shapes = {"planes": (2, width)}
                if self.fused:
                    bases = self.model.stream_bases(off, cols)
                    ring.host(k, "bases", bases.shape)[...] = bases
                    shapes["bases"] = bases.shape
                yield k, (off, cols, valid), shapes, lambda cols=cols: account(cols)
        finally:
            chunks.close()

    def run(
        self,
        on_windows: Callable[[int, np.ndarray], None] | None = None,
        start_window: int = 0,
        max_chunks: int | None = None,
    ) -> RunStats:
        """Process the capture from ``start_window`` onward; resuming is
        exact, since NCO phases are planned from absolute offsets.
        ``max_chunks`` stops after that many chunks (on a mesh, before the
        ragged tail); to resume later, pass ``start_window + windows_out //
        n_stream``."""
        return self._run("norms", on_windows, start_window, max_chunks)

    def run_search(
        self,
        on_peaks: Callable[[int, tuple], None] | None = None,
        start_window: int = 0,
        max_chunks: int | None = None,
    ) -> RunStats:
        """Like :meth:`run` but through the per-window peak reduction:
        ``on_peaks(first_window_index, (idx, val))`` receives per chunk
        the (windows,) int32 fftshifted peak bins and f32 magnitudes —
        ``argmax``/``max`` over :meth:`run`'s rows ((n_stream, windows)
        each for a bank).  On a mesh each shard reduces its own windows."""
        return self._run("search", on_peaks, start_window, max_chunks)

    def run_scan(
        self,
        threshold: float = 0.0,
        start_window: int = 0,
        max_chunks: int | None = None,
    ) -> ScanResult:
        """Band survey of the decimated channel: per fftshifted bin, the
        average and maximum window power and the count of windows above
        ``threshold``.  Each chunk's norms reduce on the device (each
        shard's on its own, on a mesh); only ``3 * width`` values per
        chunk and shard cross to the host.  Bin ``width//2`` is the
        channel centre, the frequency at minus the shift."""
        n_s = len(self.sources)
        totals = _ScanTotals(n_s, self.model.cfg.fft_width)
        stats = self._run("scan", totals.add, start_window, max_chunks, threshold)
        return totals.result(threshold, stats, stats.windows_out // n_s)

    def _step(self, mode: str, off: int, raw: torch.Tensor, head, valid: int, threshold: float):
        """One chunk through the runner's route: its ``norms``, its
        per-window peaks (``search``) or its survey stats (``scan``).
        ``raw``: the chunk's planes on the device; ``head``: its per-tile
        bases there (the fused route) or None (the chain plans its
        first-sample phase here)."""
        model = self.model
        nv = None if valid == raw.shape[1] else int(valid)
        if self.fused:
            norms_of, search_of = model.step_stream_fused, model.step_stream_fused_search
        else:
            head = model.theta0(np.asarray([off]))[0]  # the chunk's first-sample phase
            norms_of, search_of = model.step_stream, model.step_stream_search
        if mode == "search":
            return search_of(raw, head, nv)
        norms = norms_of(raw, head, nv)
        if mode == "norms":
            return norms
        return scan_of(norms[None], threshold)

    def _run(self, mode: str, emit, start_window: int, max_chunks, threshold: float = 0.0) -> RunStats:
        """Drive the chunks through the device programs; ``emit`` receives
        each chunk's output on the host."""
        stats = RunStats()
        t0 = time.perf_counter()
        start_off = start_window * self._win_raw
        if self.mesh is None:
            self._run_single(mode, emit, self.source, start_off, max_chunks, threshold, stats)
        else:
            self._run_sharded(mode, emit, start_off, max_chunks, threshold, stats)
        stats.seconds = time.perf_counter() - t0
        return stats

    def _run_single(self, mode: str, emit, source, start_off: int, max_chunks, threshold: float,
                    stats: RunStats) -> None:
        """``source`` from ``start_off`` through :meth:`_step` on the
        runner's device, chunk by chunk through its ring."""
        cfg = self.model.cfg
        if self._ring is None:
            self._ring = UploadRing(self.device, 4, **self._slot_buffers())
        ring = self._ring
        ring.reset()

        def account(cols: int) -> None:
            stats.samples_in += cols - self._lookahead
            stats.windows_out += (cols - cfg.taps) // cfg.decimate // cfg.fft_width

        def step(at, bufs):
            off, cols, valid = at
            return self._step(mode, off, bufs["planes"][:, :cols], bufs.get("bases"), valid, threshold)

        def emit_at(at, out):
            emit(at[0] // self._win_raw, out)

        _pipelined(ring, self._staged(ring, start_off, account, source), step,
                   None if emit is None else emit_at, [self.device], max_chunks)

    def _run_sharded(self, mode: str, emit, start_off: int, max_chunks, threshold: float, stats: RunStats) -> None:
        """Time-sharded chunks over the mesh, then the ragged tail.

        The staging thread stages each shard's block (its slice and its
        halo: the next ``halo`` samples of the stream) straight from the
        source into the shard's ring, with its NCO bases on the fused
        route, planned from the shard's absolute offset; every shard runs
        the single-device route on its device's current stream, and the
        shards' outputs are joined on the first shard's device and come
        back to the host as one.
        Chunks run while a whole chunk and its continuation lie inside
        the capture; the rest (where the continuation would cross EOF)
        runs single-device on the runner's device, stream by stream and
        emitted in lockstep.  A ``max_chunks``-bounded run stops before
        the tail."""
        model, mesh = self.model, self.mesh
        n_time, n_stream = mesh.shape["time"], mesh.shape["stream"]
        n = self.chunk_samples
        n_local = n // n_time
        halo = self._halo
        cols = n_local + halo
        step = make_sharded_stream_step(model, mesh, search=mode == "search",
                                        frontend="fused" if self.fused else "chain")
        shards = [(s, t) for s in range(n_stream) for t in range(n_time)]
        n_bases = model.stream_bases(0, cols).size if self.fused else 0
        if self._shard_rings is None:
            buffers = {"planes": (2 * cols, model.cfg.fmt.torch_dtype)}
            if self.fused:
                buffers["bases"] = (n_bases, torch.float32)
            self._shard_rings = RingSet([mesh.devices[s][t] for s, t in shards], 4, **buffers)
        rings = self._shard_rings
        rings.reset()
        live = getattr(self.source, "is_live", False)
        shapes = {"planes": (2, cols)}
        if self.fused:
            shapes["bases"] = (n_bases,)
        done = [0]

        def account() -> None:
            stats.samples_in += n * n_stream
            stats.windows_out += n_stream * (n // self._win_raw)
            done[0] += 1

        def staged():
            off = start_off
            count = 0
            with ThreadPoolExecutor(min(4, len(shards))) as pool:
                while max_chunks is None or count < max_chunks:
                    if live:
                        # one forward read a chunk; a short one is EOF (the
                        # facade's sentinel length turns real), and what it
                        # read feeds the ragged tail
                        buf = self.source.stage(off, off + n + halo)
                        if buf.shape[1] < n + halo:
                            return
                    elif off + n + halo > self.source.length:
                        return
                    k = rings.take()
                    slots = [rings.host(k, i, "planes", (2, cols)) for i in range(len(shards))]
                    heads = [rings.host(k, i, "bases", (n_bases,)) for i in range(len(shards))] if self.fused else None

                    def fill(i, off=off, slots=slots, heads=heads):
                        s, t = shards[i]
                        lo = off + t * n_local
                        if live:
                            slots[i][...] = buf[:, t * n_local : t * n_local + cols]
                        else:
                            self.sources[s].stage(lo, lo + cols, out=slots[i])
                        if heads is not None:
                            heads[i][...] = shard_bases(model, off, n_local, cols, t)

                    list(pool.map(fill, range(len(shards))))
                    count += 1
                    yield k, off, shapes, account
                    off += n

        def run_chunk(off, bufs):
            blocks = [[bufs[s * n_time + t]["planes"] for t in range(n_time)] for s in range(n_stream)]
            bases = ([[bufs[s * n_time + t]["bases"] for t in range(n_time)] for s in range(n_stream)]
                     if self.fused else None)
            outs = step(blocks, off, bases)
            return _shard_stats(outs, threshold) if mode == "scan" else join(outs, 1)

        def emit_at(off, out):
            # the single-device layout, with a stream axis for a bank
            if mode == "scan":
                out = _join_scan(out, n_stream, n_time)
            elif n_stream == 1:
                out = tuple(o[0] for o in out) if mode == "search" else out[0]
            emit(off // self._win_raw, out)

        _pipelined(rings, staged(), run_chunk, None if emit is None else emit_at, mesh.distinct, max_chunks)
        if max_chunks is not None and done[0] >= max_chunks:
            return  # a bounded run stops before the ragged tail
        # the ragged tail, single-device stream by stream (a live pipe's
        # length is real now: its staging ended on the short read)
        off = start_off + done[0] * n
        if n_stream == 1:
            self._run_single(mode, emit, self.source, off, None, threshold, stats)
            return
        got = []
        for src in self.sources:
            got.append([])
            self._run_single(mode, None if emit is None else (lambda w0, out, mine=got[-1]: mine.append((w0, out))),
                             src, off, None, threshold, stats)
        if emit is not None:
            for j, (w0, _) in enumerate(got[0]):
                emit(w0, _stack_streams(mode, [mine[j][1] for mine in got]))


class WaterfallRunner:
    """Stream a bank of capture files through the waterfall model on
    ``device`` (BASELINE config 5 from disk).  Each chunk is a whole
    number of window starts, and carries the ``width - stride`` lookahead
    that its last windows read, so chunking is invisible in the output.
    ``sources``: one or more :class:`SampleSource` of equal length and
    format (the bank's streams), or a single
    :class:`~quadrs_tpu_torch.sources.PipeSource` (a live spectrogram).
    A staging thread reads every file straight into its row of one
    page-locked (S, 2, span) slot, ahead of the device work.

    :meth:`run` hands ``on_norms(first_window_index, norms)`` the
    (S, windows, width) f32 rows of each chunk; :meth:`run_search` the
    per-window peaks; :meth:`run_scan` returns the per-bin survey.

    With ``mesh`` (a ``(stream, time)`` mesh), the sources shard over the
    mesh's ``stream`` rows (a multiple of them) and each chunk's sample
    axis over its ``time`` devices: a fixed advance of whole stride cells
    a shard, each shard staged with its ``width - stride`` window halo
    (the true continuation for the last, zeros past EOF, whose windows
    are dropped), so chunking and sharding are both invisible in the
    output.  A pipe is wrapped in a
    :class:`~quadrs_tpu_torch.sources.LivePipeStream`.
    """

    def __init__(
        self,
        sources,
        model: WaterfallModel,
        device: torch.device | str,
        chunk_windows: int = 1 << 11,
        mesh=None,
    ):
        sources = list(sources) if isinstance(sources, (list, tuple)) else [sources]
        cfg = model.cfg
        if len(sources) != cfg.n_streams:
            raise ValueError(f"{len(sources)} sources for a {cfg.n_streams}-stream bank")
        for src in sources:
            if src.format is not cfg.fmt:
                raise ValueError(f"source format {src.format} != bank format {cfg.fmt}")
        _check_pipe_sources(sources)
        if mesh is not None and getattr(sources[0], "is_pipe", False):
            # a live pipe shards like a file bank of one: the sharded
            # staging reads strictly forward (whole stride cells, then the
            # halo), which the sliding facade serves; EOF turns its
            # sentinel length real mid-staging
            sources = [LivePipeStream(sources[0])]
        if len({src.length for src in sources}) != 1:
            raise ValueError("bank sources must have equal lengths")
        self.sources = sources
        self.device = torch.device(device)
        self.model = model.to(self.device)
        self.chunk_windows = max(1, chunk_windows)
        self.mesh = mesh
        if mesh is not None:
            if len(sources) % mesh.shape["stream"]:
                raise ValueError(f"{len(sources)} sources do not shard over {mesh.shape['stream']} 'stream' mesh rows")
            self._halo = waterfall_halo(cfg)
            # each time shard needs whole stride cells and must cover the
            # halo its last windows read
            quantum = mesh.shape["time"] * max(1, -(-self._halo // cfg.stride))
            self.chunk_windows = max(quantum, self.chunk_windows // quantum * quantum)
        self._ring: UploadRing | None = None
        self._shard_rings: RingSet | None = None

    def _total_windows(self) -> int:
        cfg = self.model.cfg
        length = self.sources[0].length
        return (length - cfg.fft_width) // cfg.stride + 1 if length >= cfg.fft_width else 0

    def _spans(self, start_window: int, limit: int | None = None):
        """(first_window, n_valid, newly_staged_real_samples, lo, hi) per
        chunk of a file bank: the chunk's windows read samples [lo, hi).
        ``limit`` bounds how many chunks are staged, so the staging thread
        does not run ahead of a ``max_chunks`` consumer."""
        cfg = self.model.cfg
        total_windows = self._total_windows()
        w = start_window
        prev_hi = None
        staged = 0
        while w < total_windows and (limit is None or staged < limit):
            staged += 1
            n_w = min(self.chunk_windows, total_windows - w)
            lo = w * cfg.stride
            # last window start + width (never past EOF)
            hi = (w + n_w - 1) * cfg.stride + cfg.fft_width
            # real samples new to this chunk: the overlap with the previous
            # chunk's span counts once, skipping-stride gaps not at all
            new = hi - (lo if prev_hi is None else max(lo, prev_hi))
            prev_hi = hi
            yield w, n_w, new, lo, hi
            w += n_w

    def _staged_chunks(self, start_window: int, limit: int | None = None):
        """(first_window, n_valid, newly_staged_real_samples, (S, 2, span)
        planes) per chunk, each a new array."""
        for w, n_w, new, lo, hi in self._spans(start_window, limit):
            yield w, n_w, new, np.stack([src.stage(lo, hi) for src in self.sources])

    def _staged_chunks_pipe(self, start_window: int, limit: int | None = None):
        """The :meth:`_staged_chunks` contract for a single
        :class:`~quadrs_tpu_torch.sources.PipeSource` stream (a live
        spectrogram: ``rtl_sdr - | ... waterfall -stdin yes``).

        The pipe is read sequentially into an absolute-position buffer:
        each chunk's ``[lo, hi)`` span is ensured by reading forward, the
        ``width - stride`` overlap carries between chunks (a pipe cannot
        re-read), skipping strides' gaps between chunks are read and
        discarded (a pipe cannot seek), and the total window count is
        discovered at EOF, after which the staged spans, valid counts and
        sample accounting match the file path exactly."""
        cfg = self.model.cfg
        src = self.sources[0]
        width, stride = cfg.fft_width, cfg.stride
        w = start_window
        staged = 0
        pos = 0  # absolute sample index of buf[:, 0]
        buf = None  # (2, m) unconsumed planes
        eof_len: int | None = None  # effective capture length, known at EOF

        def ensure(abs_hi: int) -> None:
            """Read forward until the buffer covers [pos, abs_hi) or EOF."""
            nonlocal buf, eof_len
            have = 0 if buf is None else buf.shape[1]
            need = abs_hi - (pos + have)
            if need > 0 and eof_len is None:
                new = src.read_planes(need)
                buf = new if buf is None else np.concatenate([buf, new], axis=1)
                if new.shape[1] < need:
                    eof_len = pos + buf.shape[1]

        def drop_to(abs_lo: int) -> None:
            """Discard samples below abs_lo (reading past the buffer if a
            skipping stride's gap has not been read yet)."""
            nonlocal buf, pos, eof_len
            while True:
                have = 0 if buf is None else buf.shape[1]
                k = abs_lo - pos
                if k <= 0:
                    return
                if k <= have:
                    buf = buf[:, k:]
                    pos = abs_lo
                    return
                pos += have
                buf = None
                if eof_len is not None:
                    return
                skip = src.read_planes(min(abs_lo - pos, 1 << 20))
                if skip.shape[1] == 0:
                    eof_len = pos
                    return
                buf = skip

        prev_hi = None
        while limit is None or staged < limit:
            n_w = self.chunk_windows
            lo = w * stride
            hi = (w + n_w - 1) * stride + width
            drop_to(lo)
            ensure(hi)
            if eof_len is not None:
                total = (eof_len - width) // stride + 1 if eof_len >= width else 0
                if w >= total:
                    return
                n_w = min(n_w, total - w)
                hi = (w + n_w - 1) * stride + width
            staged += 1
            planes = buf[:, : hi - pos][None, ...]  # (1, 2, span)
            new = hi - (lo if prev_hi is None else max(lo, prev_hi))
            prev_hi = hi
            yield w, n_w, new, planes
            w += n_w

    def _staged(self, ring: UploadRing, start_window: int, limit, account):
        """The staging thread's generator: each chunk's (S, 2, span) planes
        in a free slot.  A file bank reads every file straight into its
        row, a few files at a time on reader threads (the loader releases
        the interpreter lock); a pipe's planes are copied in."""
        n_s = len(self.sources)

        def item(k, w, n_w, new, span):
            return k, w, {"planes": (n_s, 2, span)}, lambda: account(n_w, new)

        if getattr(self.sources[0], "is_pipe", False):
            for w, n_w, new, planes in self._staged_chunks_pipe(start_window, limit):
                k = ring.take()
                ring.host(k, "planes", planes.shape)[...] = planes
                yield item(k, w, n_w, new, planes.shape[-1])
            return
        with ThreadPoolExecutor(min(4, n_s)) as pool:
            for w, n_w, new, lo, hi in self._spans(start_window, limit):
                k = ring.take()
                host = ring.host(k, "planes", (n_s, 2, hi - lo))
                list(pool.map(lambda s: self.sources[s].stage(lo, hi, out=host[s]), range(n_s)))
                yield item(k, w, n_w, new, hi - lo)

    def run(self, on_norms=None, start_window: int = 0, max_chunks=None) -> RunStats:
        return self._run("norms", on_norms, start_window, max_chunks)

    def run_search(self, on_peaks=None, start_window: int = 0, max_chunks=None) -> RunStats:
        """Like :meth:`run` but through the peak search:
        ``on_peaks(first_window_index, (idx, val))`` receives per chunk
        the (S, windows) int32 fftshifted peak bins and f32 magnitudes;
        through the kernel the spectrogram never reaches device memory.
        On a mesh each shard runs the search on its own windows."""
        return self._run("search", on_peaks, start_window, max_chunks)

    def run_scan(self, threshold: float = 0.0, start_window: int = 0, max_chunks=None) -> ScanResult:
        """Band survey (the rtl_power product): per fftshifted bin, the
        average and maximum window power and the count of windows above
        ``threshold``, over every valid window of the run.  Each chunk
        reduces on the device (in the scan kernel; on a mesh, each shard's
        norms masked to the chunk's valid windows, as the JAX package's
        mesh path reduces); only ``3 * S * width`` values per chunk and
        shard cross to the host."""
        n_s = len(self.sources)
        totals = _ScanTotals(n_s, self.model.cfg.fft_width)
        stats = self._run("scan", totals.add, start_window, max_chunks, threshold)
        return totals.result(threshold, stats, stats.windows_out // n_s)

    def _run(self, mode: str, emit, start_window: int, max_chunks, threshold: float = 0.0) -> RunStats:
        stats = RunStats()
        t0 = time.perf_counter()
        n_s = len(self.sources)

        def account(n_valid: int, new_samples: int) -> None:
            stats.samples_in += new_samples * n_s
            stats.windows_out += n_s * n_valid

        if self.mesh is not None:
            self._run_sharded(mode, emit, start_window, max_chunks, threshold, account)
        else:
            self._run_single(mode, emit, start_window, max_chunks, threshold, account)
        stats.seconds = time.perf_counter() - t0
        return stats

    def _run_single(self, mode: str, emit, start_window: int, max_chunks, threshold: float, account) -> None:
        cfg = self.model.cfg
        n_s = len(self.sources)
        if self._ring is None:
            span = (self.chunk_windows - 1) * cfg.stride + cfg.fft_width
            length = self.sources[0].length
            if length is not None:
                span = max(1, min(span, length))
            self._ring = UploadRing(self.device, 2, planes=(n_s * 2 * span, cfg.fmt.torch_dtype))
        ring = self._ring
        ring.reset()
        model = self.model
        step = {"norms": model.step, "search": model.search, "scan": lambda raw: model.scan(raw, threshold)}[mode]
        _pipelined(ring, self._staged(ring, start_window, max_chunks, account),
                   lambda _w, bufs: step(bufs["planes"]), emit, [self.device], max_chunks)

    def _run_sharded(self, mode: str, emit, start_window: int, max_chunks, threshold: float, account) -> None:
        """Mesh chunks: a fixed advance of ``chunk_windows`` windows, whole
        stride cells a shard; the staging thread stages each shard's
        block (its slice and its halo, zeros past EOF) from every source
        of its mesh row straight into the shard's ring, and each chunk's
        outputs are joined on the first shard's device and cut to its
        valid windows there.

        Accounting is the single-device path's (new real samples up to the
        last valid window's end), so ``RunStats.msps`` compares between
        the two; for skipping strides the mesh path stages whole stride
        cells, gaps included, which are not counted as input."""
        cfg, mesh = self.model.cfg, self.mesh
        n_time, n_rows = mesh.shape["time"], mesh.shape["stream"]
        per = len(self.sources) // n_rows
        n_w = self.chunk_windows
        n_local = n_w * cfg.stride // n_time
        cols = n_local + self._halo
        nw_local = n_local // cfg.stride
        step = make_sharded_waterfall_step(self.model, mesh, search=mode == "search")
        shards = [(r, t) for r in range(n_rows) for t in range(n_time)]
        if self._shard_rings is None:
            self._shard_rings = RingSet([mesh.devices[r][t] for r, t in shards], 2,
                                        planes=(per * 2 * cols, cfg.fmt.torch_dtype))
        rings = self._shard_rings
        rings.reset()
        shapes = {"planes": (per, 2, cols)}
        live = getattr(self.sources[0], "is_live", False)

        def staged():
            # a live pipe's length is a sentinel until EOF: stage forward
            # (shard after shard, as the facade reads strictly forward),
            # then read it again; the chunk where the short read lands
            # recomputes the window total before it is yielded
            total = self._total_windows()
            w = start_window
            prev_hi = None
            count = 0
            with ThreadPoolExecutor(min(4, len(shards) * per)) as pool:
                while (live or w < total) and (max_chunks is None or count < max_chunks):
                    lo = w * cfg.stride
                    k = rings.take()
                    # each shard's slot made here, on this thread, before
                    # the readers fill its rows
                    hosts = [rings.host(k, i, "planes", (per, 2, cols)) for i in range(len(shards))]

                    def fill(job, lo=lo, hosts=hosts):
                        i, j = divmod(job, per)
                        r, t = shards[i]
                        row = hosts[i][j]
                        a = lo + t * n_local
                        got = self.sources[r * per + j].stage(a, a + cols, out=row).shape[1]
                        row[:, got:] = 0  # past EOF, and a reused slot's older bytes

                    jobs = range(len(shards) * per)
                    list(map(fill, jobs) if live else pool.map(fill, jobs))
                    if live:
                        total = self._total_windows()
                        if w >= total:
                            return
                    count += 1
                    length = self.sources[0].length
                    n_valid = min(n_w, total - w)
                    # the single-device formula: the last valid window's end,
                    # capped at EOF, the overlap with the previous chunk once
                    acc_hi = min((w + n_valid - 1) * cfg.stride + cfg.fft_width, length)
                    new = max(0, acc_hi - (lo if prev_hi is None else max(lo, prev_hi)))
                    prev_hi = max(acc_hi, prev_hi or 0)
                    yield k, (w, n_valid), shapes, lambda n_valid=n_valid, new=new: account(n_valid, new)
                    w += n_w

        def run_chunk(at, bufs):
            n_valid = at[1]
            blocks = [[bufs[r * n_time + t]["planes"] for t in range(n_time)] for r in range(n_rows)]
            outs = step(blocks)
            if mode == "scan":
                return _shard_stats(outs, threshold, lambda t: n_valid - t * nw_local)
            # the windows past the chunk's valid ones (those reading the
            # zeros past EOF) are left on the device
            out = join(outs, 1)
            return tuple(o[:, :n_valid] for o in out) if mode == "search" else out[:, :n_valid]

        def emit_at(at, out):
            emit(at[0], _join_scan(out, n_rows, n_time) if mode == "scan" else out)

        _pipelined(rings, staged(), run_chunk, None if emit is None else emit_at, mesh.distinct, max_chunks)
