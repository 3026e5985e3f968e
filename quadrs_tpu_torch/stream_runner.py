"""Sustained streaming: capture files -> device programs -> spectrograms.

:class:`StreamRunner` processes one capture as one continuous stream: a
background thread stages chunks of native-dtype planes, each chunk
carries the FIR's lookahead past its end (so the filter sees the true
continuation), and each chunk runs through the receiver model on the
runner's device, by one of two routes: the fused frontend
(``PipelineModel.step_stream_fused``) or the chain of torch ops
(``PipelineModel.step_stream``).  Every chunk's NCO phase is planned
exactly on the host from its absolute offset, so chunking is invisible
in the output.

:class:`WaterfallRunner` streams a bank of equal-length captures through
the waterfall model, a whole number of window starts per chunk.
"""

from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass
from typing import Callable, Iterator

import numpy as np
import torch

from quadrs_tpu_torch.models.receiver import PipelineModel
from quadrs_tpu_torch.models.waterfall import WaterfallModel
from quadrs_tpu_torch.sources import SampleSource


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


def _to_host(out):
    """A chunk's device output (a tensor or a tuple of them) as numpy."""
    if isinstance(out, tuple):
        return tuple(a.cpu().numpy() for a in out)
    return out.cpu().numpy()


def _background(gen, depth: int = 2):
    """Run a generator on a daemon thread, yielding its items through a
    bounded queue: staging (file reads + numpy copies) overlaps the
    consumer's device work.  If the consumer abandons the generator, the
    producer notices (stop event) instead of pinning buffers; producer
    exceptions surface in the consumer."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    _DONE = object()
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.2)
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
        except BaseException as e:  # surface staging errors to the consumer
            put(e)

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


FRONTENDS = ("auto", "fused", "chain")


class StreamRunner:
    """Drive one capture through the receiver chain on ``device``.

    ``chunk_samples`` is rounded down to a whole number of STFT windows.
    ``on_windows(first_window_index, norms)`` receives (windows,
    fft_width) f32 rows per chunk.

    ``frontend``: ``auto`` (what the CLI uses) takes the fused frontend
    inside its envelope and the chain of torch ops outside it (decimate
    above 64, or more than 128 subfilters).  ``fused`` and ``chain``
    force one route, as the JAX runner's knob does, so that tests can
    hold the two routes against each other; ``fused`` outside the
    envelope is refused.
    """

    def __init__(
        self,
        source: SampleSource,
        model: PipelineModel,
        device: torch.device | str,
        chunk_samples: int = 1 << 22,
        frontend: str = "auto",
    ):
        if source.format is not model.cfg.fmt:
            raise ValueError(
                f"source format {source.format} != model format {model.cfg.fmt}"
            )
        if frontend not in FRONTENDS:
            raise ValueError(f"frontend must be one of {FRONTENDS}, got {frontend!r}")
        if frontend == "fused" and not model.fused_supported():
            raise ValueError(
                f"decimate {model.cfg.decimate} with {model.cfg.taps} taps is outside the fused "
                "frontend's envelope: use frontend='chain' or 'auto'"
            )
        self.fused = frontend == "fused" or (frontend == "auto" and model.fused_supported())
        cfg = model.cfg
        self.source = source
        self.device = torch.device(device)
        self.model = model.to(self.device)
        self._win_raw = cfg.decimate * cfg.fft_width
        # lookahead: the last FIR output of a chunk reads ceil(taps/2) +
        # taps past its decimation point (group delay), and the window
        # reshape floor-drops the few extra decimated outputs
        self._lookahead = cfg.taps + (cfg.taps - cfg.taps // 2)
        if cfg.taps // 2 // cfg.decimate >= cfg.fft_width:
            raise ValueError("fft window shorter than the FIR group delay span")
        self.chunk_samples = max(self._win_raw, chunk_samples // self._win_raw * self._win_raw)

    def _chunks(self, start_off: int = 0) -> Iterator[tuple[int, np.ndarray, int]]:
        """(offset, (2, chunk+lookahead) planes, real samples) per chunk."""
        la = self._lookahead
        length = self.source.length
        off = start_off
        while off < length - self.model.cfg.taps:
            n = min(self.chunk_samples, (length - off) // self._win_raw * self._win_raw)
            if n <= 0:
                return
            planes = self.source.stage(off, off + n + la)
            valid = planes.shape[1]
            if valid < n + la:
                # raw zero bytes decode to nonzero values for cu8/cs16,
                # so the model masks [valid:] in the decoded domain
                planes = np.pad(planes, ((0, 0), (0, n + la - valid)))
            yield off, planes, valid
            off += n

    def run(
        self,
        on_windows: Callable[[int, np.ndarray], None] | None = None,
        start_window: int = 0,
        max_chunks: int | None = None,
    ) -> RunStats:
        """Process the capture from ``start_window`` onward; resuming is
        exact, since NCO phases are planned from absolute offsets.
        ``max_chunks`` stops after that many chunks."""
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
        ``argmax``/``max`` over :meth:`run`'s rows."""
        return self._run("search", on_peaks, start_window, max_chunks)

    def run_scan(
        self,
        threshold: float = 0.0,
        start_window: int = 0,
        max_chunks: int | None = None,
    ) -> ScanResult:
        """Band survey of the decimated channel: per fftshifted bin, the
        average and maximum window power and the count of windows above
        ``threshold``.  Each chunk's norms reduce on the device; only
        ``3 * width`` values per chunk cross to the host.  Bin ``width//2``
        is the channel centre, the frequency at minus the shift."""
        totals = _ScanTotals(1, self.model.cfg.fft_width)
        stats = self._run("scan", totals.add, start_window, max_chunks, threshold)
        return totals.result(threshold, stats, stats.windows_out)

    def _step(self, mode: str, off: int, planes: np.ndarray, valid: int, threshold: float):
        """One chunk through the runner's route: its ``norms``, its
        per-window peaks (``search``) or its survey stats (``scan``)."""
        model = self.model
        raw = torch.from_numpy(planes).to(self.device)
        nv = None if valid == planes.shape[1] else int(valid)
        if self.fused:
            # per-tile bases, planned on the host from the absolute offset
            head = torch.from_numpy(model.stream_bases(off, planes.shape[1])).to(self.device)
            norms_of, search_of = model.step_stream_fused, model.step_stream_fused_search
        else:
            head = model.theta0(np.asarray([off]))[0]  # the chunk's first-sample phase
            norms_of, search_of = model.step_stream, model.step_stream_search
        if mode == "search":
            return search_of(raw, head, nv)
        norms = norms_of(raw, head, nv)
        if mode == "norms":
            return norms
        from quadrs_tpu_torch.ops.waterfall import scan_of

        return scan_of(norms[None], threshold)

    def _run(self, mode: str, emit, start_window: int, max_chunks, threshold: float = 0.0) -> RunStats:
        """Drive the chunks through :meth:`_step`; ``emit`` receives its
        output on the host."""
        cfg = self.model.cfg
        stats = RunStats()
        t0 = time.perf_counter()
        done = 0
        chunks = _background(self._chunks(start_window * self._win_raw))
        for off, planes, valid in chunks:
            out = self._step(mode, off, planes, valid, threshold)
            stats.samples_in += planes.shape[1] - self._lookahead
            stats.windows_out += (planes.shape[1] - cfg.taps) // cfg.decimate // cfg.fft_width
            if emit is not None:
                emit(off // self._win_raw, _to_host(out))
            done += 1
            if max_chunks is not None and done >= max_chunks:
                # break before pulling (and staging) the next chunk
                chunks.close()
                break
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        stats.seconds = time.perf_counter() - t0
        return stats


class WaterfallRunner:
    """Stream a bank of capture files through the waterfall model on
    ``device`` (BASELINE config 5 from disk).  Each chunk is a whole
    number of window starts, and carries the ``width - stride`` lookahead
    that its last windows read, so chunking is invisible in the output.
    ``sources``: one or more :class:`SampleSource` of equal length and
    format (the bank's streams).  Staging runs on a background thread,
    ahead of the device work.

    :meth:`run` hands ``on_norms(first_window_index, norms)`` the
    (S, windows, width) f32 rows of each chunk; :meth:`run_search` the
    per-window peaks; :meth:`run_scan` returns the per-bin survey.
    """

    def __init__(
        self,
        sources,
        model: WaterfallModel,
        device: torch.device | str,
        chunk_windows: int = 1 << 11,
    ):
        sources = list(sources) if isinstance(sources, (list, tuple)) else [sources]
        cfg = model.cfg
        if len(sources) != cfg.n_streams:
            raise ValueError(f"{len(sources)} sources for a {cfg.n_streams}-stream bank")
        for src in sources:
            if src.format is not cfg.fmt:
                raise ValueError(f"source format {src.format} != bank format {cfg.fmt}")
        if len({src.length for src in sources}) != 1:
            raise ValueError("bank sources must have equal lengths")
        self.sources = sources
        self.device = torch.device(device)
        self.model = model.to(self.device)
        self.chunk_windows = max(1, chunk_windows)

    def _total_windows(self) -> int:
        cfg = self.model.cfg
        length = self.sources[0].length
        return (length - cfg.fft_width) // cfg.stride + 1 if length >= cfg.fft_width else 0

    def _staged_chunks(self, start_window: int, limit: int | None = None):
        """(first_window, n_valid, newly_staged_real_samples, (S, 2, span)
        planes) per chunk.  ``limit`` bounds how many chunks are staged, so
        the background thread does not run ahead of a ``max_chunks``
        consumer."""
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
            yield w, n_w, new, np.stack([src.stage(lo, hi) for src in self.sources])
            w += n_w

    def run(self, on_norms=None, start_window: int = 0, max_chunks=None) -> RunStats:
        return self._run(self.model.step, on_norms, start_window, max_chunks)

    def run_search(self, on_peaks=None, start_window: int = 0, max_chunks=None) -> RunStats:
        """Like :meth:`run` but through the peak search:
        ``on_peaks(first_window_index, (idx, val))`` receives per chunk
        the (S, windows) int32 fftshifted peak bins and f32 magnitudes;
        through the kernel the spectrogram never reaches device memory."""
        return self._run(self.model.search, on_peaks, start_window, max_chunks)

    def run_scan(self, threshold: float = 0.0, start_window: int = 0, max_chunks=None) -> ScanResult:
        """Band survey (the rtl_power product): per fftshifted bin, the
        average and maximum window power and the count of windows above
        ``threshold``, over every valid window of the run.  Each chunk
        reduces on the device; only ``3 * S * width`` values per chunk
        cross to the host."""
        n_s = len(self.sources)
        totals = _ScanTotals(n_s, self.model.cfg.fft_width)
        stats = self._run(lambda raw: self.model.scan(raw, threshold), totals.add, start_window, max_chunks)
        return totals.result(threshold, stats, stats.windows_out // n_s)

    def _run(self, step, emit, start_window: int, max_chunks) -> RunStats:
        stats = RunStats()
        t0 = time.perf_counter()
        done = 0
        n_s = len(self.sources)
        chunks = _background(self._staged_chunks(start_window, max_chunks))
        for w, n_valid, new_samples, planes in chunks:
            out = step(torch.from_numpy(planes).to(self.device))
            stats.samples_in += new_samples * n_s
            stats.windows_out += n_s * n_valid
            if emit is not None:
                emit(w, _to_host(out))
            done += 1
            if max_chunks is not None and done >= max_chunks:
                chunks.close()
                break
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        stats.seconds = time.perf_counter() - t0
        return stats
