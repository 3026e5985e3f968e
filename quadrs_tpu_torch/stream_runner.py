"""Sustained streaming: capture file -> fused receiver chain -> spectrogram.

A capture is processed as one continuous stream: a background thread
stages chunks of native-dtype planes, each chunk carries the FIR's
lookahead past its end (so the filter sees the true continuation), and
each chunk runs through ``PipelineModel.step_stream_fused`` on the
runner's device.  Every chunk's NCO phase is planned exactly on the host
from its absolute offset, so chunking is invisible in the output.
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
from quadrs_tpu_torch.sources import SampleSource


@dataclass
class RunStats:
    samples_in: int = 0
    windows_out: int = 0
    seconds: float = 0.0

    @property
    def msps(self) -> float:
        return self.samples_in / self.seconds / 1e6 if self.seconds else 0.0


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


class StreamRunner:
    """Drive one capture through the fused receiver chain on ``device``.

    ``chunk_samples`` is rounded down to a whole number of STFT windows.
    ``on_windows(first_window_index, norms)`` receives (windows,
    fft_width) f32 rows per chunk.
    """

    def __init__(
        self,
        source: SampleSource,
        model: PipelineModel,
        device: torch.device | str,
        chunk_samples: int = 1 << 22,
    ):
        if source.format is not model.cfg.fmt:
            raise ValueError(
                f"source format {source.format} != model format {model.cfg.fmt}"
            )
        model.require_fused()
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
        return self._run(on_windows, start_window, max_chunks, search=False)

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
        return self._run(on_peaks, start_window, max_chunks, search=True)

    def _run(self, emit, start_window: int, max_chunks, search: bool) -> RunStats:
        model = self.model
        stats = RunStats()
        t0 = time.perf_counter()
        done = 0
        step = model.step_stream_fused_search if search else model.step_stream_fused
        chunks = _background(self._chunks(start_window * self._win_raw))
        for off, planes, valid in chunks:
            raw = torch.from_numpy(planes).to(self.device)
            bases = torch.from_numpy(model.stream_bases(off, planes.shape[1])).to(self.device)
            nv = None if valid == planes.shape[1] else int(valid)
            out = step(raw, bases, n_valid=nv)
            stats.samples_in += planes.shape[1] - self._lookahead
            stats.windows_out += (out[0] if search else out).shape[0]
            if emit is not None:
                if search:
                    out = (out[0].cpu().numpy(), out[1].cpu().numpy())
                else:
                    out = out.cpu().numpy()
                emit(off // self._win_raw, out)
            done += 1
            if max_chunks is not None and done >= max_chunks:
                # break before pulling (and staging) the next chunk
                chunks.close()
                break
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        stats.seconds = time.perf_counter() - t0
        return stats
