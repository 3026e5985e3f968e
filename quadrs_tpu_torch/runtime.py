"""Batch executor: turns stream-graph pulls into batched device work.

The counterpart of ``quadrs_tpu.runtime``.  An :class:`Executor` owns one
window length ``n`` and one device: for a batch of window offsets the
host stages the root source's whole span for the batch once (native-dtype
planes in a page-locked slot, which a file-backed source fills through
the capture loader; one host-to-device copy), plans every offset exactly,
and the device computes every window of the batch in one pass of torch
ops.

Two pieces of the JAX executor are left out, because nothing here needs
them: the power-of-two buckets of staged lengths and the padding of each
batch to the executor's width (they bound the number of JAX
compilations; PyTorch runs eagerly and compiles nothing per shape), and
the ``_Planes`` split of complex outputs into real planes (a workaround
for TPU runtimes that cannot move complex values to the host).  Offsets
into the staged buffer are int64, where JAX used int32.

The launch never waits on a card: the plan's arrays cross by
non-blocking copies, the small ones from page-locked memory
(:func:`_to_device`), and the stages' constant tables are kept on the
device (:func:`quadrs_tpu_torch.ops.tables.device_table`), uploaded on
their first batch only.  So the host stages and launches batch k+1 while the
card computes batch k, and waits only for outputs.

While :func:`quadrs_tpu_torch.utils.profiling.profiled` is on, each batch
accounts the host time of its launch (the plan's uploads and the torch ops
it enqueues) under its stream's class name (``shift``, ``lowpass``,
``tonegen``, ...), as the JAX executor does, and each batch's staging,
planning, launch and wait are spans keyed ``(executor, batch)``
(:mod:`quadrs_tpu_torch.utils.profiling`); the launch counts the tables
it uploaded (``table_uploads``).
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

from quadrs_tpu_torch.ops import tables
from quadrs_tpu_torch.staging import Download
from quadrs_tpu_torch.stream import Stream
from quadrs_tpu_torch.utils.profiling import OFF, PROFILER


def window_batches(
    offsets: np.ndarray,
    width: int,
    budget: int = 1 << 20,
    span_cap: int = 1 << 26,
    root_step: int = 1,
    root_read: int = 0,
    gather_cap: int = 1 << 26,
) -> tuple[int, list[np.ndarray]]:
    """Split window offsets into executor-sized batches: ~``budget``
    samples of output per batch, and no batch spanning more than
    ``span_cap`` ROOT-SOURCE samples (the executor stages each batch's
    whole root span, so huge strides would otherwise balloon staging
    memory).  ``root_step`` is how many root samples one output offset
    unit covers (the chain's total decimation, :func:`root_step_of`).

    ``root_read``: the root samples one window reads
    (:func:`root_read_of`).  The source gathers (or generates) each
    window's read apart, at about 40 bytes of device memory a sample, so no
    batch gathers more than ``gather_cap`` of them: a trailing stage's
    lookback, re-read by every window, would otherwise gather far more than
    the card holds.  A window that alone reads more runs alone.  Where this cap does not
    bind, the batches are the JAX package's."""
    batch = max(1, min(len(offsets), budget // max(width, 1)))
    if root_read > 0:
        batch = max(1, min(batch, gather_cap // int(root_read)))
    step = max(1, int(root_step))
    out = []
    i = 0
    n = len(offsets)
    while i < n:
        j = min(i + batch, n)
        while j - i > 1 and (offsets[j - 1] - offsets[i]) * step > span_cap:
            j = i + max(1, (j - i) // 2)
        out.append(offsets[i:j])
        i = j
    return batch, out


def root_step_of(stream) -> int:
    """Root-source samples per unit offset of ``stream`` (its chain's
    total decimation factor)."""
    return max(1, stream.span(1, 1)[0] - stream.span(0, 1)[0])


def root_read_of(stream, width: int) -> int:
    """Root samples one window of ``width`` outputs of ``stream`` reads
    (every window reads as many; a trailing stage's clamped start moves its
    block, not its length): a capture's staged samples, or the samples a
    generator root generates, though it stages none
    (:meth:`~quadrs_tpu_torch.stream.Stream.reads`)."""
    return stream.reads(0, width)


def stream_batches(stream, offsets: np.ndarray, width: int, **kw) -> tuple[int, list[np.ndarray]]:
    """:func:`window_batches` of windows of ``width`` outputs of ``stream``,
    with its root step and the root samples each window reads (``kw``: the
    other arguments)."""
    return window_batches(offsets, width, root_step=root_step_of(stream), root_read=root_read_of(stream, width), **kw)


# bytes: a larger plan array crosses from its own pageable memory, so the
# page-locked memory that torch's caching host allocator keeps (it keeps
# every block it made) stays small
_PINNED_MAX = 1 << 20


def _to_device(tree, device: torch.device, span=OFF):
    """A plan's nested dict of numpy arrays as tensors on ``device``, each
    counted on ``span`` (``tensors``, ``bytes``).  On a card each array
    crosses by a non-blocking copy on the current stream, which does not
    wait on the card: up to :data:`_PINNED_MAX` bytes from page-locked
    memory (torch's caching host allocator, which reuses a block only once
    its copy has left it), a larger array from its own pageable memory,
    which the copy has read when it returns.  On the CPU each becomes a
    tensor without a copy."""
    if isinstance(tree, dict):
        return {k: _to_device(v, device, span) for k, v in tree.items()}
    if device.type == "cuda":
        t = torch.as_tensor(tree)
        if t.nbytes <= _PINNED_MAX:
            t = t.pin_memory()
        t = t.to(device, non_blocking=True)
    else:
        t = torch.as_tensor(tree, device=device)
    span.count("tensors", 1)
    span.count("bytes", t.nbytes)
    return t


class Executor:
    def __init__(
        self,
        stream: Stream,
        n: int,
        device: torch.device | str,
        batch: int | None = None,
        post: Callable[..., Any] | None = None,
        post_takes_aux: bool = False,
    ):
        """``post``: optional transform of the (B, n) complex64 batch (for
        example windowed FFT norms), run on the device before the result
        crosses to the host.  Its outputs may also be batch-level (0-dim
        tensors, top-k rows): batches are never padded, so no row is
        stripped.  ``batch``: the most windows one :meth:`run` takes.

        ``post_takes_aux``: ``post`` is ``post(x, aux)``, ``aux`` a small
        host scalar passed per :meth:`run` or :meth:`submit` (the carried
        boundary score of the device-side candidate scan), on the device as
        a 0-dim f32 tensor."""
        self.stream = stream
        self.n = int(n)
        self.device = torch.device(device)
        self.batch = batch
        self.post = post
        self.post_takes_aux = post_takes_aux
        self.source = stream.root()
        # two page-locked host buffers for staged spans, used in turn, each
        # with the event of its last copy: one batch stages while the one
        # before it is still on its way
        self._slots: list[torch.Tensor | None] = [None, None]
        self._copied: list[torch.cuda.Event | None] = [None, None]
        self._turn = 0
        # spans' keys: (trace_id, batch), batches counted from 0 by submit
        self.trace_id = PROFILER.new_id()
        self._batches = 0

    def _stage(self, lo: int, hi: int) -> torch.Tensor:
        """The root source's samples [lo, hi) as (2, hi - lo) planes on the
        device, staged through a page-locked slot (grown to the largest
        span asked for) that a file-backed source fills through the
        capture loader."""
        j, self._turn = self._turn, self._turn ^ 1
        if self._copied[j] is not None:
            with PROFILER.span("executor.slot_wait", self.trace_id, self._batches - 1):
                self._copied[j].synchronize()  # the slot's last copy has left it
        cuda = self.device.type == "cuda"
        n = hi - lo
        if self._slots[j] is None or self._slots[j].numel() < 2 * n:
            self._slots[j] = torch.empty(2 * n, dtype=self.source.format.torch_dtype, pin_memory=cuda)
        host = self._slots[j][: 2 * n].view(2, n)
        self.source.stage(lo, hi, out=host.numpy())
        buf = host.to(self.device, non_blocking=True)
        if cuda:
            self._copied[j] = torch.cuda.Event()
            self._copied[j].record(torch.cuda.current_stream(self.device))
        return buf

    def submit(self, offs: np.ndarray, aux=None) -> tuple[Download, np.ndarray]:
        """Stage, plan and launch one batch of window offsets, and start its
        output on the way back; returns ``(download, valid)``.  Spans
        ``executor.stage`` (with ``executor.slot_wait``), ``executor.plan``
        and ``executor.launch`` (counter ``table_uploads``: the constant
        tables this batch uploaded; with ``executor.sync_upload``, the
        plan's arrays), keyed ``(trace_id, batch)``.
        ``download.wait()`` gives the outputs (see :meth:`run`).  One batch
        may be submitted while the one before it is still awaited, so a
        sink can work on batch k while batch k+1 computes."""
        offs = np.asarray(offs, dtype=np.int64)
        if len(offs) == 0:
            raise ValueError("empty offset batch")
        if self.batch is not None and len(offs) > self.batch:
            raise ValueError(f"batch of {len(offs)} exceeds executor width {self.batch}")
        k, self._batches = self._batches, self._batches + 1
        buf, base = None, 0
        if self.source.has_staging:
            with PROFILER.span("executor.stage", self.trace_id, k) as sp:
                lo, _ = self.stream.span(int(offs.min()), self.n)
                s_off, s_n = self.stream.span(int(offs.max()), self.n)
                lo = max(0, min(lo, self.source.length))
                hi = max(lo, min(s_off + s_n, self.source.length))
                if hi > lo:
                    buf = self._stage(lo, hi)  # (2, hi - lo) planes
                else:
                    # every window starts past EOF: one zero sample to gather
                    # from (the source masks it by its valid count)
                    buf = torch.zeros((2, 1), dtype=self.source.format.torch_dtype, device=self.device)
                base = lo
                sp.count("bytes", buf.nbytes)
        with PROFILER.span("executor.plan", self.trace_id, k):
            plan = self.stream.plan(offs, self.n, base)
        ctx = {"buf": buf, "device": self.device}
        uploads = tables.uploads()
        with PROFILER.stage(type(self.stream).__name__.lower(), len(offs) * self.n, self.trace_id, k) as launch:
            with PROFILER.span("executor.sync_upload", self.trace_id, k) as sp:
                prep = _to_device(plan.prep, self.device, sp)
            out = self.stream.read_batch(ctx, prep, self.n)
            if self.post_takes_aux:
                out = self.post(out, _to_device(np.float32(0.0 if aux is None else aux), self.device))
            elif self.post is not None:
                out = self.post(out)
            launch.count("table_uploads", tables.uploads() - uploads)
        # back through page-locked memory on a CUDA device
        return Download(out), plan.valid

    def run(self, offs: np.ndarray, aux=None) -> tuple[Any, np.ndarray]:
        """Execute one batch of window offsets.

        Returns ``(outputs, valid)``: ``outputs`` (numpy, or a tuple of
        numpy arrays for a tuple-valued ``post``) with leading dim
        ``len(offs)`` (but for a batch-level output), and ``valid`` each
        window's true sample count per the reference's short-read
        semantics."""
        download, valid = self.submit(offs, aux)
        return self._wait(download, self._batches - 1), valid

    def _wait(self, download: Download, batch: int):
        with PROFILER.span("executor.wait", self.trace_id, batch):
            return download.wait()

    def run_each(self, batches):
        """:meth:`run` over ``batches``, one ahead: yields ``(offs,
        outputs, valid)`` of each batch in order, with the next batch
        already submitted.  The i-th batch of a fresh Executor's
        :meth:`run_each` is its batch i."""
        pending = None
        for offs in batches:
            nxt = (offs, *self.submit(offs), self._batches - 1)
            if pending is not None:
                yield pending[0], self._wait(pending[1], pending[3]), pending[2]
            pending = nxt
        if pending is not None:
            yield pending[0], self._wait(pending[1], pending[3]), pending[2]
