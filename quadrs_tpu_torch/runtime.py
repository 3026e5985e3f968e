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
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

from quadrs_tpu_torch.staging import Download
from quadrs_tpu_torch.stream import Stream


def window_batches(
    offsets: np.ndarray,
    width: int,
    budget: int = 1 << 20,
    span_cap: int = 1 << 26,
    root_step: int = 1,
) -> tuple[int, list[np.ndarray]]:
    """Split window offsets into executor-sized batches: ~``budget``
    samples of output per batch, and no batch spanning more than
    ``span_cap`` ROOT-SOURCE samples (the executor stages each batch's
    whole root span, so huge strides would otherwise balloon staging
    memory).  ``root_step`` is how many root samples one output offset
    unit covers (the chain's total decimation, :func:`root_step_of`)."""
    batch = max(1, min(len(offsets), budget // max(width, 1)))
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


def _to_device(tree, device: torch.device):
    """A plan's nested dict of numpy arrays as tensors on ``device``."""
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return torch.as_tensor(tree, device=device)


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

    def _stage(self, lo: int, hi: int) -> torch.Tensor:
        """The root source's samples [lo, hi) as (2, hi - lo) planes on the
        device, staged through a page-locked slot (grown to the largest
        span asked for) that a file-backed source fills through the
        capture loader."""
        j, self._turn = self._turn, self._turn ^ 1
        if self._copied[j] is not None:
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
        output on the way back; returns ``(download, valid)``.
        ``download.wait()`` gives the outputs (see :meth:`run`).  One batch
        may be submitted while the one before it is still awaited, so a
        sink can work on batch k while batch k+1 computes."""
        offs = np.asarray(offs, dtype=np.int64)
        if len(offs) == 0:
            raise ValueError("empty offset batch")
        if self.batch is not None and len(offs) > self.batch:
            raise ValueError(f"batch of {len(offs)} exceeds executor width {self.batch}")
        buf, base = None, 0
        if self.source.has_staging:
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
        plan = self.stream.plan(offs, self.n, base)
        ctx = {"buf": buf, "device": self.device}
        out = self.stream.read_batch(ctx, _to_device(plan.prep, self.device), self.n)
        if self.post_takes_aux:
            out = self.post(out, torch.tensor(0.0 if aux is None else aux, dtype=torch.float32, device=self.device))
        elif self.post is not None:
            out = self.post(out)
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
        return download.wait(), valid

    def run_each(self, batches):
        """:meth:`run` over ``batches``, one ahead: yields ``(offs,
        outputs, valid)`` of each batch in order, with the next batch
        already submitted."""
        pending = None
        for offs in batches:
            nxt = (offs, *self.submit(offs))
            if pending is not None:
                yield pending[0], pending[1].wait(), pending[2]
            pending = nxt
        if pending is not None:
            yield pending[0], pending[1].wait(), pending[2]
