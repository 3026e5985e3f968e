"""Batch executor: turns stream-graph pulls into batched device work.

The counterpart of ``quadrs_tpu.runtime``.  An :class:`Executor` owns one
window length ``n`` and one device: for a batch of window offsets the
host stages the root source's whole span for the batch once (native-dtype
planes, one host-to-device copy), plans every offset exactly, and the
device computes every window of the batch in one pass of torch ops.

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


def _to_host(out):
    if isinstance(out, tuple):
        return tuple(_to_host(a) for a in out)
    return out.cpu().numpy()


class Executor:
    def __init__(
        self,
        stream: Stream,
        n: int,
        device: torch.device | str,
        batch: int | None = None,
        post: Callable[[torch.Tensor], Any] | None = None,
    ):
        """``post``: optional transform of the (B, n) complex64 batch (for
        example windowed FFT norms), run on the device before the result
        crosses to the host.  ``batch``: the most windows one :meth:`run`
        takes."""
        self.stream = stream
        self.n = int(n)
        self.device = torch.device(device)
        self.batch = batch
        self.post = post
        self.source = stream.root()

    def run(self, offs: np.ndarray) -> tuple[Any, np.ndarray]:
        """Execute one batch of window offsets.

        Returns ``(outputs, valid)``: ``outputs`` (numpy, or a tuple of
        numpy arrays for a tuple-valued ``post``) with leading dim
        ``len(offs)``, and ``valid`` each window's true sample count per
        the reference's short-read semantics."""
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
            staged = self.source.stage(lo, hi)  # (2, hi - lo) planes
            if staged.shape[1] == 0:
                # every window starts past EOF: one zero sample to gather
                # from (the source masks it by its valid count)
                staged = np.zeros((2, 1), dtype=staged.dtype)
            buf, base = torch.from_numpy(staged).to(self.device), lo
        plan = self.stream.plan(offs, self.n, base)
        ctx = {"buf": buf, "device": self.device}
        out = self.stream.read_batch(ctx, _to_device(plan.prep, self.device), self.n)
        if self.post is not None:
            out = self.post(out)
        return _to_host(out), plan.valid
