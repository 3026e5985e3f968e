"""Host staging rings: page-locked slots on the way to the device, and
page-locked outputs on the way back.

The runners fill a slot on a staging thread (the capture loader writes
straight into it), start the slot's host-to-device copy on a copy stream
with an event the compute stream waits on, and hand the slot back to the
staging thread only once that event has completed.  Each slot has its own
device buffer, and the copy stream waits for the work that read a buffer
before it writes it again, so the allocator never recycles memory that a
copy still writes.  Outputs cross the other way into page-locked memory
with a non-blocking copy and an event, so a chunk's ``emit`` runs while
the next chunk computes.

On a CPU device the same code runs with plain memory and no copies: a
slot's host view is what the model reads (``pin_memory`` is refused
without CUDA).
"""

from __future__ import annotations

import math
import queue
import threading

import numpy as np
import torch


class RingClosed(Exception):
    """Raised in the staging thread when its consumer has gone."""


class UploadRing:
    """``n_slots`` slots, each a set of named flat host buffers (page-locked
    on a CUDA device) with a device buffer apiece.

    ``buffers``: ``name=(elements, torch dtype)``.  The staging thread
    calls :meth:`take` and writes through :meth:`host`; the consumer calls
    :meth:`upload`, launches its work, calls :meth:`consumed`, and later
    :meth:`recycle`.
    """

    def __init__(self, device: torch.device | str, n_slots: int = 4, **buffers: tuple[int, torch.dtype]):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.n_slots = n_slots
        self._buffers = buffers
        # a slot's memory is made when the slot is first used: a short run
        # pays for the slots it fills, and the staging thread page-locks the
        # later ones while the first chunk is already on its way
        self._host: list[dict[str, torch.Tensor] | None] = [None] * n_slots
        self._dev: list[dict[str, torch.Tensor] | None] = [None] * n_slots
        self._free: queue.Queue[int] = queue.Queue()
        self._closed = threading.Event()
        if self.cuda:
            self.stream = torch.cuda.Stream(self.device)
            self._copied = [torch.cuda.Event() for _ in range(n_slots)]
            self._read = [torch.cuda.Event() for _ in range(n_slots)]
        self.reset()

    def _host_of(self, k: int) -> dict[str, torch.Tensor]:
        if self._host[k] is None:
            self._host[k] = {name: torch.empty(n, dtype=dt, pin_memory=self.cuda) for name, (n, dt) in self._buffers.items()}
        return self._host[k]

    def _dev_of(self, k: int) -> dict[str, torch.Tensor]:
        if self._dev[k] is None:
            self._dev[k] = {name: torch.empty(n, dtype=dt, device=self.device) for name, (n, dt) in self._buffers.items()}
        return self._dev[k]

    def reset(self) -> None:
        """Every slot free again (call with no staging thread running)."""
        self._closed.clear()
        while not self._free.empty():
            self._free.get_nowait()
        for k in range(self.n_slots):
            self._free.put(k)

    # -- the staging thread's side -------------------------------------------
    def take(self) -> int:
        """A free slot's index; blocks until one is recycled, raises
        :class:`RingClosed` once the consumer has closed the ring."""
        while not self._closed.is_set():
            try:
                return self._free.get(timeout=0.05)
            except queue.Empty:
                continue
        raise RingClosed

    def host(self, k: int, name: str, shape: tuple[int, ...]) -> np.ndarray:
        """Slot ``k``'s buffer ``name`` as a contiguous numpy array of ``shape``."""
        return self._host_of(k)[name][: math.prod(shape)].view(shape).numpy()

    # -- the consumer's side ---------------------------------------------------
    def upload(self, k: int, **shapes: tuple[int, ...]) -> dict[str, torch.Tensor]:
        """Slot ``k``'s buffers on the device, each as a tensor of its
        shape: copies enqueued on the copy stream, awaited by the current
        stream.  On the CPU, the host buffers themselves."""
        if not self.cuda:
            return {name: self._host_of(k)[name][: math.prod(s)].view(s) for name, s in shapes.items()}
        out = {}
        host, dev = self._host_of(k), self._dev_of(k)
        compute = torch.cuda.current_stream(self.device)
        # the work that last read this slot's device buffers comes first
        self.stream.wait_event(self._read[k])
        with torch.cuda.stream(self.stream):
            for name, s in shapes.items():
                n = math.prod(s)
                dev[name][:n].copy_(host[name][:n], non_blocking=True)
                out[name] = dev[name][:n].view(s)
            self._copied[k].record(self.stream)
        compute.wait_event(self._copied[k])
        return out

    def consumed(self, k: int) -> None:
        """Mark the work launched so far on the current stream as the last
        reader of slot ``k``'s device buffers."""
        if self.cuda:
            self._read[k].record(torch.cuda.current_stream(self.device))

    def recycle(self, k: int) -> None:
        """Hand slot ``k`` back to the staging thread, once its copy has
        left the host buffers."""
        if self.cuda:
            self._copied[k].synchronize()
        self._free.put(k)

    def close(self) -> None:
        """Wake a staging thread blocked in :meth:`take`."""
        self._closed.set()


class Download:
    """A chunk's device output (a tensor or a tuple of them) on its way to
    page-locked host memory; :meth:`wait` gives it as numpy.  Every call
    gets memory of its own from PyTorch's caching host allocator, so a
    callback may keep what it was given, and what it drops is reused."""

    def __init__(self, out, device: torch.device):
        self._tuple = isinstance(out, tuple)
        parts = out if self._tuple else (out,)
        if device.type != "cuda":
            self._host, self._event = [t.cpu() for t in parts], None
            return
        self._host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in parts]
        for h, t in zip(self._host, parts):
            h.copy_(t, non_blocking=True)
        self._event = torch.cuda.Event()
        self._event.record(torch.cuda.current_stream(device))

    def wait(self):
        if self._event is not None:
            self._event.synchronize()
        arrays = tuple(h.numpy() for h in self._host)
        return arrays if self._tuple else arrays[0]
