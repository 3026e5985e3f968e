"""Host staging rings: page-locked slots on the way to the device, and
page-locked outputs on the way back.

The runners fill a slot on a staging thread (the capture loader writes
straight into it), start the slot's host-to-device copy on a copy stream
with an event the compute stream waits on, and hand the slot back to the
staging thread only once that event has completed.  Each slot has its own
device buffer, made on the copy stream and marked used by every stream
that reads it, and the copy stream waits for the work that read a buffer
before it writes it again.  So the allocator never gives the copy stream
memory that another stream's work still uses (the compute stream's
temporaries, freed while its kernels run), and never recycles a slot that
a kernel still reads.  Outputs cross the other way into page-locked memory
with a non-blocking copy and an event, so a chunk's ``emit`` can run while
the next chunk computes, and :meth:`Download.done` tells whether it is
back without waiting.

A mesh's runner stages through a :class:`RingSet`: one ring a shard, each
on its shard's device, taken and recycled together.

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
            # made on the copy stream, the stream that writes it first: made on
            # the compute stream, it could be a block that stream freed with
            # its kernels still running, and the copy would overwrite their
            # data (the allocator orders a block's reuse within its stream only)
            with torch.cuda.stream(self.stream):
                self._dev[k] = {name: torch.empty(n, dtype=dt, device=self.device)
                                for name, (n, dt) in self._buffers.items()}
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
        for buf in dev.values():
            # the slot's memory goes back to the allocator only once the
            # compute stream's work on it has ended
            buf.record_stream(compute)
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


class RingSet:
    """One :class:`UploadRing` per shard of a mesh, used as one ring: a
    slot of the set is a slot of each ring (``k`` a tuple of indices),
    taken, uploaded, marked consumed and recycled together.  Each ring
    copies on a copy stream of its own shard's device, and
    :meth:`upload` gives the shards' buffers in ring order."""

    def __init__(self, devices, n_slots: int = 4, **buffers: tuple[int, torch.dtype]):
        self.rings = [UploadRing(d, n_slots, **buffers) for d in devices]

    def reset(self) -> None:
        for ring in self.rings:
            ring.reset()

    def take(self) -> tuple[int, ...]:
        return tuple(ring.take() for ring in self.rings)

    def host(self, k: tuple[int, ...], i: int, name: str, shape: tuple[int, ...]) -> np.ndarray:
        """Shard ``i``'s buffer ``name`` of slot ``k``."""
        return self.rings[i].host(k[i], name, shape)

    def upload(self, k: tuple[int, ...], **shapes: tuple[int, ...]) -> list[dict[str, torch.Tensor]]:
        return [ring.upload(j, **shapes) for ring, j in zip(self.rings, k)]

    def consumed(self, k: tuple[int, ...]) -> None:
        for ring, j in zip(self.rings, k):
            ring.consumed(j)

    def recycle(self, k: tuple[int, ...]) -> None:
        for ring, j in zip(self.rings, k):
            ring.recycle(j)

    def close(self) -> None:
        for ring in self.rings:
            ring.close()


class Download:
    """A chunk's device output (a tensor or a tuple of them, on one device
    or several) on its way to page-locked host memory; :meth:`wait` gives
    it as numpy.  Each CUDA tensor crosses on its own device's current
    stream, with an event there.  Every call gets memory of its own from
    PyTorch's caching host allocator, so a callback may keep what it was
    given, and what it drops is reused."""

    def __init__(self, out):
        self._tuple = isinstance(out, tuple)
        parts = out if self._tuple else (out,)
        self._host = []
        for t in parts:
            if t.is_cuda:
                h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                h.copy_(t, non_blocking=True)
            else:
                h = t.cpu()
            self._host.append(h)
        self._events = []
        for dev in dict.fromkeys(t.device for t in parts if t.is_cuda):
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(dev))
            self._events.append(event)

    def done(self) -> bool:
        """Whether the output is back: :meth:`wait` would not block."""
        return all(event.query() for event in self._events)

    def wait(self):
        for event in self._events:
            event.synchronize()
        arrays = tuple(h.numpy() for h in self._host)
        return arrays if self._tuple else arrays[0]
