"""Constant tables on the device, uploaded once.

A table is a host array that depends on a stage's parameters alone (an
NCO's in-window angles, a FIR's polyphase matrix or tap spectrum) and
that every batch reads.  :func:`device_table` gives it as a
tensor on a device from one cache keyed by ``(what, key, device)``:

* a miss builds the host array and uploads it with one blocking copy, so
  the table is whole before any stream reads it (the daemon's sessions run
  on streams of their own);
* a hit is a lookup, and copies nothing;
* the tensor holds the host array's values bit for bit (the NCO's angles
  stay the host's exact reductions);
* the cache keeps the tables used last, at most :data:`CAPACITY` of them
  and :data:`CAPACITY_BYTES` together (the newest table is kept whatever
  its size), so a long-lived process does not grow without end.  A table
  read on a stream other than the one it was made on is marked used there
  (``record_stream``), so an evicted table's memory is not reused while
  that stream still reads it.

On a CPU device the table is a copy of the host array, made once.
:func:`uploads` counts the misses of the calling thread (the Executor's
``executor.launch`` counter ``table_uploads``).
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Callable, Hashable

import numpy as np
import torch

# tables kept: a few a chain (an NCO's angles, a FIR's matrix) on
# each of up to eight devices; a chain's largest is a 2^24-sample window's
# angles, 64 MiB
CAPACITY = 64
CAPACITY_BYTES = 256 << 20

_lock = threading.Lock()
_tables: OrderedDict[tuple, tuple[torch.Tensor, set[int]]] = OrderedDict()
_local = threading.local()


def _device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def device_table(what: str, key: Hashable, device, build: Callable[[], np.ndarray]) -> torch.Tensor:
    """The table ``what`` of ``key`` as a tensor on ``device``: cached, or
    ``build()``'s host array uploaded once.  ``key`` holds every parameter
    the table's values depend on.  Callers read the tensor and never write
    it."""
    device = _device(device)
    k = (what, key, device)
    stream = torch.cuda.current_stream(device).cuda_stream if device.type == "cuda" else 0
    with _lock:
        hit = _tables.get(k)
        if hit is not None:
            _tables.move_to_end(k)
            table, streams = hit
            if stream not in streams:
                table.record_stream(torch.cuda.current_stream(device))
                streams.add(stream)
            return table
    host = np.ascontiguousarray(build())
    if device.type == "cpu":
        table = torch.from_numpy(host.copy())  # the cache's own, whatever the caller does with its array
    else:
        table = torch.from_numpy(host).to(device)  # pageable: returns once the copy is done
    _local.uploads = uploads() + 1
    with _lock:
        _tables[k] = (table, {stream})
        _tables.move_to_end(k)
        while len(_tables) > 1 and (
            len(_tables) > CAPACITY or sum(t.nbytes for t, _ in _tables.values()) > CAPACITY_BYTES
        ):
            _tables.popitem(last=False)
    return table


def uploads() -> int:
    """The tables this thread has built or uploaded (cache misses) so far."""
    return getattr(_local, "uploads", 0)


def clear() -> None:
    """Drop every cached table."""
    with _lock:
        _tables.clear()
