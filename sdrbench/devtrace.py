"""The traced run's reading of a ``torch.profiler`` trace of the card's
activity (kernels, copies, sets) and the CUDA calls that launched it: the
device's busy time (the union of its intervals), its kernel time alone,
the operations that took most device time, and
the longest idle gaps by the CUDA call the launching thread was in then
(none: the host was in Python or in native code that makes no CUDA call).
The union's arithmetic is the program's ``utils/timing.device_ms_per_step``'s,
copied."""

from __future__ import annotations

from collections import defaultdict

import numpy as np

from sdrbench.arith import merged, union_length

TOP = 10
LABELLED_GAPS = 400  # the longest gaps given a host label each
NAME_CHARS = 160


def _is_copy(name: str) -> bool:
    return name.startswith("Memcpy") or name.startswith("Memset")


def _events(prof):
    """``(device events, host events)``: ``(start, end, name)`` and
    ``(start, end, name, thread)`` in microseconds.  The profiler's raw
    events where it gives them (much faster to read than its event tree);
    an annotation's shadow on the device is no device work and is left
    out."""
    from torch.autograd import DeviceType

    dev, cpu = [], []
    raw = getattr(getattr(getattr(prof, "profiler", None), "kineto_results", None), "events", None)
    if raw is not None:
        cuda, host = DeviceType.CUDA, DeviceType.CPU
        for e in raw():
            kind = e.device_type()
            if kind == cuda:
                shadow = getattr(e, "is_user_annotation", None)  # not in every torch
                if not (shadow and shadow()):
                    dev.append((e.start_ns(), e.end_ns(), e.name()))
            elif kind == host:
                cpu.append((e.start_ns(), e.end_ns(), e.name(), e.start_thread_id()))
        # microseconds from the first event: float64 keeps their digits
        t0 = min([a for a, _, _ in dev] + [a for a, _, _, _ in cpu], default=0)
        dev = [((a - t0) / 1e3, (b - t0) / 1e3, n) for a, b, n in dev]
        cpu = [((a - t0) / 1e3, (b - t0) / 1e3, n, t) for a, b, n, t in cpu]
        return dev, cpu
    for e in prof.events():
        tr = e.time_range
        if e.device_type == DeviceType.CPU:
            cpu.append((tr.start, tr.end, e.name, e.thread))
        elif e.device_type == DeviceType.CUDA:
            dev.append((tr.start, tr.end, e.name))
    return dev, cpu


def read(prof) -> dict:
    """Numbers from a stopped profiler, times in seconds."""
    dev, cpu = _events(prof)
    if not dev:
        return {"busy_s": 0.0}
    busy = union_length((a, b) for a, b, _ in dev)
    kernel = union_length((a, b) for a, b, n in dev if not _is_copy(n))
    by_name: dict[str, float] = defaultdict(float)
    for a, b, n in dev:
        by_name[n[:NAME_CHARS]] += b - a
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]

    lo = min([a for a, _, _ in dev] + [a for a, _, _, _ in cpu])
    hi = max([b for _, b, _ in dev] + [b for _, b, _, _ in cpu])
    busy_iv = merged((a, b) for a, b, _ in dev)
    edges = [lo] + [x for iv in busy_iv for x in iv] + [hi]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
    gaps.sort(key=lambda g: g[0] - g[1])
    # the launching thread: the one that made the most launch calls
    launches: dict[int, int] = defaultdict(int)
    for _, _, n, t in cpu:
        if "Launch" in n:
            launches[t] += 1
    main = max(launches, key=launches.get) if launches else None
    host = [(a, b, n) for a, b, n, t in cpu if t == main]
    starts = np.asarray([a for a, _, _ in host], dtype=np.float64)
    ends = np.asarray([b for _, b, _ in host], dtype=np.float64)
    idle: dict[str, float] = defaultdict(float)
    for a, b in gaps[:LABELLED_GAPS]:
        mid = 0.5 * (a + b)
        label = "host: no CUDA call (Python or native host work)"
        if len(host):
            cover = np.nonzero((starts <= mid) & (ends >= mid))[0]
            if len(cover):
                inner = cover[np.argmax(starts[cover])]  # calls nest: the latest start is innermost
                label = f"host: {host[inner][2][:NAME_CHARS]}"
        idle[label] += (b - a) / 1e6
    gaps_top = sorted(idle.items(), key=lambda kv: -kv[1])[:TOP]
    return {
        "busy_s": busy / 1e6,
        "kernel_s": kernel / 1e6,
        "device_ops": [[n, s / 1e6] for n, s in ops],
        "idle_gaps": [[n, s] for n, s in gaps_top],
    }
