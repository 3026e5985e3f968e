"""The host's load over a run's window, read from ``/proc``: a diagnostic
printed on standard error beside each result, not a metric.  It tells a
run that the host slowed (other tenants' steal, CPU or I/O pressure,
dirty pages being written back) from one that the program slowed.

``sample()`` at the window's start and end; ``describe(a, b)`` one line.
Where ``/proc`` lacks a file (not Linux, no pressure stall information),
or its machine-wide counters stand still (a guest whose host hides them; the
line says so), the fields it would give are left out.
"""

from __future__ import annotations

import os
import resource
import time

# /proc/stat's cpu line: user nice system idle iowait irq softirq steal
IDLE, IOWAIT, STEAL = 3, 4, 7


def _cpu_ticks() -> list[int] | None:
    try:
        with open("/proc/stat") as fh:
            first = fh.readline().split()
    except OSError:
        return None
    if not first or first[0] != "cpu":
        return None
    return [int(v) for v in first[1:9]]


def _pressure_us(kind: str) -> int | None:
    """Microseconds in which some task waited for ``kind`` (cpu, io)."""
    try:
        with open(f"/proc/pressure/{kind}") as fh:
            for line in fh:
                if line.startswith("some"):
                    return int(line.rsplit("total=", 1)[1])
    except (OSError, ValueError, IndexError):
        return None
    return None


def _meminfo_kib(*keys: str) -> int | None:
    try:
        with open("/proc/meminfo") as fh:
            rows = dict(line.split(":", 1) for line in fh if ":" in line)
        return sum(int(rows[k].split()[0]) for k in keys)
    except (OSError, ValueError, KeyError):
        return None


def sample() -> dict:
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return {
        "t": time.monotonic(),
        "cpu": _cpu_ticks(),
        "own_cpu_s": ru.ru_utime + ru.ru_stime,
        "psi_cpu_us": _pressure_us("cpu"),
        "psi_io_us": _pressure_us("io"),
        "dirty_kib": _meminfo_kib("Dirty", "Writeback"),
    }


def describe(a: dict, b: dict) -> str:
    """One line of what the host did between samples ``a`` and ``b``."""
    wall = max(b["t"] - a["t"], 1e-9)
    parts = [f"host over {wall:.1f} s:"]
    d = [y - x for x, y in zip(a["cpu"], b["cpu"])] if a["cpu"] and b["cpu"] else []
    if sum(d) > 0:
        total = sum(d)
        ncpu = os.cpu_count() or 1
        busy = total - d[IDLE] - d[IOWAIT]
        parts.append(f"cores busy {ncpu * busy / total:.2f} of {ncpu}")
        parts.append(f"steal {100.0 * d[STEAL] / total:.2f}%")
        parts.append(f"iowait {100.0 * d[IOWAIT] / total:.2f}%")
    else:
        # a host that keeps its counters from its guests: then a
        # process of fixed work, such as the live cell's generator, is late
        # where the machine's cores are short
        parts.append("the machine's CPU counters do not move here")
    parts.append(f"this process {(b['own_cpu_s'] - a['own_cpu_s']) / wall:.4f} cores")
    for key, name in (("psi_cpu_us", "cpu pressure"), ("psi_io_us", "io pressure")):
        if a[key] is not None and b[key] is not None:
            parts.append(f"{name} {100.0 * (b[key] - a[key]) / 1e6 / wall:.2f}%")
    if a["dirty_kib"] is not None:
        parts.append(f"dirty at start {a['dirty_kib'] / 1024:.1f} MiB")
    return " ".join(parts)
