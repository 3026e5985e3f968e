"""The live traffic's generator, a process of its own (plain Python and
NumPy): it writes a capture's bytes, looped, into a pipe in blocks on a
cumulative schedule at the source's rate, as a radio's driver hands over
its transfers, then closes the pipe.

Block ``b`` holds samples ``[b B, (b + 1) B)`` and is due at ``t0 + (b +
1) B / rate`` on the system's monotonic clock, once a radio would have
filled it.  The generator sleeps until ``SPIN_S`` before each block's due
time and spins on the clock for the rest, so that a late wake-up from the
sleep does not make the block late; then it writes the block.  It records
how late each write began (behind its schedule: the host took the
generator's CPU), how long the write blocked (the pipe was full: the
reader was slow) and when it began (on the same clock as the harness's
stamps: from then on a reader that is waiting gets the block, and a write
that blocks waits on the program).  How far each sleep overran its end is
reported too: how long the host takes to wake a sleeping thread, which
every wake-up of the program's threads pays.

    python -m sdrbench.traffic.live_gen --fd N --capture PATH --rate R \\
        --samples S --block B --pair 2 --started PATH

It prints ``ready`` once the capture is loaded, reads the schedule's
``t0`` from its standard input, saves the write-start times (``.npy``, one
a block, NaN where the reader had gone) to ``--started`` and prints one
JSON line of its lateness and its CPU use.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

# how long before a block's due time the generator stops sleeping and
# spins, half a 10 ms block: on an H100's shared 8-core host a sleep
# overran by 1.1-5.1 ms at its 95th percentile; with 2 ms of spin 4 runs in
# 18 began their writes 0.6-1.2 ms late at theirs, with 5 ms 1 run in 23
# (0.8 ms), and the program's latencies were no worse
SPIN_S = 0.005

# the generator's environment: one thread a pool, so that NumPy's BLAS
# threads do not spin beside the program after the import
ENV = {"OPENBLAS_NUM_THREADS": "1", "OMP_NUM_THREADS": "1"}


def _pct(v: np.ndarray, q: float) -> float:
    return float(np.percentile(v, q)) if len(v) else 0.0


def wait_until(due: float) -> float:
    """Return at ``due`` on the monotonic clock, not before: sleep to
    ``SPIN_S`` before it, then spin.  Returns how far the sleep overran
    (0 without one)."""
    end = due - SPIN_S
    rest = end - time.monotonic()
    over = 0.0
    if rest > 0:
        time.sleep(rest)
        over = time.monotonic() - end
    while time.monotonic() < due:
        pass
    return over


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--fd", type=int, required=True)
    ap.add_argument("--capture", required=True)
    ap.add_argument("--rate", type=int, required=True)
    ap.add_argument("--samples", type=int, required=True)
    ap.add_argument("--block", type=int, required=True)
    ap.add_argument("--pair", type=int, default=2)
    ap.add_argument("--started", required=True)
    a = ap.parse_args(argv)
    data = np.fromfile(a.capture, dtype=np.uint8)
    period = len(data) // a.pair
    # two periods back to back: any block is one contiguous slice
    loop = memoryview(np.concatenate([data, data]))
    print("ready", flush=True)
    t0 = float(sys.stdin.readline())
    n_blocks = -(-a.samples // a.block)
    late = np.zeros(n_blocks)
    blocked = np.zeros(n_blocks)
    overran = np.zeros(n_blocks)
    started = np.full(n_blocks, np.nan)
    out = os.fdopen(a.fd, "wb", buffering=0)
    broken = False
    cpu0, wall0 = time.process_time(), time.monotonic()
    try:
        for b in range(n_blocks):
            lo = b * a.block
            hi = min(lo + a.block, a.samples)
            due = t0 + hi / a.rate
            overran[b] = wait_until(due)
            started[b] = start = time.monotonic()
            late[b] = start - due
            at = (lo % period) * a.pair
            view = loop[at : at + (hi - lo) * a.pair]
            while len(view):
                n = out.write(view)
                view = view[n:]
            blocked[b] = time.monotonic() - start
    except BrokenPipeError:
        broken = True
    finally:
        try:
            out.close()
        except BrokenPipeError:
            broken = True
    cpu_share = (time.process_time() - cpu0) / max(time.monotonic() - wall0, 1e-9)
    np.save(a.started, started)
    print(json.dumps({
        "blocks": n_blocks,
        "late_max_ms": 1e3 * float(late.max()) if n_blocks else 0.0,
        "late_p95_ms": 1e3 * _pct(late, 95),
        "blocked_max_ms": 1e3 * float(blocked.max()) if n_blocks else 0.0,
        "blocked_p95_ms": 1e3 * _pct(blocked, 95),
        "sleep_over_p95_ms": 1e3 * _pct(overran, 95),
        "cpu_share": cpu_share,
        "broken_pipe": broken,
    }), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
