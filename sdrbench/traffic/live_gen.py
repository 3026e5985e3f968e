"""The live traffic's generator, a process of its own (plain Python and
NumPy): it writes a capture's bytes, looped, into a pipe in blocks on a
cumulative schedule at the source's rate, as a radio's driver hands over
its transfers, then closes the pipe.

Block ``b`` holds samples ``[b B, (b + 1) B)`` and is due at ``t0 + (b +
1) B / rate`` on the system's monotonic clock, once a radio would have
filled it.  The generator waits for each block's due time, writes it, and
records how late it began (behind its schedule: the generator or the host
was late) and how long the write blocked (the pipe was full: the reader
was slow).

    python -m sdrbench.traffic.live_gen --fd N --capture PATH --rate R \\
        --samples S --block B --pair 2

It prints ``ready`` once the capture is loaded, reads the schedule's
``t0`` from its standard input, and at the end prints one JSON line of
its lateness.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np


def _pct(v: np.ndarray, q: float) -> float:
    return float(np.percentile(v, q)) if len(v) else 0.0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--fd", type=int, required=True)
    ap.add_argument("--capture", required=True)
    ap.add_argument("--rate", type=int, required=True)
    ap.add_argument("--samples", type=int, required=True)
    ap.add_argument("--block", type=int, required=True)
    ap.add_argument("--pair", type=int, default=2)
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
    out = os.fdopen(a.fd, "wb", buffering=0)
    broken = False
    try:
        for b in range(n_blocks):
            lo = b * a.block
            hi = min(lo + a.block, a.samples)
            due = t0 + hi / a.rate
            now = time.monotonic()
            if now < due:
                time.sleep(due - now)
            start = time.monotonic()
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
    print(json.dumps({
        "blocks": n_blocks,
        "late_max_ms": 1e3 * float(late.max()) if n_blocks else 0.0,
        "late_p95_ms": 1e3 * _pct(late, 95),
        "blocked_max_ms": 1e3 * float(blocked.max()) if n_blocks else 0.0,
        "blocked_p95_ms": 1e3 * _pct(blocked, 95),
        "broken_pipe": broken,
    }), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
