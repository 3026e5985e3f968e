"""Pulse-train clock recovery: run-length decode OOK pulses into bits.

The counterpart of ``quadrs_tpu.bits``, itself the reference's
``src/bits.rs``: ``scan`` walks a boolean pulse stream with an estimated
samples-per-bit ``scale``, tolerating up to ``scale/2`` contrary samples
inside a run (single glitches don't break a pulse), emits
``round(run/scale)`` copies of each bit, and accumulates
``sum |run/scale - round(run/scale)|`` as a clock-error metric.  Like the
reference it is a library helper with no CLI command.

The walk is sequential with data-dependent control flow, so it runs on
the host, in numpy over run-length windows, as in the JAX package.
"""

from __future__ import annotations

import numpy as np


def run_of(data, scale: int, val: bool) -> int:
    """Length of the run of ``val`` at the start of ``data``, tolerating
    short contrary bursts of up to ``scale`` samples (``src/bits.rs:40-55``)."""
    bad = 0
    for i, bit in enumerate(data):
        if bool(bit) != val:
            bad += 1
        else:
            bad = 0
        if bad > scale:
            return i + 1 - bad
    return len(data)


def scan(data, scale: float) -> tuple[float, list[bool]]:
    """Decode a pulse train into bits (``src/bits.rs:3-38``).

    Returns ``(clock_error, bits)``.
    """
    data = np.asarray(data, dtype=bool)
    half = int(_rust_round(scale / 2.0))
    i = 0
    bit = False
    error = 0.0
    ret: list[bool] = []
    n = len(data)
    while i != n:
        found = _run_of_fast(data, i, half, bit)
        i += found
        if found <= half:
            if found == 0:
                # the stream opens with a long run of the other value; the
                # reference spins forever here (run_of returns 0 and nothing
                # advances, src/bits.rs:9-35): flip the expected bit instead
                bit = not bit
            continue
        bits = found / scale
        rounded = _rust_round(bits)
        error += abs(bits - rounded)
        ret.extend([bit] * int(rounded))
        bit = not bit
    return error, ret


def _rust_round(x: float) -> float:
    """f64::round: half away from zero (Python's round() is half-even)."""
    return float(np.floor(x + 0.5)) if x >= 0 else float(np.ceil(x - 0.5))


def _run_of_fast(data: np.ndarray, start: int, scale: int, val: bool) -> int:
    """:func:`run_of` on ``data[start:]`` without copying: the run ends
    where the first burst of more than ``scale`` consecutive contrary
    samples begins (the whole rest when there is none).

    The burst is searched block by block, each twice the one before, so a
    call costs about its run's length: one pass over the rest of the data
    a call would make a long pulse train cost runs x length."""
    sub = data[start:]
    n = len(sub)
    w = scale + 1  # a burst: a window of w samples, all contrary
    lo, step = 0, max(4 * w, 1 << 12)
    while lo + w <= n:
        hi = min(n - w + 1, lo + step)  # window starts lo .. hi - 1
        csum = np.concatenate([[0], np.cumsum(sub[lo : hi + w - 1] != val, dtype=np.int64)])
        full = np.flatnonzero(csum[w:] - csum[:-w] == w)
        if len(full):
            return lo + int(full[0])
        lo, step = hi, 2 * step
    return n
