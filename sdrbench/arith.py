"""The benchmark's arithmetic: percentiles, interval unions, the spread of
repeated runs, and the least time the chains' work takes on the card.

The peaks are copied from the program's bench
(``quadrs_tpu_torch/bench_suite.py``: ``H100_F32_TFLOPS``,
``H100_HBM_GBPS``), and the conditioned chain's operation count follows its
``chain_flops_per_sample`` (the mix, the FIR and the spectra by the same
conventions), so that no later change to the program moves the
yardstick."""

from __future__ import annotations

import math
import statistics

# NVIDIA H100 SXM data sheet: float32 outside the tensor cores, HBM3
H100_F32_TFLOPS = 67.0
H100_HBM_GBPS = 3350.0


def percentile(values, q: float) -> float:
    """The ``q``-th percentile by linear interpolation between closest
    ranks (numpy's default)."""
    v = sorted(values)
    if not v:
        raise ValueError("percentile of no values")
    pos = (len(v) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def spread(values) -> float:
    """The distance between the first and third quartile as a share of the
    median, quartiles as ``statistics.quantiles(values, n=4)`` gives them."""
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def trimmed_spread(values) -> float:
    """``spread`` without the value farthest from the median, where that
    narrows it (as a check reads a set of runs)."""
    v = list(values)
    med = statistics.median(v)
    far = max(range(len(v)), key=lambda i: abs(v[i] - med))
    rest = v[:far] + v[far + 1 :]
    return min(spread(v), spread(rest)) if len(rest) >= 2 else spread(v)


def union_length(intervals) -> float:
    """Total length covered by ``(start, end)`` intervals."""
    total, end = 0.0, -math.inf
    for lo, hi in sorted(intervals):
        total += max(0.0, hi - max(lo, end))
        end = max(end, hi)
    return total


def merged(intervals) -> list[tuple[float, float]]:
    """``(start, end)`` intervals merged where they overlap or touch."""
    out: list[list[float]] = []
    for lo, hi in sorted(intervals):
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return [(a, b) for a, b in out]


# a streaming dcblock: running complex sum (add the new, drop the old: 4),
# its mean (2 divisions), the subtraction (2)
DCBLOCK_FLOPS = 8.0
# a streaming agc: |x|^2 (3), running sum (2), mean (1), sqrt (1), the floor
# (1), target / rms (1), the complex scale (2)
AGC_FLOPS = 11.0


def conditioned_flops_per_sample(taps: int, decimate: int, fft_width: int, stride: int) -> float:
    """FLOPs per input sample of shift -> FIR(decimate) -> dcblock -> agc ->
    STFT at window stride ``stride`` (in decimated samples).  Each
    decimated sample is computed once, as a streaming filter would compute
    it: the lookback a window re-reads is not counted.  The mix is a
    complex product (6), the FIR four operations a real tap a decimated
    output, the spectra ``5 W log2 W`` a complex FFT plus ``4 W`` for the
    norms, one window every ``stride`` decimated samples."""
    f = 6.0 + 4.0 * taps / decimate
    f += (DCBLOCK_FLOPS + AGC_FLOPS) / decimate
    f += (5.0 * fft_width * math.log2(fft_width) + 4.0 * fft_width) / (stride * decimate)
    return f


def least_seconds(flops: float, nbytes: float) -> tuple[float, str]:
    """The least time the card takes for the work: the larger of its f32
    operations over the f32 peak and its bytes over the HBM peak, and which
    of the two sets it."""
    t_f = flops / (H100_F32_TFLOPS * 1e12)
    t_b = nbytes / (H100_HBM_GBPS * 1e9)
    return (t_f, "flops") if t_f >= t_b else (t_b, "bytes")
