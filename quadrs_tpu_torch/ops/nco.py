"""Exact NCO phase planning — the single source of truth.

The angle of ``e^{j·2π·f·m/sr}`` at absolute sample ``m`` is reduced on
the host with integer arithmetic — ``((m mod P)·(f mod sr)) mod sr``
with ``P = sr/gcd(|f|, sr)`` — so one f32 ``cos``/``sin`` per sample on
device stays accurate (~1 ulp) at any stream offset.  Every NCO user of
the port (``models.receiver`` and ``ops.frontend``) plans through this
class; phases are never f32 sums on the device.
"""

from __future__ import annotations

import math

import numpy as np

TAU = 2.0 * math.pi


class ExactNCO:
    def __init__(self, frequency: int, sample_rate: int):
        if sample_rate <= 0:
            raise ValueError("sample rate must be positive")
        self.frequency = int(frequency)
        self.sample_rate = int(sample_rate)
        g = math.gcd(abs(self.frequency), self.sample_rate)
        # gcd(0, sr) == sr, so a DC tone reduces every index to phase 0
        self.period = self.sample_rate // g
        self.f_mod = self.frequency % self.sample_rate
        # int64 fast path needs (i % period) * f_mod < 2^63; rates past
        # 2^31 (the reference accepts any u64, src/shift.rs:28) take the
        # arbitrary-precision host path — same exact reduction, Python
        # ints, only planned table sizes so the cost is negligible
        self._bigint = self.sample_rate >= (1 << 31)

    def angles(self, idx, dtype=np.float32) -> np.ndarray:
        """Exact angles for absolute sample indices ``idx``.

        ``idx`` may be any int-safe array or scalar; indices are first
        reduced mod the period so the modular product never overflows
        (int64 when sr < 2^31, Python bigints above — exact either way).
        """
        if self._bigint:
            i = np.asarray(idx).astype(object) % self.period
            frac = (i * self.f_mod) % self.sample_rate
            return (frac.astype(np.float64) * (TAU / self.sample_rate)).astype(dtype)
        i = np.asarray(idx, dtype=np.int64) % self.period
        frac = (i * self.f_mod) % self.sample_rate
        return (frac.astype(np.float64) * (TAU / self.sample_rate)).astype(dtype)

    def cis(self, idx) -> tuple[np.ndarray, np.ndarray]:
        """Host-exact ``(cos, sin)`` f32 tables at indices ``idx`` — the
        transcendentals run in f64 on the exact angles, so each entry is
        the correctly-rounded rotation factor."""
        t = self.angles(idx, dtype=np.float64)
        return np.cos(t).astype(np.float32), np.sin(t).astype(np.float32)
