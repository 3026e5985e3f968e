"""Exact NCO phase planning — the single source of truth.

The angle of ``e^{j·2π·f·m/sr}`` at absolute sample ``m`` is reduced on
the host with integer arithmetic — ``((m mod P)·(f mod sr)) mod sr``
with ``P = sr/gcd(|f|, sr)`` — so one f32 ``cos``/``sin`` per sample on
device stays accurate (~1 ulp) at any stream offset.  Every NCO user of
the port (``models.receiver`` and ``ops.frontend``) plans through this
class; phases are never f32 sums on the device.

:func:`rotate` and :func:`mix` are the port's one complex product over a
batch of windows, so that a value depends on its own operands alone, not
on the batch's size, the row's place in it or the threads.  torch's CPU
complex64 ``*`` rounds its vector lanes and its scalar tail apart (a
value's last bit follows its flat index), so the CPU takes real planes;
the card computes each element of a complex product alone, and keeps it.
"""

from __future__ import annotations

import math

import numpy as np
import torch

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


def rotate(x: torch.Tensor, c, s) -> torch.Tensor:
    """``x * (c + js)``.  ``c``, ``s``: f32 tensors that broadcast against
    ``x``, or Python floats (f32 values).

    On the card, the complex product: one pass (real planes took 2.1-2.2x
    its time and 1.5-2x its temporaries on an H100), each element alone
    (``chip_smoke.py``'s ``batch_invariance`` holds it).  On the CPU, real
    planes in the order of the JAX package's complex product, ``(xr*c -
    xi*s) + j(xr*s + xi*c)``, in four passes: both planes times ``c``, both
    times ``s``, then the difference and the sum into the output's halves."""
    c, s = (torch.as_tensor(t, dtype=torch.float32, device=x.device) for t in (c, s))
    if x.is_cuda:
        return x * torch.complex(c, s)
    v = torch.view_as_real(x.resolve_conj())
    p, q = v * c[..., None], v * s[..., None]  # (xr*c, xi*c), (xr*s, xi*s)
    out = torch.empty_like(p)
    torch.sub(p[..., 0], q[..., 1], out=out[..., 0])
    torch.add(q[..., 0], p[..., 1], out=out[..., 1])
    return torch.view_as_complex(out)


def mix(x: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """``x`` rotated by the f32 angles ``theta``: f32 ``cos``/``sin``,
    then :func:`rotate`."""
    if x.is_cuda:
        # rotate's product, with cos and sin freed before it runs (arguments
        # passed to rotate would live through it: 0.5 GiB at a capped batch)
        return x * torch.complex(torch.cos(theta), torch.sin(theta))
    return rotate(x, torch.cos(theta), torch.sin(theta))
