"""Short-time FFT magnitudes, fftshift and the Blackman-Harris window.

The reference runs rustfft's forward transform (standard unnormalized
DFT, negative exponent) per window (``src/fft.rs:25-32``) and displays
fftshifted magnitudes (``src/fft.rs:48-52``).  Here the transform is
``torch.fft.fft`` (cuFFT on the card), which keeps full f32 precision:
no TF32 is involved.
"""

from __future__ import annotations

import math

import numpy as np
import torch

TAU = 2.0 * math.pi


def fftshift(x: torch.Tensor) -> torch.Tensor:
    """Swap halves along the last axis (``src/fft.rs:48-52`` semantics)."""
    half = x.shape[-1] // 2
    return torch.cat([x[..., half:], x[..., :half]], dim=-1)


def stft_norms(x: torch.Tensor, *, shift: bool = True) -> torch.Tensor:
    """Magnitudes of the DFT of each row: ``x`` is (B, W) complex64
    windows, the result (B, W) f32 norms, fftshifted unless
    ``shift=False``.  The magnitude is ``sqrt(re² + im²)`` on the real
    planes, as the JAX package computes it."""
    spec = torch.fft.fft(x, dim=-1)
    rr, ri = spec.real, spec.imag
    if shift:
        rr, ri = fftshift(rr), fftshift(ri)
    return torch.sqrt(rr * rr + ri * ri)


def blackman_harris_window(n: int) -> np.ndarray:
    """4-term Blackman-Harris window, f32 (``src/ffts.rs:110-119``)."""
    i = np.arange(n, dtype=np.float32)
    x = np.float32(TAU) * i / np.float32(n - 1)
    return (
        np.float32(0.35875)
        - np.float32(0.48829) * np.cos(x)
        + np.float32(0.14128) * np.cos(np.float32(2.0) * x)
        - np.float32(0.01168) * np.cos(np.float32(3.0) * x)
    ).astype(np.float32)
