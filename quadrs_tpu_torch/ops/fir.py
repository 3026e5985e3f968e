"""FIR low-pass taps, and overlapped framing.

Tap math mirrors the reference exactly in f32 (``src/filter.rs:86-105``):
Blackman-windowed sinc, normalized to unit sum.  The decimating
convolution itself runs inside the fused frontend (:mod:`.frontend`).
"""

from __future__ import annotations

import numpy as np
import torch

_PI32 = np.float32(np.pi)


def overlapped_frames(x: torch.Tensor, hop: int, m: int, n_frames: int) -> torch.Tensor:
    """(..., L) -> (..., n_frames, m) frames at stride ``hop``, a view
    through ``Tensor.unfold`` where ``x`` is long enough.  Like the JAX
    package's ``_overlapped_frames``, ``x`` is first zero-padded to
    ``(n_frames + ceil(m / hop) - 1) * hop`` samples: a skipping stride
    (``hop > m``) needs that pad for its last frame's row."""
    need = (n_frames + -(-m // hop) - 1) * hop
    if x.shape[-1] < need:
        x = torch.nn.functional.pad(x, (0, need - x.shape[-1]))
    return x[..., :need].unfold(-1, m, hop)[..., :n_frames, :]


def lowpass_taps(cutoff: float, size: int) -> np.ndarray:
    """Blackman-windowed sinc taps, f32, unit-sum normalized.

    ``cutoff`` is frequency / sample_rate (``src/filter.rs:126-128``);
    formulas and op order follow ``src/filter.rs:86-105`` in f32.

    Odd sizes diverge deliberately: the reference's ``sin(0)/0`` center
    tap is NaN there (its CLI only produces even sizes, 2*power or 40),
    while this defines sinc(0)=1 so odd sizes are usable.
    """
    if size < 2:
        raise ValueError("filter size must be at least 2")
    c = np.float32(cutoff)
    i = np.arange(size, dtype=np.float32)
    sz = np.float32(size)

    x = np.float32(2.0) * c * (i - (sz - np.float32(1.0)) / np.float32(2.0))
    xpi = x * _PI32
    safe = np.where(xpi == 0, np.float32(1.0), xpi)  # avoid a 0/0 warning
    sinc = np.where(xpi == 0, np.float32(1.0), np.sin(safe) / safe)

    t = np.float32(2.0) * _PI32 * i / (sz - np.float32(1.0))
    window = (
        np.float32(0.42)
        - np.float32(0.5) * np.cos(t)
        + np.float32(0.08) * np.cos(np.float32(2.0) * t)
    )

    taps = (sinc * window).astype(np.float32)
    return (taps / taps.sum(dtype=np.float32)).astype(np.float32)
