"""Rational resampler tables and products: sample-rate conversion by L/M.

The counterpart of ``quadrs_tpu.ops.resample``.  With the zero-stuffed
upsample ``u[n] = x[n/L] if L|n else 0`` and Blackman-sinc taps ``h`` of
length ``N`` (cutoff ``min(1/(2L), 1/(2M))`` of the upsampled rate, scaled
by ``L`` to keep the amplitude),

    y[i] = sum_j h[j] * u[i*M + c + j],     c = N - N//2

(the house FIR's correlation with its group-delay pick, so
``Resample(up=1, down=M)`` computes ``LowPass(sr/(2M), M, N)``'s sums).
Only every L-th tap meets data: outputs come in blocks of L, block ``j``
reads one input frame at stride M, and output ``jL + r`` of a window whose
first output offset is ``w`` mod L is ``frames[j] @ weights[w][:, r]``.

The tables are built on the host in numpy, bitwise as in the JAX package.
On the device, ``weights[w][:, r]`` depends on ``w + r`` alone, so every
phase class is a window of L columns of one ``(m, 2L - 1)`` matrix: a
batch takes one product against it and keeps each window's L columns.
Nothing materializes a weight matrix per window (the JAX package's
``jnp.take(weights, w_sel)`` does, ``m * L`` floats a window).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from quadrs_tpu_torch.ops.fir import lowpass_taps, overlapped_frames
from quadrs_tpu_torch.ops.frontend import no_tf32


@functools.lru_cache(maxsize=8)
def resample_tables(size: int, up: int, down: int):
    """The per-phase geometry and weight table.

    Returns ``(weights, gamma_min, frame_len, d)``:

    * ``weights``: (L, m, L) f32, ``y[jL + r] = frames[j] @ weights[w][:, r]``
      for a window starting at output offset ``off`` with ``w = off mod L``;
      frame ``j`` is ``x[a*M + gamma_min + j*M : ... + m]`` where
      ``a = (off - w) / L``.
    * ``gamma_min``: the first input sample (relative to ``a*M``) any phase
      touches.
    * ``frame_len`` (m): input samples per frame.
    * ``d``: (L, L) int64, output ``jL + r`` of a window with phase ``w``
      needs window-relative input samples through ``j*M + d[w, r]``
      inclusive: the exact valid counts.
    """
    l, m_ = int(up), int(down)
    n = int(size)
    cutoff = min(1.0 / (2 * l), 1.0 / (2 * m_))
    taps = lowpass_taps(cutoff, n) * np.float32(l)
    c = n - n // 2

    w_r = np.arange(l)[:, None] + np.arange(l)[None, :]  # (w, r) -> w + r
    phi = (-(w_r * m_ + c)) % l
    gamma = (w_r * m_ + c + phi) // l  # exact: the numerator is divisible by L
    q_count = -(-(n - phi) // l)  # taps per phase (ceil)
    gamma_min = int(gamma.min())
    frame_len = int((gamma - gamma_min + q_count).max())

    qmax = int(q_count.max())
    q = np.arange(qmax)
    tap_idx = phi[..., None] + q * l  # (L, L, qmax)
    ok = tap_idx < n
    t_idx = gamma[..., None] - gamma_min + q
    w_idx, r_idx = np.meshgrid(np.arange(l), np.arange(l), indexing="ij")
    w_idx = np.broadcast_to(w_idx[..., None], tap_idx.shape)
    r_idx = np.broadcast_to(r_idx[..., None], tap_idx.shape)
    weights = np.zeros((l, frame_len, l), dtype=np.float32)
    weights[w_idx[ok], t_idx[ok], r_idx[ok]] = taps[tap_idx[ok]]

    d = gamma - gamma_min + q_count - 1  # the last frame-relative index read
    return weights, gamma_min, frame_len, d.astype(np.int64)


@functools.lru_cache(maxsize=8)
def phase_columns(size: int, up: int, down: int) -> np.ndarray:
    """(m, 2L - 1) f32: column ``s`` is ``weights[w][:, r]`` for every
    ``w + r = s`` (the table's entries depend on ``w + r`` alone), so phase
    class ``w`` is columns ``w .. w + L - 1``."""
    weights, _, m, _ = resample_tables(size, up, down)
    l = int(up)
    cols = np.empty((m, 2 * l - 1), dtype=np.float32)
    cols[:, :l] = weights[0]
    cols[:, l - 1 :] = weights[:, :, l - 1].T
    return cols


def resample_block(x: torch.Tensor, w_sel: torch.Tensor, size: int, up: int, down: int, n_out: int) -> torch.Tensor:
    """Resample a batch of staged blocks.

    ``x``: (B, n_in) complex64, each window's input from ``a*M +
    gamma_min`` (host-planned), zero past its valid extent; ``w_sel``: (B,)
    phase classes (``off mod L``).  Returns (B, n_out) complex64 on ``x``'s
    device: one product of the frames against :func:`phase_columns` per
    plane, then each window's L columns, in full f32 on any route to it."""
    if x.is_cuda:
        no_tf32()
    l, m_ = int(up), int(down)
    _, _, m, _ = resample_tables(size, l, m_)
    nb = -(-n_out // l)
    frames = overlapped_frames(x, m_, m, nb)  # (B, nb, m)
    cols = torch.as_tensor(phase_columns(size, l, m_), device=x.device)
    pick = (w_sel.to(torch.int64)[:, None] + torch.arange(l, device=x.device)[None, :])[:, None, :]
    pick = pick.expand(-1, nb, -1)  # (B, nb, L): columns w .. w + L - 1

    def plane(p: torch.Tensor) -> torch.Tensor:
        return torch.gather(torch.matmul(p, cols), 2, pick)

    y = torch.complex(plane(frames.real), plane(frames.imag))
    return y.reshape(y.shape[0], nb * l)[:, :n_out]


def resample_real(audio: torch.Tensor, rate: int, target_rate: int, *, power: int = 8) -> tuple[int, torch.Tensor]:
    """Resample a whole real f32 signal from ``rate`` to ``target_rate`` Hz
    on ``audio``'s device: the demodulators' audio stage (FM/AM audio to a
    sound-device rate like 48 kHz, rarely an integer divisor of the
    channel rate).

    The tables of :func:`resample_tables` with the window at offset 0
    (phase class 0): one ``(frames, m) @ (m, L)`` product over the burst;
    the output length is the exact full-window count.  Identity when the
    rates already match."""
    rate, target_rate = int(rate), int(target_rate)
    if rate <= 0 or target_rate <= 0:
        raise ValueError("rates must be positive")
    if rate == target_rate:
        return rate, audio
    g = math.gcd(rate, target_rate)
    l, m_ = target_rate // g, rate // g
    size = 2 * int(power) * max(l, m_)
    weights, gamma_min, frame_len, d = resample_tables(size, l, m_)
    avail = len(audio) - gamma_min
    jmax = (avail - 1 - d[0]) // m_
    n_out = int(np.min((jmax + 1) * l + np.arange(l)))
    if n_out < 1:
        raise ValueError("audio shorter than the resampling filter")
    nb = -(-n_out // l)
    n_in = (nb - 1) * m_ + frame_len
    x = torch.zeros(n_in, dtype=torch.float32, device=audio.device)
    take = min(n_in, max(0, len(audio) - gamma_min))
    x[:take] = audio[gamma_min : gamma_min + take]
    if x.is_cuda:
        no_tf32()
    frames = overlapped_frames(x, m_, frame_len, nb)  # (nb, m)
    y = torch.matmul(frames, torch.as_tensor(weights[0], device=audio.device))
    return target_rate, y.reshape(-1)[:n_out]
