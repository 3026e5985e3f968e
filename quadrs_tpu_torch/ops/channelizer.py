"""Polyphase channelizer: K equally spaced channels in one pass.

The counterpart of ``quadrs_tpu.ops.channelizer``.  Channel ``k`` of the
bank reproduces the composition ``Shift(-k*sr/K) -> LowPass(cutoff,
decimate=K, size=N)`` within f32 commutation: with the LowPass's
group-delay prefix ``c = N - N//2`` dropped and ``j = u*K + s``,

    b[i, s] = sum_u x[(i+u)*K + c + s] * h[u*K + s]      (U = ceil(N/K) shifted FMAs)
    y[i, k] = e^{-j2pi k c/K} * sum_s b[i, s] e^{-j2pi k s/K}

so the branch FIRs are ``U`` shifted multiply-adds over a ``(B, n, K)``
block (in the JAX package's order, u = 0 .. U-1) and the cross-branch
DFT is ``torch.fft.fft`` over the K axis (cuFFT on the card; the JAX
package's matmul DFT is a TPU layout, not ported).  Channel ``k`` is
centred at ``+k*sr/K`` (DFT-bin order: ``k >= K/2`` alias to ``(k-K)*sr/K``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from quadrs_tpu_torch.ops.nco import rotate


@functools.lru_cache(maxsize=16)
def _branch_taps(taps_key: bytes, k: int) -> np.ndarray:
    """(U, K) f32 branch-subfilter matrix hm[u, s] = h[u*K + s]."""
    taps = np.frombuffer(taps_key, dtype=np.float32)
    u = -(-len(taps) // k)
    hm = np.zeros(u * k, dtype=np.float32)
    hm[: len(taps)] = taps
    return hm.reshape(u, k)


@functools.lru_cache(maxsize=16)
def _center_phase(size: int, k: int) -> tuple[np.ndarray, np.ndarray]:
    """f32 planes of the group-delay phase e^{-j*2pi*k*c/K}, c=N-N//2."""
    c = size - size // 2
    ph = np.exp(-2j * np.pi * np.arange(k) * c / k)  # f64 on host
    return ph.real.astype(np.float32), ph.imag.astype(np.float32)


def branch_sums(x: torch.Tensor, taps: np.ndarray, k: int, n_out: int) -> torch.Tensor:
    """The branch FIRs: (B, n_out, K) complex64 ``b[i, s]`` from (B, n_in)
    complex64 ``x`` (zero past each block's valid extent).  The sums run on
    the real and imaginary planes, u = 0 .. U-1, one product and one add a
    step, as the JAX package adds them."""
    taps = np.asarray(taps, dtype=np.float32)
    size = len(taps)
    c = size - size // 2
    hm = torch.from_numpy(_branch_taps(taps.tobytes(), k)).to(x.device)[:, :, None]  # (U, K, 1)
    u = hm.shape[0]
    # drop the group-delay prefix; zeros past the end, so that every branch
    # FIR's last frame exists (zero taps and zero data beyond it)
    z = x[:, c:]
    rows_needed = n_out + u - 1
    need = rows_needed * k
    if z.shape[1] < need:
        z = torch.nn.functional.pad(z, (0, need - z.shape[1]))
    rows = torch.view_as_real(z[:, :need]).reshape(z.shape[0], rows_needed, k, 2)  # a view
    acc = rows[:, 0:n_out] * hm[0]
    for i in range(1, u):
        acc += rows[:, i : i + n_out] * hm[i]
    return torch.view_as_complex(acc)


def dft_phase(b: torch.Tensor, size: int, k: int) -> torch.Tensor:
    """The cross-branch DFT over the K axis, then each channel's
    group-delay phase: (B, n_out, K) complex64."""
    pr, pi = _center_phase(size, k)
    return rotate(torch.fft.fft(b, dim=-1), torch.from_numpy(pr).to(b.device), torch.from_numpy(pi).to(b.device))


def channelize_block(x: torch.Tensor, taps: np.ndarray, k: int, n_out: int) -> torch.Tensor:
    """All-channel filter bank over a batch of blocks.

    ``x``: (B, n_in) complex64 with ``n_in = n_out*k + len(taps)``; entries
    past each block's valid extent must already be zero (the caller masks,
    reproducing the reference's per-read truncated convolution).  Returns
    (B, n_out, k) complex64: channel ``ch`` of block ``b`` is ``out[b, :, ch]``.
    """
    return dft_phase(branch_sums(x, taps, k, n_out), len(taps), k)
