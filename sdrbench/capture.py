"""Seeded cs8 captures: a binary FSK burst train near the configuration's
tone frequency, plus Gaussian noise, quantised to cs8
(interleaved int8 I and Q).  Made on the run's device with a
``torch.Generator`` seeded from ``--seed``, in blocks, so the same seed
gives the same bytes; the program reads them from a file and the
reference from the same bytes in memory."""

from __future__ import annotations

import math
import os

import torch

BLOCK = 1 << 24  # samples made at once


def _generator(seed: int, device: torch.device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 64))
    return g


def synthesize(signal: dict, sample_rate: int, samples: int, seed: int, device) -> torch.Tensor:
    """``samples`` cs8 samples as a (2 * samples,) uint8 tensor on ``device``.

    ``signal``: ``tone_hz`` (the FSK centre), ``deviation_hz`` (each symbol
    sits at centre plus or minus it), ``symbol_rate``, ``amplitude`` and
    ``noise_sigma`` (both in int8 steps, per component)."""
    device = torch.device(device)
    g = _generator(seed, device)
    sym_len = sample_rate // int(signal["symbol_rate"])
    n_sym = -(-samples // sym_len)
    bits = torch.randint(0, 2, (n_sym,), generator=g, device=device)
    freq = float(signal["tone_hz"]) + float(signal["deviation_hz"]) * (2.0 * bits.to(torch.float64) - 1.0)
    # phase continuous from symbol to symbol: each symbol starts where the
    # last one ended, in cycles, reduced to [0, 1)
    step = freq * sym_len / sample_rate
    start = torch.remainder(torch.cumsum(step, 0) - step, 1.0)
    amp, sigma = float(signal["amplitude"]), float(signal["noise_sigma"])
    out = torch.empty(2 * samples, dtype=torch.uint8, device=device)
    for lo in range(0, samples, BLOCK):
        n = min(BLOCK, samples - lo)
        m = torch.arange(lo, lo + n, dtype=torch.int64, device=device)
        k = m // sym_len
        t = (m - k * sym_len).to(torch.float64) / sample_rate
        cyc = torch.remainder(start[k] + freq[k] * t, 1.0)
        ph = (2.0 * math.pi) * cyc
        noise = torch.randn((2, n), generator=g, device=device, dtype=torch.float32) * sigma
        i = torch.round(amp * torch.cos(ph).to(torch.float32) + noise[0]).clamp_(-127, 127)
        q = torch.round(amp * torch.sin(ph).to(torch.float32) + noise[1]).clamp_(-127, 127)
        pair = torch.stack([i, q], dim=1).to(torch.int8).reshape(-1)
        out[2 * lo : 2 * (lo + n)] = pair.view(torch.uint8)
    return out


def write(data: torch.Tensor, path: str) -> None:
    """The bytes to ``path`` in one write from host memory, flushed to the
    disk before it returns, so that no writeback of them overlaps the
    measured window."""
    host = data.cpu().numpy()
    with open(path, "wb") as fh:
        fh.write(memoryview(host))
        fh.flush()
        os.fsync(fh.fileno())
