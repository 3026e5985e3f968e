"""Matched-filter cross-correlation: find a known pattern in a stream.

The counterpart of ``quadrs_tpu.ops.correlate`` (the JAX package's
addition; the reference has only energy detectors).  The score at offset
``n`` is the Cauchy-Schwarz ratio

    score[n] = |sum_m conj(p[m]) x[n+m]|^2 / (E_p * E_x[n])

with ``E_p = sum |p|^2`` and ``E_x[n] = sum_m |x[n+m]|^2``: in [0, 1], and
1 exactly when the window is a complex multiple of the pattern, so the
threshold is gain- and phase-invariant.  ``scale[n] = |corr[n]| / E_p``
is the match's amplitude relative to the pattern.

The correlation runs as overlap-save FFT convolution: the executor's
window length ``c`` (a power of two) is the FFT block, each window giving
``c - l + 1`` valid scores; the energy is a moving window over one f32
prefix sum.  The template spectra are computed on the host in f64 and
enter the device as f32 planes, bitwise the JAX package's.  Transforms
are ``torch.fft`` (cuFFT on the card); the JAX package's MXU DFT splits
and triangular-matmul prefix sums are TPU layouts and are not ported.
"""

from __future__ import annotations

import bisect
from typing import Callable

import numpy as np
import torch

from quadrs_tpu_torch.ops.fir import fixed_row_calls, spectral_product

_TINY = float(np.float32(1e-30))

# the most elements of one group of rows through the inverse FFT (128 MiB
# of complex64): a live pipe's 8-window batches take every row at once
ROW_GROUP = 1 << 24


class XCorr:
    """The device program of pattern search, in the parts that phase
    timing reads one at a time: :meth:`forward` (the windows' FFT),
    :meth:`energy` (moving energies, once per unique template length),
    :meth:`scores` (per row the product and inverse FFT, then the best
    normalized row a lag) and :meth:`extract` (the candidate scan).

    ``pattern``: one complex l-sample template (l >= 2, l <= c), or a
    sequence of P templates (a sync-word bank; lengths may differ, and the
    common lag range uses the longest).  ``freqs``: an optional
    carrier-offset grid in cycles per sample (F values): every template is
    premixed by each grid frequency on the host, giving P*F rows; row ``r``
    is pattern ``r // F`` at frequency ``r % F``."""

    def __init__(self, pattern, c: int, freqs: np.ndarray | None = None):
        if isinstance(pattern, (list, tuple)):
            pats = [np.asarray(p, dtype=np.complex128) for p in pattern]
        else:
            arr = np.asarray(pattern, dtype=np.complex128)
            pats = [arr] if arr.ndim == 1 else list(arr)  # (P, l) also accepted
        for p in pats:
            if len(p) < 2:
                raise ValueError("pattern must have at least 2 samples")
            if len(p) > c:
                raise ValueError(f"pattern ({len(p)}) longer than the window ({c})")
        self.c = int(c)
        self.n_out = self.c - max(len(p) for p in pats) + 1
        grid = np.zeros(1) if freqs is None else np.asarray(freqs, dtype=np.float64)
        rows, row_inv_ep, row_len = [], [], []
        for p in pats:
            e_p = float(np.sum(np.abs(p) ** 2))
            if e_p <= 0.0:
                raise ValueError("pattern is all zero")
            m = np.arange(len(p), dtype=np.float64)
            for f in grid:
                rows.append(np.conj(np.fft.fft(p * np.exp(2j * np.pi * ((f * m) % 1.0)), self.c)))
                row_inv_ep.append(1.0 / e_p)
                row_len.append(len(p))
        pf = np.stack(rows)  # (R, c)
        self.planes = np.stack([pf.real, pf.imag]).astype(np.float32)  # (2, R, c)
        self.inv_ep = np.asarray(row_inv_ep, dtype=np.float32)
        self.inv_ep2 = (self.inv_ep.astype(np.float64) ** 2).astype(np.float32)
        self.row_len = row_len
        self.lens = sorted(set(row_len))
        self.den_idx = [self.lens.index(l_k) for l_k in row_len]
        self._on: dict[torch.device, tuple[torch.Tensor, ...]] = {}

    @property
    def rows(self) -> int:
        return len(self.row_len)

    def on(self, device: torch.device) -> tuple[torch.Tensor, ...]:
        """The tables on ``device``, copied there once: the (R, c) complex64
        template spectra, each row's 1/E_p and 1/E_p^2, and each row's
        index into :meth:`energy`'s lengths."""
        if device not in self._on:
            planes = torch.as_tensor(self.planes, device=device)
            self._on[device] = (torch.complex(planes[0], planes[1]), torch.as_tensor(self.inv_ep, device=device),
                                torch.as_tensor(self.inv_ep2, device=device), torch.as_tensor(self.den_idx, device=device))
        return self._on[device]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return fixed_row_calls(lambda r: torch.fft.fft(r, dim=-1), x, 1)

    def energy(self, x: torch.Tensor) -> torch.Tensor:
        """(U, B, n_out) f32: the sum of |x|^2 over ``[n, n + l_k)`` for each
        of the U unique template lengths ``l_k``, from one prefix sum."""
        cs = torch.cumsum(x.real**2 + x.imag**2, dim=-1)
        n_out = self.n_out
        shifted = torch.cat([torch.zeros_like(cs[:, :1]), cs[:, : n_out - 1]], dim=-1)
        return torch.stack([cs[:, l_k - 1 : l_k - 1 + n_out] - shifted for l_k in self.lens])

    def _rows(self, xf: torch.Tensor, me: torch.Tensor, r0: int, r1: int) -> tuple[torch.Tensor, torch.Tensor]:
        """Rows ``r0..r1-1``: (score, |corr|^2), each (B, r1 - r0, n_out)."""
        spectra, inv_ep, inv_ep2, den_idx = self.on(xf.device)
        prod = spectral_product(xf[:, None, :], spectra[r0:r1][None])
        corr = fixed_row_calls(lambda r: torch.fft.ifft(r, dim=-1), prod, 2)[..., : self.n_out]
        num = corr.real**2 + corr.imag**2
        energy = me[0][:, None, :] if len(self.lens) == 1 else me.index_select(0, den_idx[r0:r1]).transpose(0, 1)
        # normalizing by E_p^2 maps a zero-energy window to score 0
        den = torch.clamp(energy * inv_ep[r0:r1, None], min=_TINY)
        return num * inv_ep2[r0:r1, None] / den, num

    def scores(self, xf: torch.Tensor, me: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """``(score, scale, ridx)``, each (B, n_out): the best normalized row
        a lag, with argmax's first-max rule; ``ridx = pattern_index * F +
        freq_index``.

        Rows go through the inverse FFT in groups of up to
        :data:`ROW_GROUP` elements a group (one group for a live pipe's
        small batches, a few for a fat dispatch).  Inside a group the first
        maximal row wins, a NaN score never; a later group replaces a lag's
        row only with a strictly greater score: the rule of visiting rows in
        ascending order with strict ``>``, from a running max of -1."""
        if self.rows == 1:
            score, num = (t[:, 0] for t in self._rows(xf, me, 0, 1))
            scale = torch.sqrt(num) * float(self.inv_ep[0])
            return score, scale, torch.zeros(score.shape, dtype=torch.int32, device=xf.device)
        shape = (xf.shape[0], self.n_out)
        score = torch.full(shape, -1.0, device=xf.device)  # below any score
        sc2 = torch.zeros(shape, device=xf.device)
        ridx = torch.zeros(shape, dtype=torch.int32, device=xf.device)
        g = max(1, ROW_GROUP // (xf.shape[0] * self.c))
        for r0 in range(0, self.rows, g):
            r1 = min(self.rows, r0 + g)
            s, num = self._rows(xf, me, r0, r1)
            best, arg = torch.max(torch.where(torch.isnan(s), -1.0, s), dim=1)
            better = best > score
            score = torch.where(better, best, score)
            # (scale)^2 of the winner: |corr|^2 / E_p^2 of its row
            s2 = torch.gather(num, 1, arg[:, None]).squeeze(1) * self.on(xf.device)[2][arg + r0]
            sc2 = torch.where(better, s2, sc2)
            ridx = torch.where(better, arg.to(torch.int32) + r0, ridx)
        return score, torch.sqrt(sc2), ridx

    def compute(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """A ``(B, c)`` complex64 window batch to ``(score, scale, ridx)``."""
        return self.scores(self.forward(x), self.energy(x))

    @staticmethod
    def extract(score, scale, ridx, left: torch.Tensor, threshold: float, k: int) -> tuple:
        """The candidate scan on the device over the batch as one contiguous
        row of M lags (window offsets abut by ``c - l + 1``): positions
        ``0..M-2`` that are ``>= threshold`` and ``>=`` both neighbours
        (``left``, the score left of the dispatch, is position 0's left
        neighbour).  Returns

            (vals, idx, scl, rid, count, s_first, s_m2, s_last, scale_last, ridx_last)

        the top ``min(k, M-1)`` masked scores with their flat positions and
        aux (non-candidates are -1, below any threshold in (0, 1]), the
        exact candidate count, and the boundary scalars that carry
        :class:`PeakScan`'s pending element across dispatches.  When
        ``count <= k`` the first ``count`` entries are exactly the
        candidates.  ``threshold`` must be an f32 value: the comparisons
        run in f32."""
        s = score.reshape(-1)
        m = s.shape[0]
        v = s[:-1]
        lefts = torch.cat([left.reshape(1).to(s.dtype), s[:-2]])
        mask = (v >= threshold) & (v >= lefts) & (v >= s[1:])
        w = torch.where(mask, v, -1.0)
        vals, idx = torch.topk(w, min(int(k), m - 1))
        flat_scale, flat_ridx = scale.reshape(-1), ridx.reshape(-1)
        return (vals, idx, flat_scale[idx], flat_ridx[idx], mask.sum(), s[0], s[m - 2], s[m - 1],
                flat_scale[m - 1], flat_ridx[m - 1])


def make_xcorr_post(
    pattern,
    c: int,
    freqs: np.ndarray | None = None,
    extract: tuple[float, int] | None = None,
) -> Callable:
    """Executor ``post`` for pattern search (:class:`XCorr`).

    Without ``extract``: ``post(x)`` maps a ``(B, c)`` complex window batch
    to ``(score, scale, ridx)``, each ``(B, c - l_max + 1)`` f32/f32/int32.
    With ``extract=(threshold, k)``: ``post(x, left)`` returns
    :meth:`XCorr.extract`'s tuple, so that the host touches only the
    candidates (``left``: the f32 score left of the dispatch, ``-inf`` on
    the first)."""
    xc = XCorr(pattern, c, freqs)
    if extract is None:
        return xc.compute
    thr, k = float(np.float32(extract[0])), int(extract[1])

    def post_extract(x: torch.Tensor, left: torch.Tensor) -> tuple:
        return xc.extract(*xc.compute(x), left, thr, k)

    return post_extract


class PeakScan:
    """Streaming local-maximum scanner over a score sequence.

    ``feed`` consumes contiguous score/aux chunks (offsets must abut); a
    point is a hit when ``score >= threshold`` and it is >= both
    neighbours.  Exact across chunk boundaries: the last element of every
    feed is held back until its right neighbour arrives (``finish``
    flushes it against -inf).  Vectorized in numpy."""

    def __init__(self, threshold: float):
        self.threshold = float(threshold)
        self._left = -np.inf  # score left of the pending element
        # pending (offset, score, aux row) awaiting its right neighbour
        self._pend: tuple[int, float, np.ndarray] | None = None
        self.offsets: list[int] = []
        self.scores: list[float] = []
        self.aux: list[np.ndarray] = []  # one row per hit (A columns)

    def feed(self, off0: int, scores: np.ndarray, aux: np.ndarray) -> None:
        scores = np.asarray(scores, dtype=np.float64)
        aux = np.asarray(aux, dtype=np.float64)
        if aux.ndim == 1:
            aux = aux[:, None]
        if len(scores) == 0:
            return
        if self._pend is not None:
            po, pv, pa = self._pend
            if off0 != po + 1:
                raise ValueError(f"non-contiguous feed: {off0} after {po}")
            ext = np.concatenate([[pv], scores])
            ext_aux = np.concatenate([pa[None, :], aux])
            ext_off0 = po
        else:
            ext, ext_aux, ext_off0 = scores, aux, off0
        if len(ext) >= 2:
            v = ext[:-1]
            lefts = np.concatenate([[self._left], ext[:-2]])
            rights = ext[1:]
            mask = (v >= self.threshold) & (v >= lefts) & (v >= rights)
            idx = np.nonzero(mask)[0]
            self.offsets.extend((ext_off0 + idx).tolist())
            self.scores.extend(v[idx].tolist())
            self.aux.extend(ext_aux[idx])
            self._left = float(ext[-2])
        self._pend = (ext_off0 + len(ext) - 1, float(ext[-1]), ext_aux[-1])

    @property
    def carry(self) -> float:
        """Score immediately left of the next feed's first element: the
        ``left`` input of a device-extracted dispatch."""
        return self._pend[1] if self._pend is not None else -np.inf

    def feed_extract(self, off0: int, m: int, res: tuple) -> bool:
        """Consume one device-extracted dispatch covering lags ``[off0,
        off0+m)`` (``res``: :meth:`XCorr.extract`'s tuple).  The dispatch
        decided positions ``0..m-2`` itself (its ``left`` input must have
        been :attr:`carry`); this decides the held-back pending element
        against the dispatch's first score and holds position ``m-1``
        pending: the same candidates as feeding the full score rows through
        :meth:`feed`.  Returns False when the candidate count overflowed the
        program's top-k width (the caller re-runs that dispatch
        full-score)."""
        (vals, idx, scl, rid, count, s_first, s_m2, s_last, scale_last, ridx_last) = res
        n = int(count)
        if n > len(np.asarray(vals)):
            return False
        if self._pend is not None:
            po, pv, pa = self._pend
            if off0 != po + 1:
                raise ValueError(f"non-contiguous feed: {off0} after {po}")
            if pv >= self.threshold and pv >= self._left and pv >= float(s_first):
                self.offsets.append(po)
                self.scores.append(pv)
                self.aux.append(pa)
        if n:
            # all n candidates sort ahead of the -1 padding, so the first n
            # rows are the hits; re-order them by lag position
            idx = np.asarray(idx[:n], dtype=np.int64)
            order = np.argsort(idx, kind="stable")
            self.offsets.extend((off0 + idx[order]).tolist())
            self.scores.extend(np.asarray(vals[:n], dtype=np.float64)[order].tolist())
            self.aux.extend(
                np.stack(
                    [np.asarray(scl[:n], dtype=np.float64)[order], np.asarray(rid[:n], dtype=np.float64)[order]],
                    axis=-1,
                )
            )
        self._left = float(s_m2)
        self._pend = (off0 + m - 1, float(s_last), np.array([float(scale_last), float(ridx_last)]))
        return True

    def finish(self) -> None:
        if self._pend is not None:
            po, pv, pa = self._pend
            if pv >= self.threshold and pv >= self._left:
                self.offsets.append(po)
                self.scores.append(pv)
                self.aux.append(pa)
            self._pend = None


def suppress(
    offsets: np.ndarray,
    scores: np.ndarray,
    min_distance: int,
    max_matches: int | None = None,
) -> np.ndarray:
    """Greedy non-maximum suppression: keep candidates best-first, dropping
    any within ``min_distance`` of an accepted one.  Returns the accepted
    indices sorted by offset."""
    order = np.argsort(-scores, kind="stable")
    taken: list[int] = []  # accepted offsets, sorted
    chosen: list[int] = []
    for i in order:
        if max_matches is not None and len(chosen) >= max_matches:
            break  # checked first, so max_matches=0 means zero matches
        o = int(offsets[i])
        j = bisect.bisect_left(taken, o)
        if j > 0 and o - taken[j - 1] < min_distance:
            continue
        if j < len(taken) and taken[j] - o < min_distance:
            continue
        taken.insert(j, o)
        chosen.append(int(i))
    chosen.sort(key=lambda i: int(offsets[i]))
    return np.asarray(chosen, dtype=np.int64)
