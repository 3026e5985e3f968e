"""The lazy stream graph: the counterpart of ``quadrs_tpu.stream``, after
the reference's ``Samples`` trait (``src/samples.rs:11-28``).

The reference models DSP as pull-based random access: every stage has
``len() / sample_rate() / read_at(off, buf)`` and computes on demand,
recursing down the wrapper stack.  The same semantics are split into two
phases, as in the JAX package:

* **plan (host)**: for a batch of absolute window offsets, each node
  resolves everything offset-dependent with exact integer arithmetic:
  source spans, valid sample counts (the reference's short reads), and
  NCO phases ``(f*off) mod sr`` (so f32 trig stays accurate at any
  offset; the reference gets this from f64 phase, ``src/shift.rs:49``).

* **read_batch (device)**: torch ops computing a whole ``(B, n)``
  complex64 batch of windows on the device of the staged buffer.  Stages
  compose by ordinary calls.

Valid-count invariant: every node's output past its source-derived valid
count is exactly zero (sources mask), while stages that shrink validity
(LowPass) leave entries in ``[valid, n)`` unspecified; consumers mask by
the host-side valid counts.  This reproduces the reference's truncated
convolution at block edges bit for bit: ``complex_convolve`` skips
out-of-buffer taps (``src/filter.rs:116``), which is convolving a
zero-padded block.

The conditioning stages (``DcBlock``, ``Agc``, ``IqCorrect``) and the
rational resampler (``Resample``) are the JAX package's additions; unlike
LowPass they are pull-size invariant: a read re-reads the lookback it
needs.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from quadrs_tpu_torch.ops.nco import ExactNCO, mix, rotate
from quadrs_tpu_torch.ops.rowscan import row_exclusive_prefix, row_mean
from quadrs_tpu_torch.ops.tables import device_table


@dataclass
class Plan:
    """Host-side plan for one batch of windows."""

    prep: Any  # nested dict of numpy arrays; the Executor moves it to the device
    valid: np.ndarray  # (B,) int64: how many leading samples are real


class Stream:
    """A node in the lazy stream graph.

    ``length`` (samples) and ``sample_rate`` (Hz) mirror the reference
    trait.  ``length`` may over-report just as the reference's
    ``LowPass::len`` does (``src/filter.rs:45-48``); reads report the
    true valid count.
    """

    length: int
    sample_rate: int
    has_staging = False  # True for sources the Executor stages from

    # -- host planning ----------------------------------------------------
    def request(self, off: int, n: int) -> tuple[int, int]:
        """The (offset, count) of ``inner`` that a read of ``n`` outputs at
        ``off`` pulls: a stage's one mapping, which :meth:`span` and
        :meth:`reads` compose down to the root."""
        raise NotImplementedError

    def span(self, off: int, n: int) -> tuple[int, int]:
        """Map an output span to the (offset, count) the root source
        stages, composing through all stages: ``(0, 0)`` below a
        generator, which stages nothing."""
        return self.inner.span(*self.request(off, n))

    def reads(self, off: int, n: int) -> int:
        """The root samples one read of ``n`` outputs at ``off`` makes the
        root produce, composing through all stages: a capture's staged
        samples, a generator's generated ones (what the executor's gather
        cap counts, :func:`~quadrs_tpu_torch.runtime.root_read_of`)."""
        return self.inner.reads(*self.request(off, n))

    def plan(self, offs: np.ndarray, n: int, base: int) -> Plan:
        """Host planning for window offsets ``offs`` (int64, shape (B,)) of
        length ``n``.  ``base`` is the absolute root-source sample offset
        at which the staged buffer begins."""
        raise NotImplementedError

    # -- device compute ---------------------------------------------------
    def read_batch(self, ctx: dict, prep: Any, n: int) -> torch.Tensor:
        """The batch on the device: ``(B, n)`` complex64.  ``ctx``: the
        staged root buffer (``"buf"``) and the device (``"device"``);
        ``prep``: :meth:`plan`'s arrays as tensors on that device."""
        raise NotImplementedError

    # -- graph helpers ----------------------------------------------------
    def root(self) -> "Stream":
        node = self
        while hasattr(node, "inner"):
            node = node.inner
        return node

    def read_at(self, off: int, n: int, device) -> tuple[np.ndarray, int]:
        """One window (``Samples::read_at``) computed on ``device``:
        ``(samples[:n] complex64, valid)``.  Sinks batch through
        :class:`quadrs_tpu_torch.runtime.Executor` directly."""
        from quadrs_tpu_torch.runtime import Executor

        out, valid = Executor(self, n, device).run(np.asarray([off], dtype=np.int64))
        return out[0], int(valid[0])


class Shift(Stream):
    """NCO frequency shifter (reference ``src/shift.rs``).

    Multiplies sample ``m`` (absolute index) by ``e^{j·2π·f·m/sr}``.  The
    angle is planned on the host: ``(f·m) mod sr`` exactly for the
    window's first sample and for each in-window index; the device adds
    the two in f32, takes f32 cos/sin and rotates
    (:func:`~quadrs_tpu_torch.ops.nco.mix`), so that a window's samples do
    not depend on the windows batched with it.  The in-window angles are a
    table kept on the device (:func:`~quadrs_tpu_torch.ops.tables.device_table`).
    """

    def __init__(self, inner: Stream, frequency: int, sample_rate: int | None = None):
        sample_rate = inner.sample_rate if sample_rate is None else sample_rate
        # reference src/shift.rs:20-24
        if not abs(frequency) < sample_rate // 2:
            raise ValueError("frequency must be under half the sample rate")
        if sample_rate <= 0:
            raise ValueError("sample rate must be positive")
        self.inner = inner
        self.frequency = int(frequency)
        self.sample_rate = int(sample_rate)
        self.length = inner.length
        self._nco = ExactNCO(self.frequency, self.sample_rate)

    def request(self, off: int, n: int) -> tuple[int, int]:
        return off, n

    def plan(self, offs: np.ndarray, n: int, base: int) -> Plan:
        inner = self.inner.plan(offs, n, base)
        prep = {"inner": inner.prep, "theta0": self._nco.angles(offs)}
        return Plan(prep=prep, valid=inner.valid)

    def read_batch(self, ctx: dict, prep: Any, n: int) -> torch.Tensor:
        x = self.inner.read_batch(ctx, prep["inner"], n)
        delta = device_table("nco.delta", (self.frequency, self.sample_rate, n), x.device,
                             lambda: self._nco.angles(np.arange(n, dtype=np.int64)))
        return mix(x, prep["theta0"][:, None] + delta[None, :])


class LowPass(Stream):
    """Windowed-sinc FIR low-pass and decimator (reference ``src/filter.rs``).

    A read of ``n`` outputs at offset ``off`` pulls ``n*decimate + taps``
    samples at ``off*decimate`` and evaluates

        y[i] = sum_j x[i*D + ceil(taps/2) + j] * h[j]

    (the reference's ``convoluted[taps + i*decimate]`` pick,
    ``src/filter.rs:68-80``).  Taps past the read's valid samples see
    zeros: the reference's per-read truncation (``src/filter.rs:116``),
    so outputs near the end of each pulled block are computed against a
    zero tail even where the stream goes on, and the sinks' pull sizes
    decide where those boundaries fall.

    ``fir_impl``: ``auto`` (what the CLI uses) or one of
    :func:`~quadrs_tpu_torch.ops.fir.fir_decimate`'s impls, forced so
    that tests can hold each against the JAX package's.
    """

    def __init__(self, inner: Stream, frequency: int, decimate: int, size: int, *, fir_impl: str = "auto"):
        from quadrs_tpu_torch.ops.fir import lowpass_taps

        if decimate <= 0:
            raise ValueError("decimate must be positive")
        self.inner = inner
        self.decimate = int(decimate)
        self.frequency = int(frequency)
        self.size = int(size)
        self.fir_impl = fir_impl
        self.sample_rate = inner.sample_rate // self.decimate
        # reference src/filter.rs:45-48: over-reports the readable length
        if inner.length < self.size:
            raise ValueError("input shorter than the filter")
        self.length = 1 + (inner.length - self.size) // self.decimate
        self.taps = lowpass_taps(self.frequency / inner.sample_rate, self.size)  # src/filter.rs:126-128

    def request(self, off: int, n: int) -> tuple[int, int]:
        return off * self.decimate, n * self.decimate + self.size

    def plan(self, offs: np.ndarray, n: int, base: int) -> Plan:
        offs = np.asarray(offs, dtype=np.int64)
        inner = self.inner.plan(offs * self.decimate, n * self.decimate + self.size, base)
        valid_out = np.maximum(inner.valid - self.size, 0) // self.decimate
        return Plan(prep={"inner": inner.prep, "valid_in": inner.valid}, valid=valid_out)

    def read_batch(self, ctx: dict, prep: Any, n: int) -> torch.Tensor:
        from quadrs_tpu_torch.ops.fir import fir_decimate

        n_in = n * self.decimate + self.size
        x = self.inner.read_batch(ctx, prep["inner"], n_in)
        # the truncated block the reference convolves: zero past this read
        keep = torch.arange(n_in, device=x.device)[None, :] < prep["valid_in"][:, None]
        return fir_decimate(torch.where(keep, x, 0), self.taps, self.decimate, n, impl=self.fir_impl)


def _tw_indices(lead: torch.Tensor, n: int, window: int):
    """Per-row block indices for trailing windows ``(m-W, m]``.

    ``lead[r]`` is the block index of row ``r``'s first output sample
    (``W-1`` once the stream has warmed up; less only for windows that
    start within the first ``W-1`` samples, where the lookback clamps at
    offset 0).  Returns ``(idx, hi, lo)``: ``idx`` addresses output samples
    in the input block, ``hi``/``lo`` an exclusive prefix sum, so that
    ``cs[hi] - cs[lo]`` is each output position's trailing-window sum."""
    idx = lead[:, None].to(torch.int64) + torch.arange(n, device=lead.device)[None, :]
    hi = idx + 1
    return idx, hi, (hi - window).clamp_(min=0)


def _tw_count(abs_c: torch.Tensor, n: int, window: int) -> torch.Tensor:
    """(B, n) f32 sample count of each trailing window: ``min(W, m+1)`` at
    absolute position ``m``.  ``abs_c``, the absolute position of each
    row's first output, is clipped to ``W`` on the host."""
    m1 = abs_c[:, None].to(torch.int64) + torch.arange(n, device=abs_c.device)[None, :] + 1
    return m1.clamp_(max=window).to(torch.float32)


def _trailing_sums(v: torch.Tensor, prep: Any, n: int, window: int, sub: torch.Tensor | None = None) -> torch.Tensor:
    """Each output position's sum of ``v - sub`` (``sub``: an optional value
    a row) over its trailing window, from one prefix sum over the block
    (:func:`~quadrs_tpu_torch.ops.rowscan.row_exclusive_prefix`: on the card
    a kernel whose order is fixed by the block's length, so a window's sums
    do not depend on the windows batched with it)."""
    cs = row_exclusive_prefix(v, sub)
    _, hi, lo = _tw_indices(prep["lead"], n, window)
    return torch.gather(cs, 1, hi) - torch.gather(cs, 1, lo)


class _Trailing(Stream):
    """Shared plumbing for stages conditioned on a trailing window of the
    last ``W`` input samples (the current one included): exact random
    access (the lookback is re-read, clamped at the stream start), so
    outputs do not depend on the pull size, unlike LowPass's per-read
    truncation."""

    window: int

    def __init__(self, inner: Stream, window: int):
        if window < 1:
            raise ValueError("window must be at least 1")
        self.inner = inner
        self.window = int(window)
        self.length = inner.length
        self.sample_rate = inner.sample_rate

    def request(self, off: int, n: int) -> tuple[int, int]:
        # the block the plan reads: n + W - 1 samples from the clamped start,
        # so the staged span holds all of it (a span cut at the window's end
        # would leave the block's tail to the source's clamped gather, and the
        # first windows' rounding to the rows batched with them)
        return max(0, off - (self.window - 1)), n + self.window - 1

    def plan(self, offs: np.ndarray, n: int, base: int) -> Plan:
        offs = np.asarray(offs, dtype=np.int64)
        back = self.window - 1
        offs_in = np.maximum(offs - back, 0)
        lead = offs - offs_in
        inner = self.inner.plan(offs_in, n + back, base)
        valid_out = np.clip(inner.valid - lead, 0, n)
        prep = {
            "inner": inner.prep,
            "lead": lead,
            "abs_c": np.minimum(offs, self.window),
            "valid_out": valid_out,
        }
        return Plan(prep=prep, valid=valid_out)

    @staticmethod
    def _mask_valid(y: torch.Tensor, prep: Any, n: int) -> torch.Tensor:
        """Outputs past the source-derived valid count are exactly zero (a
        trailing mean or gain would otherwise leak into the padding)."""
        keep = torch.arange(n, device=y.device)[None, :] < prep["valid_out"][:, None]
        return torch.where(keep, y, 0)

    def _inner_block(self, ctx: dict, prep: Any, n: int) -> torch.Tensor:
        # contiguous rows: the row-scan kernels read them flat
        return self.inner.read_batch(ctx, prep["inner"], n + self.window - 1).contiguous()

    def _current(self, x: torch.Tensor, prep: Any, n: int) -> torch.Tensor:
        """Each output position's own input sample."""
        idx, _, _ = _tw_indices(prep["lead"], n, self.window)
        return torch.gather(x, 1, idx)


class DcBlock(_Trailing):
    """DC-offset remover (the JAX package's addition; no reference
    counterpart).  Subtracts from each sample the mean of the trailing
    ``window`` input samples (inclusive):

        y[m] = x[m] - mean(x[max(0, m-W+1) .. m])

    The trailing sum is a difference of two prefix-sum lookups over each
    pulled block, taken about the block's mean: ``x - mean(x)`` has the
    same trailing deviations, and its f32 prefix does not grow with a
    baseline (cu8's decode parks every sample near -127, where the JAX
    package's prefix of ``x`` itself loses 1.8e-2 of the output at window 7
    against the f64 formula; this stays within 2.1e-5 of it, 2.4e-7 at
    cf32 and cs8)."""

    def read_batch(self, ctx: dict, prep: Any, n: int) -> torch.Tensor:
        x = self._inner_block(ctx, prep, n)
        if self.window == 1:  # the trailing window is the sample itself
            return torch.zeros((x.shape[0], n), dtype=x.dtype, device=x.device)
        # the block's mean, subtracted as the prefix sum loads the block (on
        # the card it is never written out) and from each output's own sample
        mean = row_mean(x)
        dc = _trailing_sums(x, prep, n, self.window, sub=mean) / _tw_count(prep["abs_c"], n, self.window)
        return self._mask_valid((self._current(x, prep, n) - mean) - dc, prep, n)


class Agc(_Trailing):
    """Automatic gain control (the JAX package's addition).  Normalizes the
    trailing-window RMS to ``target``:

        rms[m] = sqrt(mean(|x[k]|^2, k in (m-W, m]))
        y[m]   = x[m] * target / max(rms[m], target / max_gain)

    Instant attack, ``window``-shaped decay; ``max_gain`` stops silence
    from being amplified into noise."""

    def __init__(self, inner: Stream, target: float = 1.0, window: int = 4_000, max_gain: float = 1000.0):
        super().__init__(inner, window)
        if not target > 0:
            raise ValueError("target must be positive")
        if not max_gain > 0:
            raise ValueError("max-gain must be positive")
        self.target = float(target)
        self.max_gain = float(max_gain)

    def _gain(self, rms: torch.Tensor) -> torch.Tensor:
        return self.target / torch.clamp(rms, min=self.target / self.max_gain)

    def read_batch(self, ctx: dict, prep: Any, n: int) -> torch.Tensor:
        x = self._inner_block(ctx, prep, n)
        if self.window == 1:
            # the direct magnitude: a prefix-sum difference would carry the
            # prefix's cancellation noise for nothing
            return self._mask_valid(x * self._gain(torch.sqrt(x.real**2 + x.imag**2)), prep, n)
        psum = _trailing_sums(x.real**2 + x.imag**2, prep, n, self.window)
        rms = torch.sqrt(torch.clamp(psum, min=0.0) / _tw_count(prep["abs_c"], n, self.window))
        return self._mask_valid(self._current(x, prep, n) * self._gain(rms), prep, n)


class IqCorrect(Stream):
    """IQ-imbalance corrector (the JAX package's addition): the
    widely-linear correction

        y[m] = x[m] - c * conj(x[m])

    with ``c`` given, or blind-estimated once at construction from the
    capture's leading samples by the mean-centred circularity ratio

        z = x - E[x],    rho = E[z^2] / E[|z|^2],    c = rho / 2

    on the host in f64 (centring keeps a DC offset, such as the cu8/cs16
    decode formulas' parked baseline, from reading as an image).  The
    estimate's read runs on ``device``.  The product is
    :func:`~quadrs_tpu_torch.ops.nco.rotate`'s, with ``c`` rounded to
    complex64, as the JAX package rounds it."""

    def __init__(self, inner: Stream, c: complex | None = None, est_samples: int = 256_000, *, device: torch.device | str):
        self.inner = inner
        self.length = inner.length
        self.sample_rate = inner.sample_rate
        if c is None:
            n = int(min(est_samples, inner.length))
            if n < 2:
                raise ValueError("capture too short to estimate IQ imbalance")
            x, valid = inner.read_at(0, n, device)
            x = np.asarray(x[:valid], dtype=np.complex128)
            x = x - x.mean()
            denom = float(np.sum(np.abs(x) ** 2))
            if denom == 0.0:
                raise ValueError("constant capture: cannot estimate IQ imbalance")
            rho = complex(np.sum(x * x) / denom)
            if abs(rho) > 0.9:
                raise ValueError(
                    f"circularity ratio |E[x^2]|/E[|x|^2] = {abs(rho):.3f}: "
                    "the signal is nearly non-circular (e.g. pure real/AM "
                    "at DC), so blind estimation would cancel the signal "
                    "itself — pass an explicit coefficient instead"
                )
            c = rho / 2.0
        self.c = complex(c)

    def request(self, off: int, n: int) -> tuple[int, int]:
        return off, n

    def plan(self, offs: np.ndarray, n: int, base: int) -> Plan:
        inner = self.inner.plan(offs, n, base)
        return Plan(prep={"inner": inner.prep}, valid=inner.valid)

    def read_batch(self, ctx: dict, prep: Any, n: int) -> torch.Tensor:
        x = self.inner.read_batch(ctx, prep["inner"], n)
        c = np.complex64(self.c)
        return x - rotate(torch.conj(x), float(c.real), float(c.imag))


class Resample(Stream):
    """Rational sample-rate converter (the JAX package's addition; the
    reference only decimates).

    Converts by ``up/down`` (reduced by their gcd): zero-stuff by L,
    Blackman-sinc anti-alias and anti-image FIR at the upsampled rate
    (cutoff ``min(1/(2L), 1/(2M))``, gain L), every M-th output with the
    house group-delay pick; :mod:`quadrs_tpu_torch.ops.resample` has the
    formula and the device products.  Unlike LowPass's over-report,
    ``length`` is the exact readable output count, so ``write`` ends
    cleanly."""

    def __init__(self, inner: Stream, up: int, down: int, *, size: int | None = None, power: int = 8):
        from quadrs_tpu_torch.ops.resample import resample_tables

        if up <= 0 or down <= 0:
            raise ValueError("up/down must be positive")
        g = math.gcd(int(up), int(down))
        self.up = int(up) // g
        self.down = int(down) // g
        out_rate_num = inner.sample_rate * self.up
        if out_rate_num % self.down:
            raise ValueError(f"resample {self.up}/{self.down} of {inner.sample_rate} Hz gives a non-integer sample rate")
        self.inner = inner
        self.sample_rate = out_rate_num // self.down
        self.size = int(size) if size is not None else 2 * int(power) * max(self.up, self.down)
        if self.size < 2:
            raise ValueError("filter size must be at least 2")
        if inner.length * self.up < self.size:
            raise ValueError("input shorter than the resampling filter")
        _, self._gamma_min, self._frame_len, self._d = resample_tables(self.size, self.up, self.down)
        # exact readable length: output j*L + r needs window-relative input
        # through j*M + d[0, r]; the shortest phase's first unreadable index
        # is the valid-prefix count (window at offset 0)
        avail = inner.length - self._gamma_min
        jmax = (avail - 1 - self._d[0]) // self.down
        self.length = max(0, int(np.min((jmax + 1) * self.up + np.arange(self.up))))

    def _n_in(self, n: int) -> int:
        nb = -(-n // self.up)
        return (nb - 1) * self.down + self._frame_len

    def request(self, off: int, n: int) -> tuple[int, int]:
        return (off // self.up) * self.down + self._gamma_min, self._n_in(n)

    def plan(self, offs: np.ndarray, n: int, base: int) -> Plan:
        offs = np.asarray(offs, dtype=np.int64)
        w = offs % self.up
        inner_offs = (offs // self.up) * self.down + self._gamma_min
        inner = self.inner.plan(inner_offs, self._n_in(n), base)
        valid_in = inner.valid.astype(np.int64)
        jmax = (valid_in[:, None] - 1 - self._d[w]) // self.down
        first_bad = np.min((jmax + 1) * self.up + np.arange(self.up), axis=1)
        valid_out = np.clip(first_bad, 0, n)
        return Plan(prep={"inner": inner.prep, "w_sel": w, "valid_in": valid_in}, valid=valid_out)

    def read_batch(self, ctx: dict, prep: Any, n: int) -> torch.Tensor:
        from quadrs_tpu_torch.ops.resample import resample_block

        n_in = self._n_in(n)
        x = self.inner.read_batch(ctx, prep["inner"], n_in)
        keep = torch.arange(n_in, device=x.device)[None, :] < prep["valid_in"][:, None]
        return resample_block(torch.where(keep, x, 0), prep["w_sel"], self.size, self.up, self.down, n)
