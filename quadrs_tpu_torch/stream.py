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

``DcBlock``, ``Agc``, ``IqCorrect`` and ``Resample`` of the JAX package
are not ported yet (ROADMAP A10).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from quadrs_tpu_torch.ops.nco import ExactNCO


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
    def span(self, off: int, n: int) -> tuple[int, int]:
        """Map an output span to the (offset, count) needed from the root
        source, composing through all stages."""
        raise NotImplementedError

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
    the two in f32 and takes f32 cos/sin.
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
        self._deltas: dict[int, np.ndarray] = {}

    def span(self, off: int, n: int) -> tuple[int, int]:
        return self.inner.span(off, n)

    def _delta(self, n: int) -> np.ndarray:
        if n not in self._deltas:
            self._deltas[n] = self._nco.angles(np.arange(n, dtype=np.int64))
        return self._deltas[n]

    def plan(self, offs: np.ndarray, n: int, base: int) -> Plan:
        inner = self.inner.plan(offs, n, base)
        prep = {"inner": inner.prep, "theta0": self._nco.angles(offs)}
        return Plan(prep=prep, valid=inner.valid)

    def read_batch(self, ctx: dict, prep: Any, n: int) -> torch.Tensor:
        x = self.inner.read_batch(ctx, prep["inner"], n)
        delta = torch.as_tensor(self._delta(n), device=x.device)
        theta = prep["theta0"][:, None] + delta[None, :]
        return x * torch.complex(torch.cos(theta), torch.sin(theta))


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

    def span(self, off: int, n: int) -> tuple[int, int]:
        return self.inner.span(off * self.decimate, n * self.decimate + self.size)

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
