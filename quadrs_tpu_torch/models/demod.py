"""Receivers: capture in, bits or audio out.

The counterpart of ``quadrs_tpu.models.demod``: OOK, FSK, PSK, FM, AM and
SSB.  Device side: decode, mix, filter, and the envelope, discriminator,
PSK estimator or audio reductions, as torch ops and cuFFT; host side:
clock recovery (sequential, see :mod:`quadrs_tpu_torch.bits`) and PSK's
f64 tables and symbol decisions.

``OokDemod`` is the README's OOK flow as one model (envelope ->
threshold -> run-length clock recovery -> Manchester); ``FskDemod``
shift -> lowpass -> halves-energy discriminator -> clock recovery;
``PskDemod`` shift -> lowpass -> block-coherent carrier and timing
estimates -> symbol decisions;
``FmDemod``, ``AmDemod`` and ``SsbDemod`` run a channel through a polar
discriminator, an envelope detector or a sideband filter into the shared
audio tail (:func:`audio_stage`).

Every receiver's channel (``[Shift ∘] LowPass ∘ [Shift ∘] source``, or the
bare source the OOK envelope windows) takes the streaming front end
(:class:`_ChannelStep`): the source's raw span for ``k`` windows is staged
once into a page-locked slot and each dispatch computes every window from
it, with the per-window placement and truncation of the windowed
:class:`~quadrs_tpu_torch.runtime.Executor` route, which chains with user
stages and live pipes keep.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from quadrs_tpu_torch import bits as bits_mod
from quadrs_tpu_torch import sinks
from quadrs_tpu_torch.formats import decode_plane
from quadrs_tpu_torch.ops.fir import auto_impl, fir_decimate, lowpass_taps, overlapped_frames
from quadrs_tpu_torch.ops.frontend import no_tf32
from quadrs_tpu_torch.ops.nco import mix, rotate
from quadrs_tpu_torch.ops.resample import resample_real
from quadrs_tpu_torch.ops.stft import stft_norms
from quadrs_tpu_torch.parallel.sharding import join
from quadrs_tpu_torch.runtime import Executor, stream_batches
from quadrs_tpu_torch.staging import UploadRing
from quadrs_tpu_torch.stream import LowPass, Shift, Stream


def manchester_decode(bitstream: list[bool]) -> list[int]:
    """Pair (a, b) -> 1 for pulse-first (10), 0 for gap-first (01);
    returns the longest aligned decode of the stream."""
    best: list[int] = []
    for phase in (0, 1):
        out: list[int] = []
        pairs = zip(bitstream[phase::2], bitstream[phase + 1 :: 2])
        for a, b in pairs:
            if a == b:
                if len(out) > len(best):
                    best = out
                out = []
                continue
            out.append(1 if a and not b else 0)
        if len(out) > len(best):
            best = out
    return best


@dataclass
class OokDemod:
    """On-off-keying receiver: spectral envelope -> pulses -> bits.

    ``width``/``stride`` window the envelope detector exactly like the
    README's ``sparkfft -width 4 -stride 2`` flow; ``threshold`` is the
    blank/active magnitude cut; ``samples_per_bit`` is in *windows*.
    """

    width: int = 4
    stride: int = 2
    threshold: float = 0.001
    samples_per_bit: float = 8.0

    def pulses(self, stream: Stream, *, device: torch.device | str, mesh=None) -> np.ndarray:
        """One bool a window: any bin's magnitude at or above the threshold.
        ``mesh``: a Tx1 mesh the envelope's windows time-shard over
        (:func:`_channel_step`); it needs the bare capture (ValueError
        otherwise)."""
        offsets = np.arange(0, stream.length - self.width, self.stride, dtype=np.int64)
        if len(offsets) == 0:
            raise ValueError("input shorter than the envelope window")
        th = float(np.float32(self.threshold))

        def post(x):  # envelope flags on the device, one bool a window
            return (stft_norms(x) >= th).any(dim=1)

        # small windows over a bare source take the chunk-level envelope,
        # which lifts the overlapped-window guard (the JAX package's test)
        chunk_post = _envelope_chunk_post(self.width, self.stride, th) if self.width <= 16 and self.stride <= 16 else None
        fast = _strided_windows_dev(stream, self.width, self.stride, len(offsets), post, device=device,
                                    chunk_post=chunk_post, mesh=mesh)
        if fast is not None:
            return fast
        if mesh is not None:
            raise ValueError(_MESH_NEEDS_CHAIN)
        batch, batches = stream_batches(stream, offsets, self.width)
        ex = Executor(stream, self.width, device, batch=batch, post=post)
        flags = []
        for _, f, valid in ex.run_each(batches):
            if not np.all(valid == self.width):
                raise RuntimeError("short read in OOK demod")
            flags.append(f)
        return np.concatenate(flags)

    def demodulate(self, stream: Stream, *, device: torch.device | str, mesh=None) -> tuple[float, list[bool]]:
        """Returns (clock_error, raw pulse bits)."""
        return bits_mod.scan(self.pulses(stream, device=device, mesh=mesh), self.samples_per_bit)

    def decode_manchester(self, stream: Stream, *, device: torch.device | str, mesh=None) -> list[int]:
        _, raw = self.demodulate(stream, device=device, mesh=mesh)
        return manchester_decode(raw)


@dataclass
class FskDemod:
    """Two-tone FSK receiver: shift -> lowpass -> halves-energy
    discriminator (:func:`~quadrs_tpu_torch.sinks.freq_levels`) -> clock
    recovery.

    ``center``: offset of the FSK pair from DC (the ``shift`` amount);
    ``bandwidth``/``decimate``/``taps``: the channel filter;
    ``fft_width``/``stride``: discriminator windowing (output domain);
    ``samples_per_symbol``: inverse symbol rate in windows.
    """

    center: int = 0
    bandwidth: int = 200_000
    decimate: int = 32
    taps: int = 400
    fft_width: int = 64
    stride: int | None = None
    samples_per_symbol: float = 1.0

    def channel(self, stream: Stream) -> Stream:
        chain: Stream = stream
        if self.center:
            chain = Shift(chain, self.center, chain.sample_rate)
        return LowPass(chain, self.bandwidth, self.decimate, self.taps)

    def symbols(self, stream: Stream, *, device: torch.device | str, mesh=None) -> list[int]:
        levels = sinks.freq_levels(self.channel(stream), self.fft_width, self.stride, levels=2, device=device,
                                   mesh=mesh)
        return levels.vals

    def demodulate(self, stream: Stream, *, device: torch.device | str, mesh=None) -> tuple[float, list[bool]]:
        """Run-length clock recovery over the symbol stream."""
        syms = [bool(v) for v in self.symbols(stream, device=device, mesh=mesh)]
        return bits_mod.scan(syms, self.samples_per_symbol)


def discriminate(x: torch.Tensor) -> torch.Tensor:
    """``x[:, 1:] * conj(x[:, :-1])`` of a (B, c+1) batch: the quadrature
    discriminator's product, through
    :func:`~quadrs_tpu_torch.ops.nco.rotate`."""
    prev = x[:, :-1]
    return rotate(x[:, 1:], prev.real, -prev.imag)


@dataclass
class FmDemod:
    """Frequency-modulation receiver: shift -> lowpass -> quadrature
    discriminator -> the audio tail.

    The discriminator is the polar one: the instantaneous frequency at
    channel sample ``n`` is ``angle(x[n] * conj(x[n-1])) * rate / (2*pi)``
    Hz, computed in windows of ``chunk`` outputs, each reading one sample
    of lead, so no output is lost at a window's start.  ``chunk`` is still
    semantics at a window's end, as it is in the JAX package: the last
    ``ceil(taps/2)/decimate`` outputs of each window see the channel FIR's
    per-read truncation.  Output sample ``i`` is channel sample ``i + 1``.

    ``deviation`` is the full-scale swing in Hz: audio is ``inst_freq /
    deviation``, so a transmitter swinging +/-deviation gives audio in
    [-1, 1].  ``audio_bandwidth``/``audio_decimate`` add a real decimating
    FIR after the discriminator; ``audio_rate`` resamples the result to
    an exact rate (:func:`audio_stage`).
    """

    center: int = 0
    bandwidth: int = 100_000
    decimate: int = 8
    taps: int = 400
    deviation: float = 75_000.0
    audio_bandwidth: int | None = None
    audio_decimate: int = 1
    audio_taps: int = 64
    audio_rate: int | None = None  # rational resample to this exact Hz
    chunk: int = 1 << 16  # discriminator samples per window

    def channel(self, stream: Stream) -> Stream:
        chain: Stream = stream
        if self.center:
            chain = Shift(chain, self.center, chain.sample_rate)
        return LowPass(chain, self.bandwidth, self.decimate, self.taps)

    def discriminate_dev(self, stream: Stream, *, device: torch.device | str, mesh=None) -> tuple[int, torch.Tensor]:
        """``(channel_rate_hz, f32[channel_len - 1] Hz on the device)``: the
        window at offset o reads channel samples o .. o+c and gives the
        frequency at o+1 .. o+c, so offsets stepping c give every channel
        sample from 1 on once."""
        chan = self.channel(stream)
        if chan.length < 2:
            raise ValueError("input too short for the FM discriminator")
        rate = chan.sample_rate
        c = min(self.chunk, chan.length - 1)
        scale = float(np.float32(rate / (2.0 * np.pi)))

        def post(x):  # (B, c+1) complex -> (B, c) f32 Hz
            d = discriminate(x)
            return torch.atan2(d.imag, d.real) * scale

        return rate, _chunked_signal_dev(chan, c, 1, post, device=device, mesh=mesh)

    def demodulate(self, stream: Stream, *, device: torch.device | str, mesh=None) -> tuple[int, np.ndarray]:
        """``(audio_rate_hz, f32 audio)``: ``inst_freq / deviation`` through
        the audio tail; only the final audio crosses to the host."""
        rate, freq = self.discriminate_dev(stream, device=device, mesh=mesh)
        return audio_stage(self, rate, freq, div=float(self.deviation))


@dataclass
class AmDemod:
    """Amplitude-modulation receiver: shift -> lowpass -> envelope
    detector -> the audio tail.

    The envelope is ``|x[n]|`` of the filtered channel; audio is the
    modulation ``envelope / mean(envelope) - 1`` (a transmitter at depth m
    gives audio swinging +/-m, whatever the capture's gain).  The whole
    capture's mean is the carrier estimate.
    """

    center: int = 0
    bandwidth: int = 10_000
    decimate: int = 8
    taps: int = 400
    audio_bandwidth: int | None = None
    audio_decimate: int = 1
    audio_taps: int = 64
    audio_rate: int | None = None  # rational resample to this exact Hz
    chunk: int = 1 << 16  # envelope samples per window

    def channel(self, stream: Stream) -> Stream:
        chain: Stream = stream
        if self.center:
            chain = Shift(chain, self.center, chain.sample_rate)
        return LowPass(chain, self.bandwidth, self.decimate, self.taps)

    def envelope_dev(self, stream: Stream, *, device: torch.device | str, mesh=None) -> tuple[int, torch.Tensor]:
        """``(channel_rate_hz, |x| f32[channel_len] on the device)``."""
        chan = self.channel(stream)
        if chan.length < 1:
            raise ValueError("input too short for the AM envelope")
        c = min(self.chunk, chan.length)
        return chan.sample_rate, _chunked_signal_dev(chan, c, 0, torch.abs, device=device, mesh=mesh)

    def demodulate(self, stream: Stream, *, device: torch.device | str, mesh=None) -> tuple[int, np.ndarray]:
        """Audio in modulation-depth units (``envelope / carrier - 1``).
        The carrier is the envelope's mean on the device: one scalar comes
        back, and an all-zero envelope raises."""
        rate, env = self.envelope_dev(stream, device=device, mesh=mesh)
        carrier = float(env.mean())
        if carrier <= 0.0:
            raise ValueError("no carrier: the channel envelope is all zero")
        return audio_stage(self, rate, env, div=carrier, bias=-1.0)


@dataclass
class SsbDemod:
    """Single-sideband receiver (filter method): shift the chosen
    sideband's midpoint to DC, symmetric lowpass + decimate, undo the
    midpoint shift at the channel rate, take the real part.

    ``center`` follows the house shift convention: bring the SUPPRESSED
    CARRIER to DC with ``center = -carrier_offset``.  USB then occupies
    ``[0, bandwidth]`` and LSB ``[-bandwidth, 0]``; the two exact shifts
    are ``center -/+ bandwidth/2`` at the capture rate and ``+/-
    bandwidth/2`` at the channel rate.  Gain 1: a unit USB tone gives a
    unit-amplitude cosine.  ``bandwidth`` must be even (the midpoint shift
    is exact integer Hz) and at most half the channel rate.
    """

    center: int = 0
    bandwidth: int = 3_000
    decimate: int = 8
    taps: int = 400
    sideband: str = "usb"  # or "lsb"
    audio_bandwidth: int | None = None
    audio_decimate: int = 1
    audio_taps: int = 64
    audio_rate: int | None = None  # rational resample to this exact Hz
    chunk: int = 1 << 16  # baseband samples per window

    def _sign(self) -> int:
        if self.sideband not in ("usb", "lsb"):
            raise ValueError(f"unknown sideband {self.sideband!r}: usb|lsb")
        return 1 if self.sideband == "usb" else -1

    def channel(self, stream: Stream) -> Stream:
        if self.bandwidth % 2 or self.bandwidth <= 0:
            raise ValueError("bandwidth must be positive and even")
        sign = self._sign()
        half = self.bandwidth // 2
        pre = self.center - sign * half  # carrier -> DC, then midpoint -> DC
        chain: Stream = stream
        if pre:
            chain = Shift(chain, pre, chain.sample_rate)
        chain = LowPass(chain, half, self.decimate, self.taps)
        # the audio is [0, bandwidth] of a REAL stream at the channel rate:
        # past rate/2 it folds
        if self.bandwidth * 2 > chain.sample_rate:
            raise ValueError(
                f"bandwidth {self.bandwidth} exceeds half the channel rate "
                f"{chain.sample_rate} (lower the decimation or the bandwidth)"
            )
        if half:  # undo the midpoint shift at the decimated rate
            chain = Shift(chain, sign * half, chain.sample_rate)
        return chain

    def baseband_dev(self, stream: Stream, *, device: torch.device | str, mesh=None) -> tuple[int, torch.Tensor]:
        """``(channel_rate_hz, real(x) f32[channel_len] on the device)``."""
        chan = self.channel(stream)
        if chan.length < 1:
            raise ValueError("input too short for the SSB demodulator")
        c = min(self.chunk, chan.length)
        return chan.sample_rate, _chunked_signal_dev(chan, c, 0, torch.real, device=device, mesh=mesh)

    def demodulate(self, stream: Stream, *, device: torch.device | str, mesh=None) -> tuple[int, np.ndarray]:
        """Audio: ``real`` of the re-centred sideband through the audio tail."""
        rate, bb = self.baseband_dev(stream, device=device, mesh=mesh)
        return audio_stage(self, rate, bb)


def audio_stage(demod, rate: int, audio: torch.Tensor, div: float = 1.0, bias: float = 0.0) -> tuple[int, np.ndarray]:
    """:func:`audio_stage_dev`, its audio fetched to the host as f32 numpy."""
    rate, y = audio_stage_dev(demod, rate, audio, div, bias)
    return rate, y.cpu().numpy()


def audio_stage_dev(demod, rate: int, audio: torch.Tensor, div: float = 1.0, bias: float = 0.0) -> tuple[int, torch.Tensor]:
    """The audio tail of every analog receiver (the JAX package's
    ``_audio_stage`` and ``_audio_stage_fused``), on ``audio``'s device:
    the ``audio / div + bias`` prologue (FM's deviation scaling, AM's
    modulation-depth normalization), the optional real decimating FIR of
    ``demod.audio_bandwidth``/``audio_decimate``/``audio_taps`` (through
    :func:`~quadrs_tpu_torch.ops.fir.fir_decimate`; ``n_out = 1 + (len -
    taps) // decimate``, as ``LowPass``), and the optional rational
    resample to ``demod.audio_rate``
    (:func:`~quadrs_tpu_torch.ops.resample.resample_real`).  Returns
    ``(out_rate, f32 audio on the device)``."""
    dev = audio.device
    if dev.type == "cuda":
        no_tf32()
    y = audio / torch.full((), div, dtype=torch.float32, device=dev) + torch.full((), bias, dtype=torch.float32, device=dev)
    cur_rate, cur_n = int(rate), int(y.shape[0])
    if demod.audio_bandwidth is not None or demod.audio_decimate != 1:
        d, n_taps = int(demod.audio_decimate), int(demod.audio_taps)
        cutoff_hz = demod.audio_bandwidth if demod.audio_bandwidth is not None else cur_rate // (2 * d)
        f_out = 1 + (cur_n - n_taps) // d
        if f_out < 1:
            raise ValueError("audio shorter than the audio filter")
        f_in = f_out * d + n_taps
        take = min(f_in, cur_n)
        z = torch.nn.functional.pad(y[:take], (0, f_in - take))
        taps = lowpass_taps(cutoff_hz / cur_rate, n_taps)
        y = fir_decimate(torch.complex(z, torch.zeros_like(z))[None, :], taps, d, f_out)[0].real
        cur_rate //= d
    if demod.audio_rate is not None:
        cur_rate, y = resample_real(y, cur_rate, int(demod.audio_rate))
    return cur_rate, y.contiguous()


# ------------------------------------------------------------------- PSK

_TAU = 2.0 * math.pi
_QPSK_GRAY = {0: (0, 0), 1: (0, 1), 2: (1, 1), 3: (1, 0)}


@dataclass(frozen=True)
class PskEstimate:
    """Synchronization estimates recovered from one PSK burst."""

    freq_hz: float  # residual carrier offset at the channel rate
    phase: float  # common phase (radians; one of the ``order`` branches)
    tau: float  # symbol timing offset, channel samples in [0, sps)
    sps: float  # channel samples per symbol
    rate: int  # channel sample rate (Hz)
    n: int  # baseband samples analyzed


def _masked(planes: torch.Tensor, n: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The (2, npad) planes as complex, zero from sample ``n`` on, and the
    sample indices."""
    idx = torch.arange(planes.shape[1], device=planes.device)
    mask = (idx < n).to(torch.float32)
    return torch.complex(planes[0] * mask, planes[1] * mask), idx


def psk_peak(planes: torch.Tensor, n: int, order: int) -> torch.Tensor:
    """Device program: the power spectrum peak of the order-th power of the
    masked burst.  Returns ``(k0, P[k0-1], P[k0], P[k0+1])`` as one f64
    tensor on the device (one fetch; the parabolic refinement stays on the
    host).  ``torch.argmax`` keeps the first maximum, as ``jnp.argmax``
    does."""
    npad = planes.shape[1]
    x, _ = _masked(planes, n)
    for _ in range(order.bit_length() - 1):  # order in (2, 4)
        x = x * x
    p = torch.abs(torch.fft.fft(x)) ** 2
    k0 = torch.argmax(p)
    return torch.stack([k0.to(torch.float64), p[(k0 - 1) % npad].double(), p[k0].double(), p[(k0 + 1) % npad].double()])


def psk_process(planes: torch.Tensor, rot: torch.Tensor, tim: torch.Tensor, n: int, order: int, mf_len: int):
    """Device program: derotate by the host-exact phase table, the
    order-th-power sum (common phase), the length-``mf_len`` moving average
    as an f32 ``cumsum`` difference (the matched filter), and the
    Oerder-Meyr timing correlator ``sum |z|^2 e^{-j 2 pi n / sps}`` over full
    filter windows.  Returns ``(z complex64 on the device, (s.re, s.im, e.re,
    e.im) f64 on the device)``."""
    x, idx = _masked(planes, n)
    y = x * torch.complex(rot[0], rot[1])
    ym = y
    for _ in range(order.bit_length() - 1):
        ym = ym * ym
    s = torch.sum(ym)
    c = torch.cumsum(y, dim=0)
    z = (c - torch.cat([torch.zeros(mf_len, dtype=y.dtype, device=y.device), c[:-mf_len]])) / mf_len
    full = ((idx >= mf_len - 1) & (idx < n)).to(torch.float32)
    w = (z.real**2 + z.imag**2) * full
    e = torch.sum(w * torch.complex(tim[0], tim[1]))
    return z, torch.stack([s.real, s.imag, e.real, e.imag]).double()


def psk_tables(khat: float, npad: int, order: int, sps: float) -> tuple[np.ndarray, np.ndarray]:
    """The host-exact derotation and timing tables, (2, npad) f32 each: f64
    reductions mod one cycle, then one f32 cos/sin (the ExactNCO
    discipline)."""
    nn = np.arange(npad, dtype=np.float64)
    ph = -_TAU * np.mod(khat * nn, order * npad) / (order * npad)
    rot = np.stack([np.cos(ph), np.sin(ph)]).astype(np.float32)
    pht = -_TAU * np.mod(nn / sps, 1.0)
    tim = np.stack([np.cos(pht), np.sin(pht)]).astype(np.float32)
    return rot, tim


def _padded_planes(x: np.ndarray) -> tuple[np.ndarray, int]:
    """The burst as (2, npad) f32 planes, zero past it, and npad (a power of
    two, at least 256)."""
    n = len(x)
    npad = max(256, sinks._round_up_pow2(n))
    planes = np.zeros((2, npad), dtype=np.float32)
    planes[0, :n] = np.real(x)
    planes[1, :n] = np.imag(x)
    return planes, npad


@dataclass
class PskDemod:
    """Phase-shift-keying receiver (BPSK/QPSK), block-coherent.

    shift -> lowpass channel, then two device programs a burst: the
    residual carrier from the order-th power's FFT peak (refined
    parabolically on the host), derotation by a host-exact f64 phase table,
    a one-symbol moving-average matched filter and the Oerder-Meyr timing
    correlator.  The host then samples symbols at the recovered instants
    (linear interpolation) and slices.  No PLL: carrier and timing are
    closed-form block estimates.

    ``center`` is the shift (bring the carrier to DC with ``center =
    -carrier_offset``); ``symbol_rate`` in symbols a second, with ``sps =
    channel_rate / symbol_rate >= 2``; ``order`` 2 (BPSK) or 4 (QPSK, Gray
    00 01 11 10 counter-clockwise).  ``differential`` (the default) decodes
    phase transitions, which cancels the order-fold ambiguity of power-law
    carrier recovery; coherent slicing keeps an unresolved rotation of
    ``2*pi/order``.  The residual carrier must satisfy ``|freq| < rate / (2
    * order)``.

    ``block=N`` re-estimates the carrier every ``N`` baseband samples (one
    small peak program a block, host-synchronous), integrates the
    piecewise-linear frequency track into a continuous f64 phase ramp,
    derotates, and runs the whole-burst estimator on the detrended burst:
    a drifting crystal's carrier.  Each block must hold at least ~4
    symbols."""

    center: int = 0
    bandwidth: int = 200_000
    decimate: int = 32
    taps: int = 400
    symbol_rate: float = 0.0  # required: symbols per second
    order: int = 2
    differential: bool = True
    chunk: int = 1 << 16  # baseband samples per window (semantics at each window's end)
    block: int = 0  # baseband samples per carrier estimate (0 = whole burst)

    def _check(self) -> None:
        if self.order not in (2, 4):
            raise ValueError(f"order must be 2 (BPSK) or 4 (QPSK), not {self.order}")
        if self.symbol_rate <= 0:
            raise ValueError("symbol_rate must be positive (symbols per second)")

    def channel(self, stream: Stream) -> Stream:
        self._check()
        chain: Stream = stream
        if self.center:
            chain = Shift(chain, self.center, chain.sample_rate)
        return LowPass(chain, self.bandwidth, self.decimate, self.taps)

    def baseband(self, stream: Stream, *, device: torch.device | str, mesh=None) -> tuple[int, np.ndarray]:
        """``(channel_rate_hz, complex64[channel_len])`` of the filtered
        channel, in windows of ``chunk`` samples with no lead (the analog
        receivers' chunk loop; real and imaginary planes cross as one
        trailing axis).  Bursts are buffered whole."""
        chan = self.channel(stream)
        if chan.length < 1:
            raise ValueError("input too short for the PSK demodulator")
        c = min(self.chunk, chan.length)
        arr = _chunked_signal_dev(chan, c, 0, torch.view_as_real, device=device, mesh=mesh).cpu().numpy()
        return chan.sample_rate, (arr[..., 0] + 1j * arr[..., 1]).astype(np.complex64)

    def _peak_khat(self, planes: np.ndarray, n: int, npad: int, device) -> float:
        """The refined order-th-power spectral peak, in bins of ``npad``
        (divide by ``order * npad`` for cycles a sample)."""
        got = psk_peak(torch.from_numpy(planes).to(device), n, self.order).cpu().numpy()
        k0, pm, p0, pp = int(got[0]), float(got[1]), float(got[2]), float(got[3])
        denom = pm - 2.0 * p0 + pp
        delta = 0.0 if denom == 0.0 else 0.5 * (pm - pp) / denom
        khat = k0 + min(0.5, max(-0.5, delta))
        if khat > npad / 2:
            khat -= npad
        return khat

    def _block_freq(self, rate: int, xb: np.ndarray, device) -> float:
        """The whole-burst estimator's carrier of one baseband slice."""
        planes, npad = _padded_planes(xb)
        return self._peak_khat(planes, len(xb), npad, device) / (self.order * npad) * rate

    def _carrier_detrend(self, rate: int, x: np.ndarray, device) -> tuple[np.ndarray, float]:
        """Blockwise carrier tracking: the carrier every ``block`` samples,
        the frequency interpolated linearly between block midpoints
        (constant beyond the ends), integrated to an f64 phase ramp, and
        removed.  Returns the detrended burst and the track's mean."""
        n, b = len(x), int(self.block)
        sps = rate / self.symbol_rate
        min_blk = max(1, int(round(sps))) + int(math.ceil(3 * sps))
        if b < min_blk:
            raise ValueError(
                f"block={b} baseband samples holds under ~4 symbols at "
                f"sps={sps:.1f}: raise -block (>= {min_blk})"
            )
        n_blocks = max(1, n // b)  # the ragged tail merges into the last
        bounds = [i * b for i in range(n_blocks)] + [n]
        mids = np.empty(n_blocks, dtype=np.float64)
        freqs = np.empty(n_blocks, dtype=np.float64)
        for i, (s, e) in enumerate(zip(bounds[:-1], bounds[1:])):
            mids[i] = 0.5 * (s + e - 1)
            freqs[i] = self._block_freq(rate, x[s:e], device)
        f_t = np.interp(np.arange(n, dtype=np.float64), mids, freqs)
        phi = _TAU * np.cumsum(f_t) / rate  # continuous by construction
        y = (x * np.exp(-1j * phi)).astype(np.complex64)
        return y, float(np.mean(f_t))

    def analyze(self, rate: int, x: np.ndarray, *, device: torch.device | str) -> tuple[PskEstimate, np.ndarray]:
        """Synchronize and sample one baseband burst: ``(estimate,
        symbols)``, the symbols the matched filter's complex decisions,
        derotated so that the ideal constellation is the ``order``-th roots
        of unity (up to the power-law ambiguity).  With ``block > 0`` the
        carrier is detrended blockwise first, and ``freq_hz`` is the track's
        mean plus the residual."""
        self._check()
        device = torch.device(device)
        f_track = 0.0
        if self.block:
            x, f_track = self._carrier_detrend(rate, x, device)
        m_ord = self.order
        sps = rate / self.symbol_rate
        if sps < 2.0:
            raise ValueError(f"{sps:.2f} channel samples/symbol < 2: lower the symbol rate or the decimation")
        mf_len = max(1, int(round(sps)))
        n = len(x)
        if n < mf_len + int(math.ceil(3 * sps)):
            raise ValueError("burst too short: needs at least ~4 symbols")
        planes, npad = _padded_planes(x)
        khat = self._peak_khat(planes, n, npad, device)
        rot, tim = psk_tables(khat, npad, m_ord, sps)
        dev_planes = torch.from_numpy(planes).to(device)
        z, se = psk_process(dev_planes, torch.from_numpy(rot).to(device), torch.from_numpy(tim).to(device), n, m_ord, mf_len)
        z = z.cpu().numpy()
        s_re, s_im, e_re, e_im = (float(v) for v in se.cpu().numpy())
        phase = math.atan2(s_im, s_re) / m_ord
        tau = (-math.atan2(e_im, e_re) / _TAU) % 1.0 * sps
        est = PskEstimate(freq_hz=f_track + khat / (m_ord * npad) * rate, phase=phase, tau=tau, sps=sps, rate=int(rate), n=n)
        # symbol instants tau + k*sps inside full matched-filter windows
        # ([mf_len-1, n-1]); linear interpolation, then the common phase
        k_start = max(0, int(math.ceil((mf_len - 1 - tau) / sps)))
        k_end = int(math.floor((n - 1 - tau) / sps))
        if k_end < k_start:
            raise ValueError("burst too short: no full symbol instants")
        t = tau + np.arange(k_start, k_end + 1, dtype=np.float64) * sps
        i = np.minimum(np.floor(t).astype(np.int64), n - 2)
        f = (t - i).astype(np.float32)
        sym = z[i] * (1.0 - f) + z[i + 1] * f
        sym = sym * np.complex64(complex(math.cos(-phase), math.sin(-phase)))
        return est, sym.astype(np.complex64)

    def symbols(self, stream: Stream, *, device: torch.device | str, mesh=None) -> tuple[PskEstimate, np.ndarray]:
        rate, x = self.baseband(stream, device=device, mesh=mesh)
        return self.analyze(rate, x, device=device)

    def slice(self, sym: np.ndarray) -> list[int]:
        """Decisions to bits: the phase increment between consecutive
        symbols (differential) or the absolute position (coherent), as the
        index ``m`` of ``e^{j 2 pi m / order}``; QPSK through the Gray code
        00 01 11 10."""
        m_ord = self.order
        if self.differential:
            if len(sym) < 2:
                raise ValueError("differential decode needs >= 2 symbols")
            d = sym[1:] * np.conj(sym[:-1])
            ang = np.arctan2(d.imag, d.real)
        else:
            ang = np.arctan2(sym.imag, sym.real)
        m = np.round(ang * (m_ord / _TAU)).astype(np.int64) % m_ord
        if m_ord == 2:
            return [int(v) for v in m]
        out: list[int] = []
        for v in m:
            out.extend(_QPSK_GRAY[int(v)])
        return out

    def demodulate(self, stream: Stream, *, device: torch.device | str, mesh=None) -> tuple[PskEstimate, list[int]]:
        """Capture to synchronized bits."""
        est, sym = self.symbols(stream, device=device, mesh=mesh)
        return est, self.slice(sym)


# --------------------------------------------------------- the front end


def _channel_parts(chan: Stream):
    """Decompose a ``[Shift at channel rate ∘] [LowPass ∘] [Shift ∘]
    raw-source`` chain (what every receiver's ``channel`` builds, or the
    bare or shifted source the OOK envelope windows) into
    ``(lowpass_or_None, mix_nco_or_None, source, outer_shift_or_None)``,
    or None when the chain does not match (user stages, live pipes,
    sources that do not stage)."""
    outer = None
    lp = chan
    if isinstance(lp, Shift) and isinstance(lp.inner, LowPass):
        # SSB's midpoint re-shift at the channel rate
        outer, lp = lp, lp.inner
    if not isinstance(lp, LowPass):
        lp, inner = None, lp  # bare source: strided raw windows
    else:
        inner = lp.inner
    nco = None
    if isinstance(inner, Shift):
        if inner.sample_rate != inner.inner.sample_rate:
            return None
        nco = inner._nco
        inner = inner.inner
    if inner.root() is not inner or not getattr(inner, "has_staging", False):
        return None
    if getattr(inner, "is_live", False):
        return None
    return lp, nco, inner, outer


_CHANNEL_RAW_BUDGET = 1 << 23  # raw samples per streaming dispatch


def _envelope_chunk_post(width: int, stride: int, th: float):
    """The OOK envelope of a bare chain at the chunk level: flags
    ``any_bin(|DFT bin| >= th)`` of ``kk`` stride-spaced windows straight
    from the decoded chunk, as ``stft_norms`` of ``overlapped_frames``
    views of it (the JAX package's banded DFT product here is a TPU
    lane-padding workaround: a row of a width-4 window fills 128 lanes
    there; here a frame is ``width`` complex values)."""

    def chunk_post(x: torch.Tensor, kk: int) -> torch.Tensor:
        return (stft_norms(overlapped_frames(x, stride, width, kk)) >= th).any(dim=1)

    return chunk_post


class _ChannelStep:
    """The streaming dispatch: ``k`` per-pull windows of a receiver's
    channel (decode -> table mix -> truncated FIR -> optional channel-rate
    re-shift -> ``post``) from one contiguous staged span of the source.

    Per-pull truncation is the contract: each window's FIR sees zeros past
    its own block, so windows are placed and truncated exactly as the
    Executor route does, and ``k`` only batches them.  The NCO mix takes
    host-exact f64 cos/sin tables of the in-window offsets, rotated by
    each window's base by angle addition (4 multiplies and 2 adds an
    element).

    The span of each dispatch is staged into one of two page-locked slots
    of an :class:`~quadrs_tpu_torch.staging.UploadRing` (a file-backed
    source fills it through the capture loader) and crosses on the ring's
    copy stream, so the next span is staged while this one computes.

    ``stride``: channel samples between window starts (default ``c``, the
    analog receivers' contiguous windows, each overlapping the next by
    ``lead``).  ``chunk_post(x, kk)``: for bare chains, the chunk-level
    replacement of ``post`` that takes the decoded span in place of
    ``(kk, n_in)`` frames.  ``fir_impl``: the channel FIR's impl, resolved
    by the caller (:func:`_channel_step`; None without a FIR)."""

    def __init__(self, parts, c: int, lead: int, post, stride: int, k: int, chunk_post, device, fir_impl: str | None):
        lp, nco, src, outer = parts
        self.lp, self.src, self.outer, self.post = lp, src, outer, post
        self.fir_impl = fir_impl
        self.chunk_post = chunk_post
        self.device = torch.device(device)
        self.d, self.size = (lp.decimate, lp.size) if lp is not None else (1, 0)
        self.c, self.lead, self.stride, self.k = c, lead, stride, k
        self.hop = stride * self.d  # raw samples between window starts
        self.n = c + lead  # channel samples a window
        self.n_in = self.n * self.d + self.size  # raw samples a window
        self.span = (k - 1) * self.hop + self.n_in  # raw samples a dispatch
        self.step = k * stride  # channel samples a dispatch advances
        self.nco = nco
        if nco is not None:
            cd, sd = nco.cis(np.arange(self.n_in, dtype=np.int64))
            self._cd = torch.from_numpy(cd).to(self.device)
            self._sd = torch.from_numpy(sd).to(self.device)
        buffers = {"planes": (2 * self.span, src.format.torch_dtype)}
        if chunk_post is None:
            buffers.update(cs=(2 * k, torch.float32), valid=(k, torch.int32))
        if outer is not None:
            buffers["theta"] = (k * self.n, torch.float32)
        self._ring = UploadRing(self.device, 2, **buffers)
        self._last: int | None = None  # the slot of the dispatch before

    def valid_counts(self, o: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """``(window offsets, valid raw samples, valid channel samples)`` of
        the dispatch whose first window sits at channel offset ``o``."""
        w_offs = o + self.stride * np.arange(self.k, dtype=np.int64)
        valid_in = np.clip(self.src.length - w_offs * self.d, 0, self.n_in)
        return w_offs, valid_in, np.maximum(valid_in - self.size, 0) // self.d

    def valid_of(self, o: int) -> int:
        """The valid channel samples of the one window at channel offset
        ``o`` (they never grow with the offset)."""
        valid_in = min(max(self.src.length - o * self.d, 0), self.n_in)
        return max(valid_in - self.size, 0) // self.d

    def __call__(self, o: int) -> tuple[object, np.ndarray]:
        """The dispatch at channel offset ``o``: ``(post's output, (k, n -
        lead, ...) on the device, each window's valid channel count)``
        (no counts on the chunk-level envelope: :meth:`stage`)."""
        slot, dev, v = self.stage(o)
        out = self.compute(dev)
        self._ring.consumed(slot)
        if self._last is not None:
            self._ring.recycle(self._last)
        self._last = slot
        return out, v

    def stage(self, o: int) -> tuple[int, dict[str, torch.Tensor], np.ndarray | None]:
        """Fill a page-locked slot with the dispatch's raw span and tables
        and start its copy: ``(slot, its buffers on the device, each
        window's valid channel count)``; the chunk-level envelope, whose
        caller checks the last window alone (:meth:`valid_of`), gets no
        counts (2^21 windows' bookkeeping would cost the host more than the
        span's read)."""
        ring, k = self._ring, self.k
        slot = ring.take()
        lo = o * self.d
        planes = ring.host(slot, "planes", (2, self.span))
        got = self.src.stage(lo, min(lo + self.span, self.src.length), out=planes).shape[1]
        planes[:, got:] = 0  # past EOF: masked in the decoded domain
        shapes = {"planes": (2, self.span)}
        v = None
        if self.chunk_post is None:
            w_offs, valid_in, v = self.valid_counts(o)
            cs = ring.host(slot, "cs", (2, k))
            if self.nco is not None:
                cs[0], cs[1] = self.nco.cis(w_offs * self.d)
            ring.host(slot, "valid", (k,))[:] = valid_in
            shapes.update(cs=(2, k), valid=(k,))
        if self.outer is not None:
            idx = w_offs[:, None] + np.arange(self.n, dtype=np.int64)[None, :]
            ring.host(slot, "theta", (k, self.n))[:] = self.outer._nco.angles(idx)
            shapes["theta"] = (k, self.n)
        return slot, ring.upload(slot, **shapes), v

    def compute(self, dev: dict[str, torch.Tensor]):
        """``post``'s output for a staged dispatch."""
        x = self.decode(dev)
        if self.chunk_post is not None:
            # bare chain: the windows are raw slices; partial windows are
            # dropped on the host, and the staged pad is zeros
            return self.chunk_post(x[: (self.k - 1) * self.hop + self.n_in], self.k)
        return self.post(self.filter(self.mix(x, dev), dev))  # (k, n - lead, ...trailing axes)

    def decode(self, dev: dict[str, torch.Tensor]) -> torch.Tensor:
        planes, fmt = dev["planes"], self.src.format
        return torch.complex(decode_plane(planes[0], fmt), decode_plane(planes[1], fmt))

    def mix(self, x: torch.Tensor, dev: dict[str, torch.Tensor]) -> torch.Tensor:
        """(k, n_in) windows of the decoded span, zero past each window's
        valid extent, mixed by the NCO."""
        n_in = self.n_in
        # a view of the span: the overlap is sliced, never gathered
        rows = overlapped_frames(x, self.hop, n_in, self.k)
        # zero past each window's valid extent BEFORE the FIR, as
        # LowPass.read_batch does (EOF truncation in the decoded domain)
        keep = torch.arange(n_in, device=x.device)[None, :] < dev["valid"][:, None]
        rows = torch.where(keep, rows, 0)
        if self.nco is None:
            return rows
        c0, s0 = dev["cs"][0][:, None], dev["cs"][1][:, None]
        cm = c0 * self._cd[None, :] - s0 * self._sd[None, :]
        sm = s0 * self._cd[None, :] + c0 * self._sd[None, :]
        return torch.complex(rows.real * cm - rows.imag * sm, rows.real * sm + rows.imag * cm)

    def filter(self, rows: torch.Tensor, dev: dict[str, torch.Tensor]) -> torch.Tensor:
        """The truncated FIR of each window, then the channel-rate re-shift."""
        y = fir_decimate(rows, self.lp.taps, self.d, self.n, impl=self.fir_impl) if self.lp is not None else rows
        if self.outer is not None:
            y = mix(y, dev["theta"])
        return y

    def close(self) -> None:
        """Hand back the last dispatch's slot once its copy has left it."""
        if self._last is not None:
            self._ring.recycle(self._last)
            self._last = None


class _MeshChannelStep:
    """The streaming dispatch time-sharded over a Tx1 mesh: ``k`` full
    windows a dispatch, ``k / T`` a shard.  Shard ``t`` is a
    :class:`_ChannelStep` of ``k / T`` windows on ``mesh.devices[0][t]``
    with a page-locked ring of its own: it stages its block (its windows'
    raw span, ``n_in - hop`` samples of halo past its slice; the last
    shard's halo is the capture's continuation) straight from the source,
    as the single-device step stages its span, and computes its windows
    with the single-device program.  The shards' outputs join on the first
    shard's device (:func:`~quadrs_tpu_torch.parallel.sharding.join`).

    Dispatches cover full windows only (``n_full`` of them), so no window
    is masked; the caller stitches the EOF tail through the single-device
    step."""

    def __init__(self, shards: list[_ChannelStep], n_full: int):
        self.shards = shards
        self.k_loc = shards[0].k
        self.k = self.k_loc * len(shards)
        self.n_full = n_full

    def __call__(self, o: int):
        """The dispatch whose first window sits at channel offset ``o``:
        ``post``'s output for its ``k`` windows on the first shard's device."""
        step = self.k_loc * self.shards[0].stride
        return join([[shard(o + t * step)[0] for t, shard in enumerate(self.shards)]])

    def close(self) -> None:
        for shard in self.shards:
            shard.close()


def _channel_step(chan: Stream, c: int, lead: int, post, *, device, stride: int | None = None, chunk_post=None,
                  mesh=None, windows: int | None = None):
    """A :class:`_ChannelStep` for ``chan``, or None where the chain shape is
    not a receiver's (user stages, live pipes), the chain is too short, or
    the windows overlap so much that their frames would swell memory (more
    than 8x; the chunk-level envelope builds no frames and is exempt).

    ``k`` windows a dispatch: bounded by the raw budget and by what the
    stream needs.  (The JAX package also bounds ``k`` by a window's
    128-lane padded footprint, a TPU layout.)  ``chunk_post`` applies only
    to bare chains: no mix, no FIR, no re-shift.  The FIR's ``auto`` impl
    is resolved here from the single-device geometry, so every dispatch,
    a mesh's shards too, takes the same impl and summation order.

    ``mesh``: a Tx1 mesh (:func:`~quadrs_tpu_torch.parallel.sharding.make_mesh`);
    the step is then a :class:`_MeshChannelStep` of ``k = min(k*T,
    n_full//T*T, 2^18)`` full windows, or None where that leaves a shard
    no window, or where the halo would reach past the next shard's slice
    (the JAX package's geometry).

    ``windows``: without a mesh, at most this many windows a dispatch (the
    EOF tail after a mesh's prefix); the FIR impl is still resolved from
    the uncapped geometry, so capping changes no output."""
    hit = _channel_parts(chan)
    if hit is None:
        return None
    lp, nco, src, outer = hit
    d, size = (lp.decimate, lp.size) if lp is not None else (1, 0)
    use_chunk = chunk_post is not None and lp is None and nco is None and outer is None
    if chan.length - lead < 1:
        return None  # the caller's too-short guards give the error text
    stride = c if stride is None else int(stride)
    hop = stride * d
    n = c + lead
    n_in = n * d + size
    if n_in > 8 * hop and not use_chunk:
        return None
    k = max(1, _CHANNEL_RAW_BUDGET // max(1, hop))
    k = min(k, -(-int(chan.length - lead) // stride), 1 << 21 if use_chunk else 1 << 18)
    chunk_post = chunk_post if use_chunk else None
    devices = [torch.device(device)] if mesh is None else list(mesh.devices[0])
    impl = None if lp is None else lp.fir_impl
    if impl == "auto":
        impl = auto_impl(size, d, k * n, devices[0].type, n)
    if mesh is None:
        k = k if windows is None else max(1, min(k, windows))
        return _ChannelStep(hit, c, lead, post, stride, k, chunk_post, device, impl)
    if mesh.shape["stream"] != 1:
        raise ValueError("demod -mesh shards one capture over 'time'; use a Tx1 mesh")
    n_time = mesh.shape["time"]
    # full windows only: window j (raw offset j*hop) is full iff j*hop +
    # n_in <= src.length; k divisible by the mesh, so every shard gets as
    # many windows, and clamped so that short captures still shard
    n_full = 0 if src.length < n_in else (src.length - n_in) // hop + 1
    k = min(k * n_time, n_full // n_time * n_time, 1 << 18)
    if k < n_time:
        return None  # too short to give every shard a window
    k_loc = k // n_time
    if max(0, n_in - hop) > k_loc * hop:
        return None  # the halo would reach past the next shard's slice
    shards = [_ChannelStep(hit, c, lead, post, stride, k_loc, chunk_post, dev, impl) for dev in devices]
    return _MeshChannelStep(shards, n_full)


_MESH_NEEDS_CHAIN = (
    "-mesh shards the streaming demod front end, which needs the receiver's own chain over a raw capture "
    "file; drop the chained stages / live pipe or drop -mesh"
)


def _sharded_prefix(chan: Stream, c: int, lead: int, post, *, device, stride: int, total: int, mesh,
                    chunk_post=None) -> tuple[list, int]:
    """The mesh's dispatches over the first of ``total`` windows at channel
    stride ``stride``, while each dispatch holds full windows only:
    ``(outputs on device, windows covered)``.  No dispatch (and 0) where
    the mesh step does not engage (:func:`_channel_step`)."""
    step = _channel_step(chan, c, lead, post, device=device, stride=stride, chunk_post=chunk_post, mesh=mesh)
    if step is None:
        return [], 0
    parts, w0 = [], 0
    lim = min(total, step.n_full)
    try:
        while w0 + step.k <= lim:
            out = step(w0 * stride)
            parts.append(tuple(a.to(device) for a in out) if isinstance(out, tuple) else out.to(device))
            w0 += step.k
    finally:
        step.close()
    return parts, w0


def _streaming_signal_dev(chan: Stream, c: int, lead: int, post, *, device, mesh=None):
    """:func:`_chunked_signal_dev`'s streaming route: :class:`_ChannelStep`
    dispatches over the whole stream, the flat result assembled on the
    device.  Output length and EOF arithmetic match the Executor route
    exactly.  None where the chain shape is not supported.

    ``mesh``: the full windows of an aligned prefix run time-sharded over
    the mesh (:class:`_MeshChannelStep`); the EOF tail stitches through
    the single-device dispatches, so output length and placement do not
    change; its step holds no more windows than are left."""
    parts, o0, left = [], 0, None
    if mesh is not None:
        # windows step c here, so window j sits at channel offset j*c
        total = -(-int(chan.length - lead) // c)
        outs, w0 = _sharded_prefix(chan, c, lead, post, device=device, stride=c, total=total, mesh=mesh)
        parts = [out.reshape((-1,) + tuple(out.shape[2:])) for out in outs]
        o0, left = w0 * c, total - w0
    step = _channel_step(chan, c, lead, post, device=device, windows=left)
    if step is None:
        return None
    k, n = step.k, step.n
    try:
        for o in range(o0, int(chan.length - lead), step.step):
            out, v = step(o)
            m = k * c
            short = np.flatnonzero(v < n)
            if len(short):  # EOF: this window ends the stream
                j = int(short[0])
                m = j * c + max(int(v[j]) - lead, 0)
            # flatten the windows; trailing component axes ride along
            flat = out.reshape((-1,) + tuple(out.shape[2:]))
            parts.append(flat if m == flat.shape[0] else flat[:m])
            if len(short):
                break
    finally:
        step.close()
    if not parts:
        return None
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def _strided_windows_dev(stream: Stream, width: int, stride: int, total: int, post, *, device, chunk_post=None,
                         mesh=None):
    """``post`` outputs for ``total`` FULL strided ``width``-windows of
    ``stream`` (the ``freq_levels`` and OOK-envelope shape: every window
    read-exact), by :class:`_ChannelStep` dispatches, back on the host as
    numpy (a tuple of arrays for a tuple-valued ``post``).  None where the
    chain shape is not supported, or where a window would come up short:
    the Executor route then gives the canonical error.

    ``mesh``: an aligned prefix of the windows runs time-sharded over the
    mesh (:class:`_MeshChannelStep`); the rest through the single-device
    dispatches, of no more windows than are left."""
    if total <= 0:
        return None
    chunks, start = [], 0
    if mesh is not None:
        chunks, start = _sharded_prefix(stream, width, 0, post, device=device, stride=stride, total=total, mesh=mesh,
                                        chunk_post=chunk_post)
    step = _channel_step(stream, width, 0, post, device=device, stride=stride, chunk_post=chunk_post,
                         windows=None if mesh is None else total - start)
    if step is None:
        return None
    try:
        for w0 in range(start, total, step.k):
            take = min(step.k, total - w0)
            if step.valid_of((w0 + take - 1) * stride) < width:
                return None
            out, _ = step(w0 * stride)
            chunks.append(tuple(a[:take] for a in out) if isinstance(out, tuple) else out[:take])
    finally:
        step.close()
    if isinstance(chunks[0], tuple):
        return tuple(torch.cat(parts).cpu().numpy() for parts in zip(*chunks))
    return torch.cat(chunks).cpu().numpy()


def _chunked_signal_dev(chan: Stream, c: int, lead: int, post, *, device, mesh=None) -> torch.Tensor:
    """``post`` over the channel in windows of ``c + lead`` samples at
    offsets stepping ``c``, each giving ``c`` outputs (with any trailing
    component axes of ``post``'s), assembled flat
    on ``device``: the analog receivers' shared chunk loop.  A short read
    (EOF) truncates and ends the stream.

    Receiver-shaped chains over a staging source take the streaming route
    (:func:`_streaming_signal_dev`); others (user stages, pipes) the
    windowed Executor route, whose outputs come back to the host and
    cross to the device once at the end.  ``mesh`` shards the streaming
    route, and is refused on the Executor route (ValueError)."""
    out = _streaming_signal_dev(chan, c, lead, post, device=device, mesh=mesh)
    if out is not None:
        return out
    if mesh is not None:
        raise ValueError(_MESH_NEEDS_CHAIN)
    offsets = np.arange(0, chan.length - lead, c, dtype=np.int64)
    batch, batches = stream_batches(chan, offsets, c + lead)
    ex = Executor(chan, c + lead, device, batch=batch, post=post)
    parts = []
    for offs, vals, valid in ex.run_each(batches):
        m = vals.shape[0] * c
        short = np.flatnonzero(valid < c + lead)
        if len(short):
            i = int(short[0])
            m = i * c + max(int(valid[i]) - lead, 0)
        # flatten the windows; trailing component axes ride along
        parts.append(vals.reshape((-1,) + vals.shape[2:])[:m])
        if len(short):
            break
    return torch.from_numpy(np.concatenate(parts)).to(device)
