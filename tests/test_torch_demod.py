"""The bit receivers of the port (``quadrs_tpu_torch.models.demod``:
``manchester_decode``, ``OokDemod``, ``FskDemod``, the streaming front end
``_ChannelStep`` and the streaming ``sinks.freq_levels`` route) against the
JAX package's on the CPU.

Contracts: Manchester decodes and clock-recovered bits are exact.  OOK
flags and FSK/``bucket`` digits are a threshold or a comparison of two f32
sums, so they may differ where the value lies within f32 rounding of the
cut: each differing flag or digit is recomputed in f64 from the decoded
capture (the numpy oracle's chain) and must be a near-tie, within
``1e-5`` of the threshold (relative) or of the larger half sum.  Outputs
do not depend on how many windows a dispatch takes; window placement,
EOF truncation and the too-short errors are the Executor route's.
Inputs are made with numpy from a seed."""

import pathlib

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from oracle import OracleArray, OracleLowPass, OracleShift  # noqa: E402

import quadrs_tpu as q  # noqa: E402
from quadrs_tpu import sinks as jsinks  # noqa: E402
from quadrs_tpu import sources as jsources  # noqa: E402
from quadrs_tpu import stream as jstream  # noqa: E402
from quadrs_tpu.formats import FileFormat as JFormat  # noqa: E402
from quadrs_tpu.models import demod as jd  # noqa: E402

from quadrs_tpu_torch import bits as tbits  # noqa: E402
from quadrs_tpu_torch import sinks as tsinks  # noqa: E402
from quadrs_tpu_torch import sources as tsources  # noqa: E402
from quadrs_tpu_torch import stream as tstream  # noqa: E402
from quadrs_tpu_torch.formats import FileFormat, decode_plane, planes_from_bytes  # noqa: E402
from quadrs_tpu_torch.models import demod as td  # noqa: E402

CPU = "cpu"
EXAMPLES = pathlib.Path(__file__).resolve().parent.parent / "examples"
OOK = str(EXAMPLES / "ook-sim.sr400.cf32")
FSK = str(EXAMPLES / "fsk-sim.sr48k.cf32")
NEAR = 1e-5  # a near-tie: within this of the cut, relative, in f64


def to_bytes(x: np.ndarray, fmt: str) -> np.ndarray:
    """Complex samples (unit scale) as a capture's bytes."""
    if fmt == "cf32":
        return np.ascontiguousarray(x.astype(np.complex64)).view(np.uint8)
    iq = np.stack([x.real, x.imag], axis=-1) * 127
    return np.clip(np.rint(iq), -127, 127).astype(np.int8).view(np.uint8).reshape(-1)


def decoded(raw: np.ndarray, fmt: str) -> np.ndarray:
    planes = planes_from_bytes(raw, FileFormat(fmt))
    return decode_plane(planes[0], FileFormat(fmt)) + 1j * decode_plane(planes[1], FileFormat(fmt))


def pair(raw: np.ndarray, fmt: str, sr: int):
    """The same bytes as a JAX and a port source."""
    return jsources.SampleSource(raw, JFormat(fmt), sr), tsources.SampleSource(raw, FileFormat(fmt), sr)


def ook_capture(n: int, seed: int, noise: float) -> np.ndarray:
    """Manchester bursts of a carrier at sr/8, silent (or noisy) between."""
    rng = np.random.default_rng(seed)
    chips = np.repeat(rng.integers(0, 2, n // 64 + 1), 64)[:n]
    x = 0.6 * chips * np.exp(2j * np.pi * np.arange(n) / 8)
    return x + noise * (rng.normal(size=n) + 1j * rng.normal(size=n))


def fsk_capture(n: int, seed: int, sr: int = 48_000, sym: int = 600) -> np.ndarray:
    """Two-tone FSK at 6 kHz +/- 4 kHz with seeded noise."""
    rng = np.random.default_rng(seed)
    bits = np.repeat(rng.integers(0, 2, n // sym + 1), sym)[:n]
    f = np.where(bits, 10_000, 2_000)
    x = np.exp(2j * np.pi * np.cumsum(f) / sr)
    return 0.5 * x + 0.2 * (rng.normal(size=n) + 1j * rng.normal(size=n))


class Dispatches:
    """Counts the streaming front end's dispatches."""

    def __init__(self, monkeypatch):
        self.count = 0
        orig = td._ChannelStep.__call__

        def counted(step, o):
            self.count += 1
            return orig(step, o)

        monkeypatch.setattr(td._ChannelStep, "__call__", counted)


def test_manchester_decode_and_bits_are_exact():
    rng = np.random.default_rng(11)
    for n in (0, 1, 2, 7, 64, 1001):
        stream = [bool(b) for b in rng.integers(0, 2, n)]
        assert td.manchester_decode(stream) == jd.manchester_decode(stream)
    raw = [True, False, False, True, True, False]
    assert td.manchester_decode([False] + raw + [True]) == [1, 0, 1]
    j = jd.OokDemod(width=4, stride=2, threshold=0.001, samples_per_bit=16.0)
    t = td.OokDemod(width=4, stride=2, threshold=0.001, samples_per_bit=16.0)
    assert t.demodulate(tsources.open_capture(OOK), device=CPU) == j.demodulate(q.open_capture(OOK))
    bits = t.decode_manchester(tsources.open_capture(OOK), device=CPU)
    assert bits == j.decode_manchester(q.open_capture(OOK))
    assert "00011" + "00011000" in "".join(map(str, bits))


def ook_case(name: str):
    """(JAX stream, port stream, f64 decoded samples, sr, width, stride, threshold)."""
    if name == "example":
        raw = np.fromfile(OOK, dtype=np.uint8)
        j, t = q.open_capture(OOK), tsources.open_capture(OOK)
        return j, t, decoded(raw, "cf32").astype(np.complex128), 400, 4, 2, 0.001
    fmt, width, stride = {"bare cs8": ("cs8", 4, 2), "shifted": ("cf32", 8, 4), "width 16 stride 1": ("cf32", 16, 1)}[name]
    x = ook_capture(6000, seed=width, noise=0.02)
    raw = to_bytes(x, fmt)
    j, t = pair(raw, fmt, 8000)
    x64 = decoded(raw, fmt).astype(np.complex128)
    if name == "shifted":
        j, t = jstream.Shift(j, -1000, 8000), tstream.Shift(t, -1000, 8000)
        x64 = x64 * np.exp(2j * np.pi * ((np.arange(len(x64)) * -1000) % 8000) / 8000)
    # a threshold inside the noise floor: many windows lie near it
    norms = np.abs(np.fft.fft(np.lib.stride_tricks.sliding_window_view(x64, width)[::stride], axis=1)).max(axis=1)
    return j, t, x64, 8000, width, stride, float(np.median(norms))


@pytest.mark.parametrize("name", ["example", "bare cs8", "shifted", "width 16 stride 1"])
def test_ook_flags_match_jax_but_at_f64_near_ties(name, monkeypatch):
    """The flags of the streaming route (the chunk-level envelope on bare
    chains, frames through the channel step when shifted; width 16 at
    stride 1 is past the overlap guard, so only the chunk-level envelope
    takes it) against the JAX package's and the f64 envelope."""
    j, t, x64, sr, width, stride, th = ook_case(name)
    d = Dispatches(monkeypatch)
    got = td.OokDemod(width, stride, th).pulses(t, device=CPU)
    assert d.count >= 1  # the streaming route
    want = jd.OokDemod(width, stride, th).pulses(j)
    offs = np.arange(0, len(x64) - width, stride)
    assert got.dtype == bool and got.shape == want.shape == offs.shape
    peak = np.array([np.abs(np.fft.fft(x64[o : o + width])).max() for o in offs])
    exact = peak >= th
    for other in (want, exact):
        for i in np.flatnonzero(got != other):
            assert abs(peak[i] - th) <= NEAR * th, (name, i, peak[i], th)
    assert got.sum() > 10 and (~got).sum() > 10


def test_ook_executor_route_for_heavy_overlap_of_a_shifted_chain(monkeypatch):
    """Width 16 at stride 1 over a shifted chain: the channel step refuses
    (16x overlapped frames), and the Executor route gives the same flags."""
    x = ook_capture(3000, seed=5, noise=0.02)
    j, t = pair(to_bytes(x, "cf32"), "cf32", 8000)
    d = Dispatches(monkeypatch)
    got = td.OokDemod(16, 1, 0.3).pulses(tstream.Shift(t, 500, 8000), device=CPU)
    want = jd.OokDemod(16, 1, 0.3).pulses(jstream.Shift(j, 500, 8000))
    assert d.count == 0 and (got == want).all() and len(got) == 3000 - 16


def halves64(stream, width: int, offs) -> tuple[np.ndarray, np.ndarray]:
    """f64 lower and upper half sums of the oracle's windows."""
    first, second = [], []
    for o in offs:
        norms = np.abs(np.fft.fft(stream.read_exact_at(int(o), width).astype(np.complex128)))
        first.append(norms[: width // 2].sum())
        second.append(norms[width // 2 :].sum())
    return np.array(first), np.array(second)


def fsk_case(name: str):
    if name == "example":
        raw = np.fromfile(FSK, dtype=np.uint8)
        fmt = "cf32"
    else:
        fmt = "cs8"
        raw = to_bytes(fsk_capture(24_000, seed=3), fmt)
    j, t = pair(raw, fmt, 48_000)
    return j, t, OracleArray(decoded(raw, fmt), 48_000)


@pytest.mark.parametrize("name", ["example", "noisy cs8"])
@pytest.mark.parametrize("center,stride", [(0, 600), (-6000, None), (-6000, 17)])
def test_fsk_symbols_match_jax_and_the_executor_route(name, center, stride, monkeypatch):
    """``FskDemod.symbols`` (the streaming ``freq_levels`` route) against the
    JAX package's streaming route and the port's own Executor route; each
    differing digit is an f64 near-tie of the two half sums."""
    j, t, o = fsk_case(name)
    kw = dict(center=center, bandwidth=8000, decimate=4, taps=40, fft_width=64, stride=stride)
    d = Dispatches(monkeypatch)
    got = td.FskDemod(**kw).symbols(t, device=CPU)
    assert d.count >= 1
    want = jd.FskDemod(**kw).symbols(j)
    monkeypatch.setattr(td, "_channel_parts", lambda chan: None)  # the Executor route
    executor = td.FskDemod(**kw).symbols(t, device=CPU)
    assert d.count == 1 and len(got) == len(want) == len(executor) > 8
    chan = OracleLowPass(OracleShift(o, center, 48_000) if center else o, 8000, 4, 40)
    for other in (want, executor):
        bad = np.flatnonzero(np.asarray(got) != np.asarray(other))
        first, second = halves64(chan, 64, bad * (stride or 64))
        assert (np.abs(first - second) <= NEAR * np.maximum(first, second)).all(), (bad, first, second)
    assert {0, 1} == set(got)
    j_err, j_bits = jd.FskDemod(**kw, samples_per_symbol=2.0).demodulate(j)
    t_err, t_bits = td.FskDemod(**kw, samples_per_symbol=2.0).demodulate(t, device=CPU)
    if got == want:
        assert (t_err, t_bits) == (j_err, j_bits)


def test_freq_levels_routes(monkeypatch):
    """``bucket`` takes the streaming route on a receiver-shaped chain over
    a file or a byte buffer, and the Executor route under a user stage and
    on ``gen`` (and a live pipe's chain declines it); the digits are the
    JAX package's."""
    import io

    raw = np.fromfile(FSK, dtype=np.uint8)
    d = Dispatches(monkeypatch)
    chain = tstream.LowPass(tstream.Shift(tsources.open_capture(FSK), 6000), 8000, 4, 40)
    jchain = jstream.LowPass(jstream.Shift(q.open_capture(FSK), 6000), 8000, 4, 40)
    assert tsinks.freq_levels(chain, 64, 32, device=CPU).vals == jsinks.freq_levels(jchain, 64, 32).vals
    assert d.count == 1
    buffered = tsources.SampleSource(raw, FileFormat("cf32"), 48_000)
    got = tsinks.freq_levels(tstream.LowPass(tstream.Shift(buffered, 6000), 8000, 4, 40), 64, 64, device=CPU).vals
    assert got == jsinks.freq_levels(jstream.LowPass(jstream.Shift(q.open_capture(FSK), 6000), 8000, 4, 40), 64, 64).vals
    assert d.count == 2
    # a live pipe's chain is no receiver chain: it keeps the Executor route
    pipe = tsources.LivePipeStream(tsources.PipeSource(io.BytesIO(raw.tobytes()), FileFormat("cf32"), 48_000))
    jpipe = jsources.LivePipeStream(jsources.PipeSource(io.BytesIO(raw.tobytes()), JFormat("cf32"), 48_000))
    assert td._channel_parts(tstream.LowPass(tstream.Shift(pipe, 6000), 8000, 4, 40)) is None
    assert jd._channel_parts(jstream.LowPass(jstream.Shift(jpipe, 6000), 8000, 4, 40)) is None
    dc = tstream.DcBlock(tsources.open_capture(FSK), 64)
    jdc = jstream.DcBlock(q.open_capture(FSK), 64)
    assert tsinks.freq_levels(dc, 64, device=CPU).vals == jsinks.freq_levels(jdc, 64).vals
    gen = tsources.ToneGen([1000, -3000], 48_000, 0.5)
    assert tsinks.freq_levels(gen, 64, device=CPU).vals == jsinks.freq_levels(jsources.ToneGen([1000, -3000], 48_000, 0.5), 64).vals
    assert d.count == 2


def test_dispatch_size_is_not_semantics(monkeypatch):
    """The same outputs at three raw budgets (one window a dispatch, a few,
    all): FSK digits (equal outside f64 near-ties), OOK flags and the FM
    discriminator (within 1e-6 of its full scale, the deviation)."""
    raw = to_bytes(fsk_capture(30_000, seed=9), "cf32")
    t = tsources.SampleSource(raw, FileFormat("cf32"), 48_000)
    o = OracleLowPass(OracleShift(OracleArray(decoded(raw, "cf32"), 48_000), -6000, 48_000), 8000, 4, 40)
    ook_raw = to_bytes(ook_capture(20_000, seed=2, noise=0.02), "cs8")
    ook_src = tsources.SampleSource(ook_raw, FileFormat("cs8"), 8000)
    d = Dispatches(monkeypatch)
    runs = []
    for budget in (1, 1 << 12, 1 << 23):
        monkeypatch.setattr(td, "_CHANNEL_RAW_BUDGET", budget)
        d.count = 0
        syms = td.FskDemod(center=-6000, bandwidth=8000, decimate=4, taps=40, stride=50).symbols(t, device=CPU)
        flags = td.OokDemod(4, 2, 0.3).pulses(ook_src, device=CPU)
        fm = td.FmDemod(center=-6000, bandwidth=8000, decimate=4, taps=40, deviation=4000, chunk=333)
        _, freq = fm.discriminate_dev(t, device=CPU)
        runs.append((np.asarray(syms), flags, freq.numpy(), d.count))
    counts = [r[3] for r in runs]
    assert counts[0] > counts[1] > counts[2] >= 3, counts
    for syms, flags, freq, _ in runs[:2]:
        bad = np.flatnonzero(syms != runs[2][0])
        first, second = halves64(o, 64, bad * 50)
        assert (np.abs(first - second) <= NEAR * np.maximum(first, second)).all()
        assert (flags == runs[2][1]).all()
        assert freq.shape == runs[2][2].shape and np.abs(freq - runs[2][2]).max() <= 1e-6 * 4000


@pytest.mark.parametrize("n", [4000, 4001, 4003, 5200])
def test_eof_placement_matches_jax_and_the_executor_route(n, monkeypatch):
    """Output lengths at the end of the capture (the per-window valid
    counts and the EOF stop) equal the JAX package's and the Executor
    route's, at capture lengths around a window edge."""
    raw = to_bytes(fsk_capture(n, seed=n), "cf32")
    j, t = pair(raw, "cf32", 48_000)
    for cls, kw in ((td.FmDemod, dict(center=-6000, bandwidth=8000, decimate=4, taps=40, chunk=100)),
                    (td.AmDemod, dict(center=-6000, bandwidth=8000, decimate=4, taps=40, chunk=128)),
                    (td.SsbDemod, dict(center=-6000, bandwidth=2000, decimate=4, taps=40, chunk=99))):
        jcls = getattr(jd, cls.__name__)
        fn = {"FmDemod": "discriminate", "AmDemod": "envelope", "SsbDemod": "baseband"}[cls.__name__]
        want = getattr(jcls(**kw), fn)(j)[1]
        got = getattr(cls(**kw), fn + "_dev")(t, device=CPU)[1]
        with monkeypatch.context() as m:
            m.setattr(td, "_channel_parts", lambda chan: None)
            executor = getattr(cls(**kw), fn + "_dev")(t, device=CPU)[1]
        assert got.shape == executor.shape == want.shape, cls.__name__
        scale = float(np.abs(want).max())
        assert float((got - executor).abs().max()) <= 1e-5 * scale
    # a strided window past the readable end: the streaming route declines
    # and leaves the canonical error to the Executor route, as JAX's does
    chan = td.FskDemod(center=-6000, bandwidth=8000, decimate=4, taps=40).channel(t)
    jchan = jd.FskDemod(center=-6000, bandwidth=8000, decimate=4, taps=40).channel(j)
    valid = chan.plan(np.arange(chan.length // 16) * 16, 64, 0).valid
    total = int(np.argmax(valid < 64))  # the first short window
    assert total > 10 and (valid[:total] == 64).all()
    assert td._strided_windows_dev(chan, 64, 16, total + 1, torch.abs, device=CPU) is None
    assert jd._strided_windows_dev(jchan, 64, 16, total + 1, lambda x: abs(x)) is None
    assert td._strided_windows_dev(chan, 64, 16, total, torch.abs, device=CPU).shape == (total, 64)


def test_too_short_errors_match_jax():
    raw = to_bytes(fsk_capture(300, seed=1), "cf32")
    j, t = pair(raw, "cf32", 48_000)
    cases = [
        (lambda p, s, **kw: p.OokDemod(width=400).pulses(s, **kw), "input shorter than the envelope window"),
        (lambda p, s, **kw: p.FmDemod(taps=298, decimate=8).discriminate_dev(s, **kw) if p is td
         else p.FmDemod(taps=298, decimate=8).discriminate(s), "input too short for the FM discriminator"),
        (lambda p, s, **kw: p.FmDemod(taps=400).demodulate(s, **kw), "input shorter than the filter"),
        (lambda p, s, **kw: p.FmDemod(decimate=4, taps=40, audio_decimate=2, audio_taps=200).demodulate(s, **kw),
         "audio shorter than the audio filter"),
        (lambda p, s, **kw: p.AmDemod(decimate=4, taps=40, audio_rate=1000).demodulate(s, **kw),
         "audio shorter than the resampling filter"),
        (lambda p, s, **kw: p.SsbDemod(bandwidth=3001).demodulate(s, **kw), "bandwidth must be positive and even"),
        (lambda p, s, **kw: p.SsbDemod(bandwidth=4000, decimate=16, taps=40).demodulate(s, **kw), "exceeds half the channel rate"),
        (lambda p, s, **kw: p.SsbDemod(sideband="dsb", taps=40).demodulate(s, **kw), "unknown sideband"),
    ]
    for run, text in cases:
        with pytest.raises(ValueError, match=text):
            run(jd, j)
        with pytest.raises(ValueError, match=text):
            run(td, t, device=CPU)
    zeros = np.zeros(2000, dtype=np.complex64).view(np.uint8)
    jz, tz = pair(zeros, "cf32", 48_000)
    for p, s, kw in ((jd, jz, {}), (td, tz, {"device": CPU})):
        with pytest.raises(ValueError, match="no carrier"):
            p.AmDemod(decimate=4, taps=40).demodulate(s, **kw)


def test_bits_scan_is_the_jax_packages_on_receiver_pulses():
    """Clock recovery over the port's own pulse train equals the JAX
    package's over its own, bit for bit."""
    x = ook_capture(8000, seed=4, noise=0.0)
    j, t = pair(to_bytes(x, "cs8"), "cs8", 8000)
    got = td.OokDemod(4, 2, 0.001, 16.0).pulses(t, device=CPU)
    want = jd.OokDemod(4, 2, 0.001, 16.0).pulses(j)
    assert (got == want).all()
    assert tbits.scan(got, 16.0) == jd.bits_mod.scan(want, 16.0)
