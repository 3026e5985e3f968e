"""The analog receivers of the port (``FmDemod``, ``AmDemod``, ``SsbDemod``),
their audio tail (``models.demod.audio_stage``) and the WAV writer
(``utils/wav.py``) against the JAX package's on the CPU.

Bound: audio within ``1e-5`` of full scale.  Full scale is 1 in each
receiver's own units: FM audio is ``Hz / deviation``, AM audio modulation
depth, SSB audio the sideband's amplitude (a unit tone gives a unit
cosine).  The two packages' ``atan2``, FIR sums and means differ in the
last ulps, which the FM discriminator scales by ``rate / (2 pi
deviation)``; the captures are constant-envelope or carrier-bearing, as
the receivers' inputs are.  WAV bytes are equal.  Inputs are made with
numpy from a seed."""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from quadrs_tpu import sources as jsources  # noqa: E402
from quadrs_tpu.formats import FileFormat as JFormat  # noqa: E402
from quadrs_tpu.models import demod as jd  # noqa: E402
from quadrs_tpu.utils import wav as jwav  # noqa: E402

from quadrs_tpu_torch import sources as tsources  # noqa: E402
from quadrs_tpu_torch.formats import FileFormat  # noqa: E402
from quadrs_tpu_torch.models import demod as td  # noqa: E402
from quadrs_tpu_torch.utils import wav as twav  # noqa: E402

CPU = "cpu"
FULL_SCALE_TOL = 1e-5
SR = 192_000


def capture(kind: str, fmt: str, n: int = 60_000, seed: int = 1) -> np.ndarray:
    """A seeded capture's bytes at ``SR``: ``fm`` a 1 kHz tone at 5 kHz
    deviation on a carrier at +24 kHz; ``am`` a 700 Hz tone at depth 0.5 on
    a carrier at -30 kHz; ``ssb`` a USB tone 1 kHz above a suppressed
    carrier at +20 kHz.  Noise at 0.01 a component."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / SR
    if kind == "fm":
        phase = 2 * np.pi * 24_000 * t + 5 * np.sin(2 * np.pi * 1000 * t)  # beta = 5k / 1k
        x = 0.7 * np.exp(1j * phase)
    elif kind == "am":
        x = 0.5 * (1 + 0.5 * np.cos(2 * np.pi * 700 * t)) * np.exp(-2j * np.pi * 30_000 * t + 0.3j)
    else:
        x = 0.6 * np.exp(2j * np.pi * 21_000 * t + 1.1j)
    x = x + 0.01 * (rng.normal(size=n) + 1j * rng.normal(size=n))
    if fmt == "cf32":
        return np.ascontiguousarray(x.astype(np.complex64)).view(np.uint8)
    iq = np.stack([x.real, x.imag], axis=-1) * 127
    return np.clip(np.rint(iq), -127, 127).astype(np.int8).view(np.uint8).reshape(-1)


def pair(raw, fmt):
    return jsources.SampleSource(raw, JFormat(fmt), SR), tsources.SampleSource(raw, FileFormat(fmt), SR)


RECEIVERS = {
    "fm": (td.FmDemod, jd.FmDemod, dict(center=-24_000, bandwidth=12_000, decimate=4, taps=64, deviation=5000)),
    "am": (td.AmDemod, jd.AmDemod, dict(center=30_000, bandwidth=5_000, decimate=8, taps=128)),
    "ssb": (td.SsbDemod, jd.SsbDemod, dict(center=-20_000, bandwidth=3_000, decimate=8, taps=128)),
}


def assert_audio(got, want, what=""):
    rate_t, a_t = got
    rate_j, a_j = want
    assert rate_t == rate_j and a_t.dtype == np.float32 and a_t.shape == a_j.shape, what
    assert np.isfinite(a_t).all()
    err = float(np.abs(a_t - a_j).max())
    assert err <= FULL_SCALE_TOL, (what, err)


@pytest.mark.parametrize("chunk", [1 << 16, 4096, 1000, 333])
@pytest.mark.parametrize("fmt", ["cf32", "cs8"])
def test_fm_discriminator_at_several_chunks(fmt, chunk):
    """The discriminator (Hz) and the audio, at chunk sizes that cut the
    channel into 1 to 45 windows.  The lead sample makes each window's
    first output exact; ``chunk`` still moves the last outputs of each
    window, which see the channel FIR's per-read truncation (the taps past
    the window's block read zeros), in the JAX package as here: the
    samples that move are the same in both."""
    j, t = pair(capture("fm", fmt), fmt)
    kw = dict(RECEIVERS["fm"][2], chunk=chunk)
    rate, freq = td.FmDemod(**kw).discriminate_dev(t, device=CPU)
    j_rate, j_freq = jd.FmDemod(**kw).discriminate(j)
    assert rate == j_rate == 48_000 and freq.shape == j_freq.shape and len(freq) > 14_000
    assert float(np.abs(freq.numpy() - j_freq).max()) <= FULL_SCALE_TOL * 5000
    one = td.FmDemod(**dict(kw, chunk=1 << 20)).discriminate_dev(t, device=CPU)[1].numpy()
    j_one = jd.FmDemod(**dict(kw, chunk=1 << 20)).discriminate(j)[1]
    # what moves: the last ceil(taps/2)/decimate = 8 outputs of a window
    tail = np.arange(len(freq)) % min(chunk, len(freq)) >= min(chunk, len(freq)) - 8
    for a, b in ((freq.numpy(), one), (j_freq, j_one)):
        assert np.abs(a - b)[~tail].max() <= 1e-6 * 5000
    assert (np.abs(freq.numpy() - one)[tail].max() > 1.0) == (chunk < len(freq))
    assert_audio(td.FmDemod(**kw).demodulate(t, device=CPU), jd.FmDemod(**kw).demodulate(j), "fm audio")
    # the tone comes back: 1 kHz at 5 kHz peak deviation, so audio peaks near 1
    audio = td.FmDemod(**kw).demodulate(t, device=CPU)[1][200:]
    assert 0.95 < float(np.abs(audio).max()) < 1.1


@pytest.mark.parametrize("name", ["am", "ssb"])
@pytest.mark.parametrize("fmt", ["cf32", "cs8"])
@pytest.mark.parametrize("audio", [{}, {"audio_rate": 8000}, {"audio_decimate": 3, "audio_bandwidth": 2000}])
def test_am_and_ssb_against_jax(name, fmt, audio):
    tcls, jcls, kw = RECEIVERS[name]
    kw = dict(kw, chunk=1000, **audio)
    j, t = pair(capture(name, fmt, seed=len(fmt)), fmt)
    got = tcls(**kw).demodulate(t, device=CPU)
    assert_audio(got, jcls(**kw).demodulate(j), name)
    body = got[1][len(got[1]) // 8 :]
    # AM at depth 0.5 swings +/-0.5; the USB tone comes back at its amplitude
    assert abs(float(np.abs(body).max()) - (0.5 if name == "am" else 0.6)) < 0.05


@pytest.mark.parametrize("sideband", ["usb", "lsb"])
def test_ssb_sidebands(sideband):
    """The tone sits 1 kHz into the upper sideband: USB recovers it, LSB
    (with a filter sharp enough to part them) rejects it."""
    j, t = pair(capture("ssb", "cf32"), "cf32")
    kw = dict(RECEIVERS["ssb"][2], sideband=sideband, taps=2048)
    rate, audio = td.SsbDemod(**kw).demodulate(t, device=CPU)
    assert_audio((rate, audio), jd.SsbDemod(**kw).demodulate(j), sideband)
    rms = float(np.sqrt(np.mean(audio[len(audio) // 8 :].astype(np.float64) ** 2)))
    assert (rms > 0.35) if sideband == "usb" else (rms < 0.05)


@pytest.mark.parametrize(
    "n,rate,bandwidth,decimate,taps,target",
    [
        (5000, 48_000, None, 2, 64, None),  # the FIR alone, its default cutoff
        (5000, 48_000, 6000, 3, 33, None),  # an odd filter, its own cutoff
        (20_000, 48_000, None, 1, 64, 44_100),  # the resampler alone, 147/160
        (20_000, 250_000, 15_000, 5, 64, 48_000),  # both: 50 kHz to 48 kHz
        (3000, 48_000, None, 1, 64, 48_000),  # nothing but the prologue
    ],
)
def test_audio_tail_against_jax(n, rate, bandwidth, decimate, taps, target):
    """``audio_stage`` against the JAX package's fused ``_audio_stage_fused``
    program on the same f32 input, with FM's and AM's prologues."""
    rng = np.random.default_rng(n + decimate)
    x = (rng.normal(size=n) * 3000).astype(np.float32)
    demod = SimpleNamespace(audio_bandwidth=bandwidth, audio_decimate=decimate, audio_taps=taps, audio_rate=target)
    fn, j_rate = jd._audio_stage_fused(n, rate, bandwidth, decimate, taps, target)
    for div, bias in ((5000.0, 0.0), (2345.5, -1.0)):
        want = np.asarray(fn(jnp.asarray(x), jnp.float32(div), jnp.float32(bias)))
        assert_audio(td.audio_stage(demod, rate, torch.from_numpy(x), div, bias), (j_rate, want), (div, bias))


def test_audio_tail_errors_match_jax():
    x = torch.zeros(100)
    for demod, text in (
        (SimpleNamespace(audio_bandwidth=None, audio_decimate=2, audio_taps=200, audio_rate=None), "audio shorter than the audio filter"),
        (SimpleNamespace(audio_bandwidth=None, audio_decimate=1, audio_taps=64, audio_rate=4410), "audio shorter than the resampling filter"),
        (SimpleNamespace(audio_bandwidth=None, audio_decimate=1, audio_taps=64, audio_rate=0), "rates must be positive"),
    ):
        with pytest.raises(ValueError, match=text):
            td.audio_stage(demod, 48_000, x)
        with pytest.raises(ValueError, match=text):
            jd._audio_stage(demod, 48_000, np.zeros(100, np.float32), div=2.0)


@pytest.mark.parametrize("rate,n", [(48_000, 0), (8000, 1), (44_100, 1237)])
def test_wav_bytes_equal_jax(rate, n, tmp_path):
    samples = np.random.default_rng(n).normal(size=n).astype(np.float32)
    assert twav.wav_bytes(rate, samples) == jwav.wav_bytes(rate, samples)
    assert twav.wav_bytes(rate, samples.astype(np.float64)) == jwav.wav_bytes(rate, samples.astype(np.float64))
    path = twav.write_wav(str(tmp_path / "a.wav"), rate, samples)
    assert jwav.read_wav_f32(path) == (rate, pytest.approx(samples)) or n == 0
    with pytest.raises(FileExistsError):
        twav.write_wav(path, rate, samples)
    twav.write_wav(path, rate, samples[: n // 2], overwrite=True)
    assert open(path, "rb").read() == jwav.wav_bytes(rate, samples[: n // 2])
    with pytest.raises(ValueError, match="sample rate must be positive"):
        twav.wav_bytes(0, samples)
