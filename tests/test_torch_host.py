"""The port's host-side arrays are bitwise equal to quadrs_tpu's: decode,
staging, synthetic data, taps, NCO phases, the frontend's planners, the
STFT tables, and the SI / filename parsers.  Inputs come from numpy
seeds and go to both packages."""

import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from quadrs_tpu import formats as jf  # noqa: E402
from quadrs_tpu.ops import frontend_pallas as jfp  # noqa: E402
from quadrs_tpu.ops import stft as jstft  # noqa: E402
from quadrs_tpu.ops.fir import lowpass_taps as j_lowpass_taps  # noqa: E402
from quadrs_tpu.ops.nco import ExactNCO as JNCO  # noqa: E402
from quadrs_tpu.utils import si as jsi  # noqa: E402
from quadrs_tpu.utils import sniff as jsniff  # noqa: E402

from quadrs_tpu_torch import formats as tf  # noqa: E402
from quadrs_tpu_torch.models.receiver import PipelineConfig, PipelineModel  # noqa: E402
from quadrs_tpu_torch.ops import frontend as tfp  # noqa: E402
from quadrs_tpu_torch.ops import stft as tstft  # noqa: E402
from quadrs_tpu_torch.ops.fir import lowpass_taps as t_lowpass_taps  # noqa: E402
from quadrs_tpu_torch.ops.nco import ExactNCO as TNCO  # noqa: E402
from quadrs_tpu_torch.utils import si as tsi  # noqa: E402
from quadrs_tpu_torch.utils import sniff as tsniff  # noqa: E402

FORMATS = ["cf32", "cs8", "cu8", "cs16"]
ROOT = pathlib.Path(__file__).resolve().parent.parent


def bits_equal(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and a.tobytes() == b.tobytes()


def all_codes(fmt: str) -> np.ndarray:
    """Every raw code of an integer format (cf32: seeded values plus the
    specials), as a (2, n) plane pair."""
    dtype = jf.FileFormat(fmt).raw_dtype
    if fmt == "cf32":
        x = np.random.default_rng(1).normal(scale=3.0, size=4094).astype(np.float32)
        x = np.concatenate([x, np.array([np.nan, np.inf, -np.inf, -0.0, 1e-45, 3e38], np.float32)])
    else:
        info = np.iinfo(dtype)
        x = np.arange(info.min, info.max + 1).astype(dtype)
    return np.stack([x, x[::-1]])


@pytest.mark.parametrize("fmt", FORMATS)
def test_decode_bitwise(fmt):
    raw = all_codes(fmt)
    want = jf.decode_plane(raw, jf.FileFormat(fmt), xp=np)
    want_jnp = np.asarray(jf.decode_plane(jnp.asarray(raw), jf.FileFormat(fmt), xp=jnp))
    assert bits_equal(want, want_jnp)
    got_np = tf.decode_plane(raw, tf.FileFormat(fmt))
    got_torch = tf.decode_plane(torch.from_numpy(raw), tf.FileFormat(fmt)).numpy()
    assert bits_equal(got_np, want)
    assert bits_equal(got_torch, want)


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("n_bytes", [0, 37, 4096 + 5])
def test_planes_from_bytes_bitwise(fmt, n_bytes):
    buf = np.random.default_rng(n_bytes).integers(0, 256, n_bytes).astype(np.uint8)
    want = jf.planes_from_bytes(buf, jf.FileFormat(fmt))
    got = tf.planes_from_bytes(buf, tf.FileFormat(fmt))
    assert bits_equal(got, want)
    assert bits_equal(tf.view_raw(buf, tf.FileFormat(fmt)), jf.view_raw(buf, jf.FileFormat(fmt)))


@pytest.mark.parametrize("fmt", FORMATS)
def test_synth_planes_and_encode_bitwise(fmt):
    for seed, n_streams in [(0, None), (7, None), (3, 2)]:
        want = jf.synth_planes(jf.FileFormat(fmt), 1000, seed, n_streams)
        assert bits_equal(tf.synth_planes(tf.FileFormat(fmt), 1000, seed, n_streams), want)
    # inside each format's representable band (cu8/cs16 sit at their DC offsets)
    x = np.random.default_rng(5).uniform(-0.45, 0.45, size=(300, 2)).astype(np.float32)
    samples = (x[:, 0] + 1j * x[:, 1]).astype(np.complex64)
    if fmt in ("cu8", "cs16"):
        samples = samples - np.complex64((1 + 1j) * (127.0 if fmt == "cu8" else 32767.5))
    assert tf.encode_samples(samples, tf.FileFormat(fmt)) == jf.encode_samples(samples, jf.FileFormat(fmt))


@pytest.mark.parametrize("cutoff,size", [(200e3 / 21e6, 400), (0.05, 40), (0.1, 77), (0.01, 4000), (0.3, 2)])
def test_lowpass_taps_bitwise(cutoff, size):
    assert bits_equal(t_lowpass_taps(cutoff, size), j_lowpass_taps(cutoff, size))


NCO_CASES = [(280_000, 21_000_000), (-12_345, 1_000_000), (0, 48_000), (21_000_005, 21_000_000), (3, (1 << 31) + 11)]


@pytest.mark.parametrize("freq,sr", NCO_CASES)
def test_exact_nco_bitwise(freq, sr):
    idx = np.concatenate([
        np.arange(5000, dtype=np.int64),
        999_999_937 + np.arange(300, dtype=np.int64),
        np.array([2**40 + 17, 123_456_789_012], dtype=np.int64),
    ])
    j, t = JNCO(freq, sr), TNCO(freq, sr)
    assert bits_equal(t.angles(idx), j.angles(idx))
    assert bits_equal(t.angles(idx, dtype=np.float64), j.angles(idx, dtype=np.float64))
    for a, b in zip(t.cis(idx), j.cis(idx)):
        assert bits_equal(a, b)


# (fmt, decimate, taps): both tile sizes, m_sub up to 125 (quartered tiles)
PLAN_CASES = [("cs8", 32, 400), ("cf32", 3, 40), ("cu8", 8, 300), ("cs16", 64, 400), ("cf32", 32, 4000), ("cs8", 5, 77)]


def specs(fmt, d, taps):
    h = j_lowpass_taps(200e3 / 21e6, taps)
    args = dict(sample_rate=21_000_000, shift_freq=280_000, decimate=d, taps_bytes=h.tobytes())
    return (
        jfp.FrontendSpec(fmt=jf.FileFormat(fmt), **args),
        tfp.FrontendSpec(fmt=tf.FileFormat(fmt), **args),
    )


@pytest.mark.parametrize("fmt,d,taps", PLAN_CASES)
def test_frontend_planners_bitwise(fmt, d, taps):
    js, ts = specs(fmt, d, taps)
    assert tfp._tout_t(ts) == jfp._tout_t(js)
    assert tfp.supported_t(d) == jfp.supported_t(d)
    want, got = jfp._plan_t(js), tfp._plan_t(ts)
    assert got[:2] == want[:2]
    for a, b in zip(got[2:], want[2:]):
        assert bits_equal(a, b)
    for start in (0, 200, 999_999_937):
        for n_out in (1, 3000, 20_000):
            assert bits_equal(tfp.tile_bases_t(ts, start, n_out), jfp.tile_bases_t(js, start, n_out))


@pytest.mark.parametrize("fmt,d,taps", PLAN_CASES)
def test_stream_bases_bitwise(fmt, d, taps):
    from quadrs_tpu.models.receiver import PipelineConfig as JConfig
    from quadrs_tpu.models.receiver import PipelineModel as JModel

    args = dict(sample_rate=21_000_000, shift_freq=280_000, lp_freq=200_000, decimate=d, taps=taps, fft_width=64)
    jm = JModel(JConfig(fmt=jf.FileFormat(fmt), **args))
    tm = PipelineModel(PipelineConfig(fmt=tf.FileFormat(fmt), **args))
    assert bits_equal(tm.taps.numpy(), jm.taps)
    for off in (0, 4096, 999_999_937):
        assert bits_equal(tm.stream_bases(off, 300_000), jm.stream_bases(off, 300_000))
        assert bits_equal(tm.theta0(np.asarray([off])), jm.theta0(np.asarray([off])))


@pytest.mark.parametrize("width", [2, 8, 32, 64, 128])
def test_stft_tables_bitwise(width):
    for a, b in zip(tfp._plan_stft(width), jfp._plan_stft(width)):
        assert bits_equal(a, b)
    assert tfp.stft_fusable(width) == jfp.stft_fusable(width)
    for w in (48, 256, 1):
        assert tfp.stft_fusable(w) == jfp.stft_fusable(w)
    assert bits_equal(tstft.blackman_harris_window(width), jstft.blackman_harris_window(width))
    x = np.random.default_rng(width).normal(size=(3, width)).astype(np.float32)
    assert bits_equal(tstft.fftshift(torch.from_numpy(x)).numpy(), np.asarray(jstft.fftshift(jnp.asarray(x))))


def test_si_is_a_verbatim_copy():
    port = (ROOT / "quadrs_tpu_torch" / "utils" / "si.py").read_bytes()
    assert port == (ROOT / "quadrs_tpu" / "utils" / "si.py").read_bytes()


SI_TEXTS = ["0", "4M", "200k", "-5k", "2G", "+3", "1_0", " 7", "", "k", "2.5k", "1e3", "yes", "n", "true", "maybe"]


@pytest.mark.parametrize(
    "name", ["parse_si_int", "parse_si_uint", "parse_si_float", "parse_plain_uint", "parse_plain_float", "parse_bool"]
)
def test_si_parsers_agree(name):
    for text in SI_TEXTS:
        outcomes = []
        for mod in (jsi, tsi):
            try:
                outcomes.append(("ok", getattr(mod, name)(text)))
            except ValueError as e:
                outcomes.append(("err", str(e)))
        assert outcomes[0] == outcomes[1], (name, text)


SNIFF_NAMES = [
    "fsk-example.sr21M.fc32",
    "smoke.sr21M.cs8",
    "cap.sr48000.cf32",
    "gqrx_20200101_433920000_2000000_fc.raw",
    "g001_433.92M_250k.cu8",
    "weird.sr2M.c16",
    "nothing.bin",
    "cap.sr400.sc8",
    "noext",
]


@pytest.mark.parametrize("filename", SNIFF_NAMES)
def test_sniff_agrees(filename):
    def run(mod, *args):
        try:
            d = mod.guess_details(filename, *args)
            return ("ok", d.format.value, d.sample_rate)
        except ValueError as e:
            return ("err", str(e))

    j_rate, j_fmt = jsniff.guess_format_from_name(filename)
    t_rate, t_fmt = tsniff.guess_format_from_name(filename)
    assert (t_rate, t_fmt and t_fmt.value) == (j_rate, j_fmt and j_fmt.value)
    for args in [(), ("1M", None), (None, "cu8"), ("5k", "cs16"), (None, "bogus")]:
        assert run(tsniff, *args) == run(jsniff, *args)
