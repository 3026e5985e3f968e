"""PSK (``psk``, ``models.demod.PskDemod``) against the JAX package.

The same bursts, made with numpy from a seed, go through
``quadrs_tpu.models.demod.PskDemod`` and the port's, on the CPU.

Tolerances, and why:
- the host tables (``rot``, ``tim``, the ``-block`` detrend ramp) are
  bitwise JAX's: the same f64 formulas from the same inputs;
- ``khat`` (the refined carrier bin) within 1e-3 bins: the power spectrum
  is f32 from another FFT (a flat peak may move ``k0`` one bin; the
  parabola's +/-0.5 clamp then lands on the same point);
- ``z`` (the matched filter's output) within ``8 * sqrt(npad) * eps *
  max|y| / mf_len``: an f32 ``cumsum`` difference whose additions run in
  another order than XLA's, so each prefix carries a rounding walk of
  about ``sqrt(n) * eps * max|y|`` (the burst is derotated, so the prefix
  itself stays a random walk);
- phase within 1e-5 rad, tau within 1e-4 samples, freq within 1e-3 Hz;
- the bits exactly, but where JAX's decision angle lies within 1e-5 rad
  of a boundary (counted, and none of them is skipped: each one must be
  such a near-tie).
"""

import io
import math
import re
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from test_psk import QPSK_GRAY, SR, cf32_source, psk_iq, want_bits  # noqa: E402

from quadrs_tpu import cli as jcli  # noqa: E402
from quadrs_tpu.models import demod as jdemod  # noqa: E402

from quadrs_tpu_torch import cli as tcli  # noqa: E402
from quadrs_tpu_torch.formats import FileFormat  # noqa: E402
from quadrs_tpu_torch.models import demod as tdemod  # noqa: E402
from quadrs_tpu_torch.sources import SampleSource  # noqa: E402

DEC, TAPS, BW = 8, 128, 20_000
RATE = SR // DEC
EPS = float(np.finfo(np.float32).eps)
NEAR = 1e-5  # rad: a decision angle this close to a boundary is a near-tie


def kw(order, symbol_rate=8_000.0, **extra):
    return dict(bandwidth=BW, decimate=DEC, taps=TAPS, symbol_rate=symbol_rate, order=order, **extra)


def port_source(x: np.ndarray) -> SampleSource:
    raw = np.empty(2 * len(x), dtype="<f4")
    raw[0::2], raw[1::2] = x.real, x.imag
    return SampleSource(np.frombuffer(raw.tobytes(), dtype=np.uint8), FileFormat.COMPLEX_FLOAT32, SR)


def burst(order, payload_seed, n_sym=200, **psk):
    rng = np.random.default_rng(payload_seed)
    incr = rng.integers(0, order, n_sym)
    return incr, psk_iq(incr, order, SR / psk.pop("symbol_rate", 8_000.0), SR, **psk)


def decision_angles(sym: np.ndarray, differential: bool) -> np.ndarray:
    s = sym.astype(np.complex128)
    d = s[1:] * np.conj(s[:-1]) if differential else s
    return np.arctan2(d.imag, d.real)


def near_ties(ang: np.ndarray, order: int) -> np.ndarray:
    """Decisions whose angle lies within NEAR of a slicing boundary (the
    boundaries sit half a step between the order-th roots)."""
    step = 2 * np.pi / order
    frac = ang / step - 0.5
    return np.abs(frac - np.round(frac)) * step < NEAR


def assert_bits_equal_but_near_ties(got: list[int], want: list[int], jax_sym: np.ndarray, order: int, differential: bool) -> int:
    """Bits equal but at JAX's near-ties; returns how many decisions differ."""
    per = 2 if order == 4 else 1
    assert len(got) == len(want)
    g = np.asarray(got).reshape(-1, per)
    w = np.asarray(want).reshape(-1, per)
    bad = np.flatnonzero((g != w).any(axis=1))
    ties = near_ties(decision_angles(jax_sym, differential), order)
    assert ties[bad].all(), f"decisions {bad[~ties[bad]]} differ away from a boundary"
    return len(bad)


def test_host_tables_bitwise(monkeypatch):
    """``rot`` and ``tim`` from JAX's own ``khat`` and ``sps`` (captured from
    its run) equal the port's ``psk_tables`` bit for bit."""
    _, x = burst(4, 3, f_off=-412.0, phase0=0.4, noise=0.02, seed=3)
    rate, base = jdemod.PskDemod(**kw(4)).baseband(cf32_source(x, SR))
    seen = {}
    real_peak, real_proc = jdemod.PskDemod._peak_khat, jdemod._psk_process_fn

    def peak(self, planes, n, npad):
        seen["khat"], seen["npad"] = real_peak(self, planes, n, npad), npad
        return seen["khat"]

    def proc(npad, order, mf_len):
        fn = real_proc(npad, order, mf_len)

        def run(planes, rot, tim, n):
            seen["rot"], seen["tim"] = np.asarray(rot), np.asarray(tim)
            return fn(planes, rot, tim, n)

        return run

    monkeypatch.setattr(jdemod.PskDemod, "_peak_khat", peak)
    monkeypatch.setattr(jdemod, "_psk_process_fn", proc)
    jdemod.PskDemod(**kw(4)).analyze(rate, base)
    rot, tim = tdemod.psk_tables(seen["khat"], seen["npad"], 4, rate / 8_000.0)
    assert rot.dtype == tim.dtype == np.float32
    np.testing.assert_array_equal(rot, seen["rot"])
    np.testing.assert_array_equal(tim, seen["tim"])


def test_detrend_ramp_bitwise(monkeypatch):
    """``-block``'s ramp: the same block frequencies give the same detrended
    burst and track mean, bit for bit (the block peaks are the device's and
    are held by ``test_peak_khat_against_jax``)."""
    _, x = burst(2, 4, n_sym=256, f_off=400.0, phase0=0.7, drift=187_500.0)
    rate, base = jdemod.PskDemod(**kw(2)).baseband(cf32_source(x, SR))
    freqs = iter(np.linspace(-1_234.5, 5_678.25, 64))
    table = {}

    def fixed(self, rate, xb, *device):
        key = (len(xb), complex(xb[0]))
        if key not in table:
            table[key] = float(next(freqs))
        return table[key]

    monkeypatch.setattr(jdemod.PskDemod, "_block_freq", fixed)
    monkeypatch.setattr(tdemod.PskDemod, "_block_freq", fixed)
    want, want_mean = jdemod.PskDemod(**kw(2, block=512))._carrier_detrend(rate, base)
    got, got_mean = tdemod.PskDemod(**kw(2, block=512))._carrier_detrend(rate, base, "cpu")
    assert got.dtype == np.complex64 and got_mean == want_mean
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("order", [2, 4])
@pytest.mark.parametrize("f_off", [-731.0, 0.0, 123.4, 2_000.0, "between"])
def test_peak_khat_against_jax(order, f_off):
    """The refined peak at several carrier offsets, and at one placed exactly
    between two bins of the order-th power's spectrum (a flat peak: the
    two packages may pick either bin as ``k0``, and the clamp lands both on
    the midpoint)."""
    n = 3000
    npad = 4096
    if f_off == "between":
        f_off = (37 + 0.5) * RATE / (order * npad)
    t = np.arange(n)
    x = np.exp(2j * np.pi * f_off * t / RATE + 0.3j).astype(np.complex64)
    planes = np.zeros((2, npad), dtype=np.float32)
    planes[0, :n], planes[1, :n] = x.real, x.imag
    want = jdemod.PskDemod(**kw(order))._peak_khat(planes, n, npad)
    got = tdemod.PskDemod(**kw(order))._peak_khat(planes, n, npad, torch.device("cpu"))
    assert abs(got - want) < 1e-3, (got, want)
    assert abs(got / (order * npad) * RATE - f_off) < RATE / (order * npad)


def test_matched_filter_against_jax():
    """The process program's ``z`` against JAX's at the tolerance the module
    docstring derives, and its two sums."""
    order = 2
    _, x = burst(order, 5, n_sym=600, f_off=250.0, phase0=0.2, noise=0.05, seed=9)
    rate, base = jdemod.PskDemod(**kw(order)).baseband(cf32_source(x, SR))
    n = len(base)
    planes, npad = tdemod._padded_planes(base)
    sps = rate / 8_000.0
    mf_len = int(round(sps))
    rot, tim = tdemod.psk_tables(12.375, npad, order, sps)
    z_pl, s_pl, e_pl = jdemod._psk_process_fn(npad, order, mf_len)(planes, rot, tim, np.int32(n))
    want = np.asarray(z_pl[0]) + 1j * np.asarray(z_pl[1])
    z, se = tdemod.psk_process(*(torch.from_numpy(a) for a in (planes, rot, tim)), n, order, mf_len)
    y = (planes[0] + 1j * planes[1]) * (rot[0] + 1j * rot[1])
    tol = 8 * math.sqrt(npad) * EPS * float(np.abs(y).max()) / mf_len
    assert float(np.abs(z.numpy() - want).max()) <= tol
    s, e = complex(float(s_pl[0]), float(s_pl[1])), complex(float(e_pl[0]), float(e_pl[1]))
    got_s, got_e = complex(se[0], se[1]), complex(se[2], se[3])
    assert abs(got_s - s) <= 1e-5 * abs(s) and abs(got_e - e) <= 1e-5 * abs(e)


@pytest.mark.parametrize(
    "order,differential,block,f_off,symbol_rate,drift",
    [
        (2, True, 0, 437.0, 8_000.0, 0.0),
        (4, True, 0, -512.0, 8_000.0, 0.0),
        (2, False, 0, 120.0, 7_000.0, 0.0),
        (4, False, 0, 89.0, 6_400.0, 0.0),
        (2, True, 512, 400.0, 8_000.0, 187_500.0),
        (4, True, 512, -900.0, 8_000.0, 0.0),
    ],
)
def test_analyze_against_jax(order, differential, block, f_off, symbol_rate, drift):
    """``analyze`` on JAX's own baseband: the estimates and the symbols
    within the stated tolerances, the bits exact but at near-ties; the
    port's baseband equals JAX's within 2e-6 of its scale (the channel
    FIR's f32 sums).  The drifting burst (a 6 kHz sweep) is BPSK's: its
    residual would pass QPSK's 1 kHz budget in both packages."""
    incr, x = burst(order, order * 100 + block, n_sym=256, f_off=f_off, phase0=2.1, noise=0.03, seed=7,
                    symbol_rate=symbol_rate, drift=drift)
    args = kw(order, symbol_rate, differential=differential, block=block)
    rate, base = jdemod.PskDemod(**args).baseband(cf32_source(x, SR))
    t_rate, t_base = tdemod.PskDemod(**args).baseband(port_source(x), device="cpu")
    assert t_rate == rate == RATE and t_base.shape == base.shape
    assert float(np.abs(t_base - base).max()) <= 2e-6 * float(np.abs(base).max())
    want_est, want_sym = jdemod.PskDemod(**args).analyze(rate, base)
    est, sym = tdemod.PskDemod(**args).analyze(rate, base, device="cpu")
    assert (est.sps, est.rate, est.n) == (want_est.sps, want_est.rate, want_est.n)
    assert abs(est.freq_hz - want_est.freq_hz) < 1e-3
    assert abs(est.phase - want_est.phase) < 1e-5
    assert abs(est.tau - want_est.tau) < 1e-4
    assert sym.dtype == np.complex64 and sym.shape == want_sym.shape
    assert float(np.abs(sym - want_sym).max()) <= 1e-4 * float(np.abs(want_sym).max())
    got = tdemod.PskDemod(**args).slice(sym)
    want = jdemod.PskDemod(**args).slice(want_sym)
    assert_bits_equal_but_near_ties(got, want, want_sym, order, differential)
    if differential:  # the payload itself comes back
        assert "".join(map(str, got)) in want_bits(incr, order)


@pytest.mark.parametrize("order", [2, 4])
@pytest.mark.parametrize("differential", [True, False])
def test_slice_gray_map(order, differential):
    """``slice`` equals JAX's on random symbols (Gray 00 01 11 10 for QPSK),
    none of them near a boundary."""
    rng = np.random.default_rng(order + 10 * differential)
    sym = (np.exp(1j * rng.uniform(-np.pi, np.pi, 400)) * rng.uniform(0.5, 2, 400)).astype(np.complex64)
    assert not near_ties(decision_angles(sym, differential), order).any()
    args = kw(order, differential=differential)
    got = tdemod.PskDemod(**args).slice(sym)
    assert got == jdemod.PskDemod(**args).slice(sym)
    if order == 4 and not differential:
        pos = np.round(np.angle(sym) * 2 / np.pi).astype(int) % 4
        assert got == [b for p in pos for b in QPSK_GRAY[int(p)]]


def test_errors_match_jax():
    src = port_source(np.ones(4096, dtype=np.complex64))
    for args, match in (
        (dict(order=3, symbol_rate=1000.0), "order"),
        (dict(order=2), "symbol_rate"),
    ):
        with pytest.raises(ValueError, match=match):
            tdemod.PskDemod(**args).channel(src)
    with pytest.raises(ValueError, match="samples/symbol"):
        tdemod.PskDemod(**kw(2, 100_000.0)).demodulate(src, device="cpu")
    with pytest.raises(ValueError, match="too short") as t_err:
        tdemod.PskDemod(**kw(2)).demodulate(port_source(np.ones(512, np.complex64)), device="cpu")
    with pytest.raises(ValueError, match="too short") as j_err:
        jdemod.PskDemod(**kw(2)).demodulate(cf32_source(np.ones(512, np.complex64), SR))
    assert str(t_err.value) == str(j_err.value)
    with pytest.raises(ValueError, match="raise -block"):
        tdemod.PskDemod(**kw(2, block=32)).demodulate(src, device="cpu")
    with pytest.raises(ValueError, match="2 symbols"):
        tdemod.PskDemod(**kw(2)).slice(np.ones(1, dtype=np.complex64))


# ------------------------------------------------------------------ the CLI


def run(main, argv, capsys):
    rc = main(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


@pytest.fixture
def cpu(monkeypatch, tmp_path):
    monkeypatch.setenv("QUADRS_PLATFORM", "cpu")
    monkeypatch.chdir(tmp_path)
    return tmp_path


def write_burst(path, order, seed=41, drift=0.0, fmt="cf32"):
    rng = np.random.default_rng(seed)
    incr = rng.integers(0, order, 256 if drift else 128)
    x = psk_iq(incr, order, SR / 8_000.0, SR, f_off=150.0 if not drift else 400.0, phase0=0.4, drift=drift)
    if fmt == "cf32":
        raw = np.empty(2 * len(x), dtype="<f4")
        raw[0::2], raw[1::2] = x.real, x.imag
    else:
        raw = np.clip(np.rint(np.stack([x.real, x.imag], -1) * 100), -127, 127).astype(np.int8)
    name = path / f"psk.sr{SR}.{fmt}"
    raw.tofile(name)
    return str(name), incr


TRAILER = re.compile(r"psk: (\d+) bits, freq ([-+0-9.]+) Hz, phase ([-+0-9.]+) rad, tau ([0-9.]+), sps (\S+)")


def assert_same_run(t_out: str, j_out: str) -> None:
    """Bits line equal; the trailer's numbers within their print
    resolution (one unit of the last printed digit)."""
    t_lines, j_lines = t_out.splitlines(), j_out.splitlines()
    assert len(t_lines) == len(j_lines) and t_lines[0] == j_lines[0]
    tm, jm = TRAILER.fullmatch(t_lines[1]), TRAILER.fullmatch(j_lines[1])
    assert tm and jm and tm[1] == jm[1] and tm[5] == jm[5]
    for i, unit in ((2, 0.1), (3, 1e-3), (4, 1e-2)):
        assert abs(float(tm[i]) - float(jm[i])) <= unit, (t_lines[1], j_lines[1])
    assert t_lines[2:] == j_lines[2:]


BASE = ["psk", "-lowpass", "20k", "-power", "64", "-decimate", "8", "-symbol-rate", "8k"]


@pytest.mark.parametrize("extra,order,fmt", [([], 2, "cf32"), (["-order", "4"], 4, "cf32"), ([], 2, "cs8"),
                                            (["-differential", "no"], 2, "cf32"), (["-block", "512"], 2, "drift")])
def test_cli_against_quadjax(extra, order, fmt, cpu, capsys):
    drift = 187_500.0 if fmt == "drift" else 0.0
    path, incr = write_burst(cpu, order, drift=drift, fmt="cs8" if fmt == "cs8" else "cf32")
    argv = BASE + extra + [path]
    rc, t_out, err = run(tcli.main, argv, capsys)
    assert (rc, err) == (0, "")
    j_rc, j_out, _ = run(jcli.main, argv, capsys)
    assert j_rc == 0
    assert_same_run(t_out, j_out)
    if "-differential" not in extra:
        assert t_out.splitlines()[0] in want_bits(incr, order)
    if drift:  # one whole-burst estimate fails the drifting burst in both packages
        rc, single, _ = run(tcli.main, BASE + [path], capsys)
        assert rc == 0 and single.splitlines()[0] not in want_bits(incr, order)


def test_cli_plot_and_overwrite(cpu, capsys):
    """``-plot`` writes the constellation (decoded here by PIL: the port has
    no Pillow), refuses to clobber it, and ``-overwrite yes`` rewrites it;
    the image equals JAX's but for counted pixels of symbols whose pixel
    coordinate lies within 1e-3 px of a rounding boundary."""
    from PIL import Image

    from quadrs_tpu.viz.constellation import constellation_render as j_render
    from quadrs_tpu_torch.viz.constellation import SIZE, constellation_render

    path, _ = write_burst(cpu, 4)
    argv = BASE + ["-order", "4", "-plot", "c.png", path]
    rc, out, err = run(tcli.main, argv, capsys)
    assert (rc, err) == (0, "") and "psk: constellation -> c.png" in out
    img = np.asarray(Image.open(cpu / "c.png"))
    assert img.shape == (SIZE, SIZE, 3) and (img[..., 2] > 0).sum() > 4
    est, sym = tdemod.PskDemod(**kw(4)).symbols(port_source_file(path), device="cpu")
    np.testing.assert_array_equal(img, constellation_render(sym, 4))
    rc, out, err = run(tcli.main, argv, capsys)
    assert rc == 1 and "File exists" in err
    assert run(tcli.main, BASE + ["-order", "4", "-overwrite", "yes", "-plot", "c.png", path], capsys)[0] == 0
    # against the JAX package's symbols: the same picture but at rounding edges
    from quadrs_tpu.sources import open_capture as j_open

    _, j_sym = jdemod.PskDemod(**kw(4)).symbols(j_open(path))
    diff = (constellation_render(sym, 4) != j_render(j_sym, 4)).any(-1)
    med = float(np.median(np.abs(j_sym)))
    px = np.concatenate([j_sym.real, -j_sym.imag]) * (0.38 * SIZE) / med
    near = np.abs(px - np.floor(px) - 0.5) < 1e-3
    assert diff.sum() <= 2 * near.sum(), (int(diff.sum()), int(near.sum()))
    # the renderer itself is JAX's, pixel for pixel, on the same symbols
    np.testing.assert_array_equal(constellation_render(j_sym, 4), j_render(j_sym, 4))


def port_source_file(path):
    from quadrs_tpu_torch.sources import open_capture

    return open_capture(path)


def test_cli_stdin(cpu, capsys, monkeypatch):
    path, incr = write_burst(cpu, 2)
    with open(path, "rb") as f:
        monkeypatch.setattr(sys, "stdin", SimpleNamespace(buffer=io.BytesIO(f.read())))
    rc, out, err = run(tcli.main, BASE + ["-stdin", "yes", "-sr", str(SR), "-format", "cf32"], capsys)
    assert (rc, err) == (0, "")
    assert out == run(tcli.main, BASE + [path], capsys)[1]


def test_cli_mesh_refused_and_parse_errors_match_jax(cpu, capsys):
    """``psk -mesh 2`` over a burst of 8400 symbols (two full 65536-sample
    windows of the front end, so the mesh dispatch engages): the
    single-device run's lines, the payload, and quadjax's mesh run; the
    parse errors, ``-mesh 2x2`` and ``-mesh`` with ``-stdin`` among them,
    are quadjax's."""
    incr = np.random.default_rng(43).integers(0, 2, 8400)
    x = psk_iq(incr, 2, SR / 8_000.0, SR, f_off=150.0, phase0=0.4)
    path = cpu / f"long.sr{SR}.cf32"
    path.write_bytes(np.stack([x.real, x.imag], -1).astype("<f4").tobytes())
    t_rc, mesh_out, err = run(tcli.main, BASE + ["-mesh", "2", str(path)], capsys)
    assert (t_rc, err) == (0, "")
    assert run(tcli.main, BASE + [str(path)], capsys)[1] == mesh_out
    assert mesh_out.splitlines()[0] in want_bits(incr, 2)
    j_rc, j_out, _ = run(jcli.main, BASE + ["-mesh", "2", str(path)], capsys)
    assert j_rc == 0
    assert_same_run(mesh_out, j_out)
    for argv in (["psk"], ["psk", "x.sr1M.cf32"], ["psk", "-symbol-rate", "8k", "-order", "3", "x.sr1M.cf32"],
                 ["psk", "-symbol-rate", "0", "x.sr1M.cf32"], ["psk", "-symbol-rate", "8k", "-mesh", "2x2", "x.sr1M.cf32"],
                 ["psk", "-symbol-rate", "8k", "-mesh", "2", "-stdin", "yes", "-sr", "1M", "-format", "cf32"],
                 ["psk", "-symbol-rate", "8k", "-stdin", "yes"], ["psk", "-symbol-rate", "8k", "-bogus", "1", "x.sr1M.cf32"]):
        j_rc, _, j_err = run(jcli.main, argv, capsys)
        t_rc, _, t_err = run(tcli.main, argv, capsys)
        assert (t_rc, t_err) == (j_rc, j_err) and t_rc == 1, argv
    assert "psk [-shift 0]" in tcli.USAGE
