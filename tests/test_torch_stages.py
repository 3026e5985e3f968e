"""The conditioning stages and the resampler (``quadrs_tpu_torch.stream``
``DcBlock``, ``Agc``, ``IqCorrect``, ``Resample``; ``ops/resample.py``)
on the CPU, against the JAX package's.

Reads agree for cf32, cs8 and cu8 at random offsets and pull sizes:
``rtol/atol 1e-4`` for the trailing stages (their f32 prefix sums), the
atol in units of the capture's decoded magnitude (cu8 decodes to about
-127, and the JAX package's prefix sums carry that scale's rounding; the
port's DcBlock is held to its f64 formula within 3e-5 of its output),
``2e-6`` for ``Resample``, as the JAX package's own tests hold them to
their oracles.
The stages are pull-size invariant: tiled reads equal one long read.  The
IQ coefficient is bitwise the JAX package's on cf32; on cs8 within 1e-6
(the JAX package's jitted cs8 decode is an ulp off on 16 codes).  The
resampler's tables are bitwise the JAX package's."""

import pathlib

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from quadrs_tpu import cli as jcli  # noqa: E402
from quadrs_tpu import sources as jsources  # noqa: E402
from quadrs_tpu import stream as jstream  # noqa: E402
from quadrs_tpu.formats import FileFormat as JFormat  # noqa: E402
from quadrs_tpu.ops import resample as jresample  # noqa: E402

from quadrs_tpu_torch import cli as tcli  # noqa: E402
from quadrs_tpu_torch import sources as tsources  # noqa: E402
from quadrs_tpu_torch import stream as tstream  # noqa: E402
from quadrs_tpu_torch.formats import FileFormat, decode_plane, planes_from_bytes  # noqa: E402
from quadrs_tpu_torch.ops import resample as tresample  # noqa: E402

CPU = "cpu"
FORMATS = ["cf32", "cs8", "cu8"]
# the decoded magnitude the JAX package's f32 prefix sums grow with: unit
# scale for cf32 and cs8 (the JAX package's tests), cu8's parked -127 baseline
SCALE = {"cf32": 1.0, "cs8": 1.0, "cu8": 128.0}


def capture_bytes(fmt: str, n: int, seed: int, dc: complex = 0.3 - 0.2j) -> np.ndarray:
    """``n`` seeded samples of ``fmt``: noise with a DC offset and a slow
    amplitude swell (so that the AGC has something to level)."""
    rng = np.random.default_rng(seed)
    swell = 0.2 + np.abs(np.sin(np.arange(n) * 3e-3))
    x = (rng.normal(size=n) + 1j * rng.normal(size=n)) * swell + dc
    if fmt == "cf32":
        return np.ascontiguousarray(x.astype(np.complex64)).view(np.uint8)
    if fmt == "cs8":
        iq = np.stack([x.real, x.imag], axis=-1) * 40
        return np.clip(np.rint(iq), -127, 127).astype(np.int8).view(np.uint8).reshape(-1)
    iq = np.stack([x.real, x.imag], axis=-1) * 40 + 127.5
    return np.clip(np.rint(iq), 0, 255).astype(np.uint8).reshape(-1)


def pair(fmt: str, n: int = 1500, seed: int = 7, sr: int = 48_000):
    raw = capture_bytes(fmt, n, seed)
    return jsources.SampleSource(raw, JFormat(fmt), sr), tsources.SampleSource(raw, FileFormat(fmt), sr)


def stages(kind: str, j_src, t_src):
    """(JAX stage, port stage) of ``kind`` over the two sources."""
    if kind.startswith("dcblock"):
        w = int(kind.split()[1])
        return jstream.DcBlock(j_src, w), tstream.DcBlock(t_src, w)
    if kind.startswith("agc"):
        w = int(kind.split()[1])
        return (jstream.Agc(j_src, target=0.5, window=w, max_gain=100.0),
                tstream.Agc(t_src, target=0.5, window=w, max_gain=100.0))
    if kind == "iqbal":
        return jstream.IqCorrect(j_src, est_samples=1000), tstream.IqCorrect(t_src, est_samples=1000, device=CPU)
    up, down, size = (int(v) for v in kind.split()[1:])
    return jstream.Resample(j_src, up, down, size=size), tstream.Resample(t_src, up, down, size=size)


KINDS = ["dcblock 1", "dcblock 7", "dcblock 300", "agc 1", "agc 50", "agc 256", "iqbal", "resample 3 2 48",
         "resample 2 3 40", "resample 7 3 80", "resample 147 160 2560"]


def tolerance(kind: str, fmt: str) -> dict:
    if kind.startswith("resample"):
        return dict(rtol=2e-6, atol=2e-6 * SCALE[fmt])
    return dict(rtol=1e-4, atol=1e-4 * SCALE[fmt])


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("fmt", FORMATS)
def test_stage_reads_match_jax(kind, fmt):
    """The same reads through both packages: lengths, rates and valid counts
    equal, samples within the stage's tolerance; the trailing stages' and
    the corrector's outputs are zero past the valid count."""
    if kind == "resample 147 160 2560":
        j_src, t_src = pair(fmt, n=4000, sr=160 * 300)
    else:
        j_src, t_src = pair(fmt)
    j, t = stages(kind, j_src, t_src)
    assert (t.length, t.sample_rate) == (j.length, j.sample_rate)
    rng = np.random.default_rng(len(kind) + len(fmt))
    reads = [(0, t.length), (t.length - 50, 200)] + [
        (int(rng.integers(0, t.length)), int(rng.integers(1, 400))) for _ in range(4)]
    for off, n in reads:
        want, want_valid = j.read_at(off, n)
        got, valid = t.read_at(off, n, CPU)
        assert valid == want_valid, (off, n)
        if kind.startswith("resample"):
            # past the valid count both compute the same sums over the zeroed tail
            np.testing.assert_allclose(got, np.asarray(want), **tolerance(kind, fmt))
        else:
            np.testing.assert_allclose(got[:valid], np.asarray(want)[:valid], **tolerance(kind, fmt))
            assert np.all(got[valid:] == 0)


@pytest.mark.parametrize("kind", ["dcblock 64", "agc 50", "resample 3 2 48", "resample 147 160 2560"])
@pytest.mark.parametrize("fmt", ["cf32", "cu8"])
def test_stage_is_pull_size_invariant(kind, fmt):
    """Reads tiled at several pull sizes give one long read's samples: the
    trailing stages re-read their lookback, the resampler its frame."""
    _, t_src = pair(fmt, n=4000, sr=160 * 300)
    _, t = stages(kind, t_src, t_src)
    full, valid = t.read_at(0, t.length, CPU)
    assert valid == t.length
    for chunk in (64, 257, 1000):
        tiles = []
        for off in range(0, t.length, chunk):
            y, v = t.read_at(off, chunk, CPU)
            assert v == min(chunk, t.length - off)
            tiles.append(y[:v])
        tol = dict(rtol=1e-6, atol=1e-6 * SCALE[fmt]) if kind.startswith("resample") else tolerance(kind, fmt)
        np.testing.assert_allclose(np.concatenate(tiles), full, **tol)


@pytest.mark.parametrize("window", [7, 300, 2000])
@pytest.mark.parametrize("fmt", FORMATS)
def test_dcblock_holds_its_formula(fmt, window):
    """DcBlock against the f64 formula over the decoded samples, within
    3e-5 of the output's scale at every format: its prefix sums run about
    each block's mean.  (The JAX package's run over the samples
    themselves: at cu8 with window 7 it lies 1.8e-2 of the scale off.)"""
    _, t_src = pair(fmt, n=3000)
    planes = planes_from_bytes(np.asarray(t_src._bytes), FileFormat(fmt))
    x = decode_plane(planes[0], FileFormat(fmt)).astype(np.float64) + 1j * decode_plane(planes[1], FileFormat(fmt))
    cs = np.concatenate([[0], np.cumsum(x)])
    m = np.arange(len(x))
    want = x - (cs[m + 1] - cs[np.maximum(m + 1 - window, 0)]) / np.minimum(m + 1, window)
    got, valid = tstream.DcBlock(t_src, window).read_at(0, len(x), CPU)
    assert valid == len(x)
    np.testing.assert_allclose(got, want, rtol=0, atol=3e-5 * np.abs(want).max())


@pytest.mark.parametrize("fmt", FORMATS)
def test_iq_coefficient(fmt):
    """The blind estimate (host f64 about the mean): bitwise on cf32, within
    1e-6 relative on the integer formats."""
    j_src, t_src = pair(fmt, n=3000, seed=5)
    j, t = jstream.IqCorrect(j_src, est_samples=2500), tstream.IqCorrect(t_src, est_samples=2500, device=CPU)
    if fmt == "cf32":
        assert t.c == j.c
    else:
        assert abs(t.c - j.c) <= 1e-6 * abs(j.c)
    explicit = tstream.IqCorrect(t_src, c=0.02 + 0.01j, device=CPU)
    assert explicit.c == jstream.IqCorrect(j_src, c=0.02 + 0.01j).c


def test_stage_errors_match_jax():
    raw = capture_bytes("cf32", 100, 1)
    j_src, t_src = jsources.SampleSource(raw, JFormat.COMPLEX_FLOAT32, 48_000), tsources.SampleSource(
        raw, FileFormat.COMPLEX_FLOAT32, 48_000)
    real = np.ascontiguousarray(np.random.default_rng(9).normal(size=512).astype(np.complex64)).view(np.uint8)
    const = np.ascontiguousarray(np.ones(512, dtype=np.complex64)).view(np.uint8)
    cases = [
        (lambda m, s: m.Agc(s, target=0.0), None), (lambda m, s: m.Agc(s, max_gain=-1.0), None),
        (lambda m, s: m.DcBlock(s, 0), None), (lambda m, s: m.Agc(s, window=0), None),
        (lambda m, s: m.Resample(s, 0, 2), None), (lambda m, s: m.Resample(s, 1, -1), None),
        (lambda m, s: m.Resample(s, 1, 7), None), (lambda m, s: m.Resample(s, 1, 2, size=512), None),
        (lambda m, s: m.Resample(s, 1, 2, size=1), None),
        (lambda m, s: m.IqCorrect(s, **({} if m is jstream else {"device": CPU})), real),
        (lambda m, s: m.IqCorrect(s, **({} if m is jstream else {"device": CPU})), const),
        (lambda m, s: m.IqCorrect(s, est_samples=1, **({} if m is jstream else {"device": CPU})), None),
    ]
    for make, data in cases:
        if data is not None:
            j_src = jsources.SampleSource(data, JFormat.COMPLEX_FLOAT32, 1000)
            t_src = tsources.SampleSource(data, FileFormat.COMPLEX_FLOAT32, 1000)
        with pytest.raises(ValueError) as want:
            make(jstream, j_src)
        with pytest.raises(ValueError) as got:
            make(tstream, t_src)
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("size,up,down", [(48, 3, 2), (33, 1, 2), (40, 2, 3), (80, 7, 3), (2560, 147, 160),
                                          (14000, 64, 875), (7, 5, 4)])
def test_resample_tables_bitwise(size, up, down):
    want = jresample.resample_tables(size, up, down)
    got = tresample.resample_tables(size, up, down)
    assert got[0].dtype == want[0].dtype == np.float32
    assert got[0].tobytes() == want[0].tobytes()
    assert got[1:3] == want[1:3]
    assert got[3].dtype == want[3].dtype and np.array_equal(got[3], want[3])
    # every phase class is a window of L columns of one matrix
    cols = tresample.phase_columns(size, up, down)
    for w in range(up):
        assert np.array_equal(cols[:, w : w + up], want[0][w])


@pytest.mark.parametrize("rate,target", [(656_250, 48_000), (48_000, 32_000), (44_100, 48_000), (8_000, 8_000)])
def test_resample_real_matches_jax(rate, target):
    rng = np.random.default_rng(rate % 997)
    n = 30_000 if rate == 656_250 else 5_000
    audio = (np.sin(np.arange(n) * 0.01) + 0.1 * rng.normal(size=n)).astype(np.float32)
    j_rate, want = jresample.resample_real(audio, rate, target)
    t_rate, got = tresample.resample_real(torch.from_numpy(audio), rate, target)
    assert t_rate == j_rate == target
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-6, atol=2e-6 * np.abs(want).max())
    with pytest.raises(ValueError, match="shorter than the resampling filter"):
        tresample.resample_real(torch.zeros(100), 656_250, 48_000)
    with pytest.raises(ValueError, match="rates must be positive"):
        tresample.resample_real(torch.zeros(100), 0, 48_000)


def run(main, argv, capsys) -> tuple[int, str, str]:
    rc = main(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


@pytest.fixture
def cpu(monkeypatch, tmp_path):
    monkeypatch.setenv("QUADRS_PLATFORM", "cpu")
    monkeypatch.chdir(tmp_path)
    return tmp_path


@pytest.mark.parametrize("fmt", ["cs8", "cu8"])
def test_cli_stage_chains_match_jax(fmt, cpu, capsys):
    """``iqbal dcblock agc resample 147/160 write`` and ``shift lowpass
    dcblock agc sparkfft`` through both CLIs: the same lines, files of the
    same name and length within 1e-5 of their maximum."""
    (cpu / f"cap.sr48k.{fmt}").write_bytes(capture_bytes(fmt, 40_000, 3).tobytes())
    cap = f"cap.sr48k.{fmt}"
    for tag, main in (("j", jcli.main), ("t", tcli.main)):
        argv = ["from", cap, "iqbal", "-est", "10k", "dcblock", "-window", "2k", "agc", "-window", "300",
                "resample", "147/160", "write", tag]
        assert run(main, argv, capsys) == (0, "", "")
    got = np.fromfile(cpu / "t.sr44100.cf32", np.complex64)
    want = np.fromfile(cpu / "j.sr44100.cf32", np.complex64)
    assert got.shape == want.shape and len(got) > 30_000
    # cu8: the JAX package's dcblock prefix sums of the -127 baseline round
    # at ~2e-4 of the levelled signal
    np.testing.assert_allclose(got, want, rtol=0, atol=(1e-5 if fmt == "cs8" else 5e-4) * np.abs(want).max())
    argv = ["from", cap, "shift", "5k", "lowpass", "-power", "20", "-decimate", "4", "6k", "dcblock", "-window", "500",
            "agc", "sparkfft", "-width", "32", "-stride", "16"]
    j_out, t_out = run(jcli.main, argv, capsys), run(tcli.main, argv, capsys)
    assert t_out == j_out and j_out[0] == 0 and j_out[1].count("\n") > 500
