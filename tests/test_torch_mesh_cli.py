"""The commands that take ``-mesh`` in the port, end to end under
``QUADRS_PLATFORM=cpu`` (whose default mesh is the CPU 8 times over):
``stream -mesh 4x1`` (with ``-search``, ``-scan`` and ``-trigger``),
``stream -stdin yes -mesh 4x1`` fed by ``replay``, ``waterfall -mesh 2x2``,
``scan -mesh 2x1`` and ``2x2``, ``from CAP find -pattern T -mesh 2`` and
``channelize -mesh 2``, each against the port's single-device run and
against ``quadjax`` on the same argv (its mesh on the 8 virtual CPU
devices); case for case with ``tests/test_cli_serve.py``,
``tests/test_scan.py``, ``tests/test_find.py`` and
``tests/test_channelizer.py``.  The receivers' and the daemon's ``-mesh``
are held in ``tests/test_torch_demod_mesh.py`` and
``tests/test_torch_serve.py``.

Against the single-device run: peak bins, survey counts, ``find`` offsets
and burst spans exact, stream norms within ``1e-5`` of scale (the
shards' phase tiles start at other samples), waterfall norms and channel
files bit for bit.  Against ``quadjax``: the parity bounds of the
single-device tests."""

import io
import os
import pathlib
import re
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from quadrs_tpu import cli as jcli  # noqa: E402

from quadrs_tpu_torch import cli as tcli  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
SR = 48_000
STREAM_FLAGS = ["-shift", "1k", "-lowpass", "8k", "-power", "20", "-decimate", "4", "-width", "32"]


def run(main, argv, capsys) -> tuple[int, str, str]:
    rc = main(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


@pytest.fixture
def cpu(monkeypatch, tmp_path):
    monkeypatch.setenv("QUADRS_PLATFORM", "cpu")
    monkeypatch.chdir(tmp_path)
    return tmp_path


def tones(path: pathlib.Path, n: int, seed: int, fmt: str = "cf32") -> str:
    """Two tones, a burst and seeded noise."""
    rng = np.random.default_rng(seed)
    m = np.arange(n)
    x = 0.2 * np.exp(2j * np.pi * ((2_000 * m) % SR) / SR) + 0.1 * np.exp(-2j * np.pi * ((5_000 * m) % SR) / SR)
    x += 0.5 * np.exp(-(((m - n // 3) / 800.0) ** 2)) * np.exp(2j * np.pi * ((-1_500 * m) % SR) / SR)
    x += 0.05 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    if fmt == "cf32":
        raw = np.stack([x.real, x.imag], axis=1).astype("<f4")
    else:
        raw = np.clip(np.rint(np.stack([x.real, x.imag], axis=1) * 120), -127, 127).astype(np.int8)
    path.write_bytes(raw.tobytes())
    return str(path)


def norms_of(prefix) -> np.ndarray:
    return np.fromfile(f"{prefix}.norms.f32", dtype=np.float32)


def stats(out: str, cmd: str) -> tuple[int, int]:
    m = re.search(rf"^{cmd}: (\d+) samples, (\d+) windows, ", out, re.M)
    assert m, out
    return int(m[1]), int(m[2])


def three(argv_mesh, argv_single, capsys) -> dict[str, tuple[str, str]]:
    """The port with the mesh, quadjax with the mesh, the port without."""
    outs = {}
    for tag, main, argv in (("mesh", tcli.main, argv_mesh), ("jax", jcli.main, argv_mesh),
                            ("single", tcli.main, argv_single)):
        rc, out, err = run(main, [a.replace("{tag}", tag) for a in argv], capsys)
        assert rc == 0, (tag, err)
        outs[tag] = out.replace(tag, "{tag}")
    return outs


def test_cli_stream_mesh_matches_single(cpu, capsys):
    """``stream -mesh 4x1``: the norms file of the single-device run and
    of quadjax's mesh run, the peak line and the counts."""
    cap = tones(cpu / "cap.sr48000.cf32", 40_000, 1)
    base = ["stream", *STREAM_FLAGS, "-chunk", "2048", "-out", "{tag}"]
    outs = three([*base, "-mesh", "4x1", cap], [*base, cap], capsys)
    got, single, want = norms_of("mesh"), norms_of("single"), norms_of("jax")
    assert got.shape == single.shape == want.shape and got.size > 0
    np.testing.assert_allclose(got, single, rtol=0, atol=1e-5 * single.max())
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-5 * want.max())
    peak = [ln for ln in outs["mesh"].splitlines() if ln.startswith("stream peak")]
    assert peak and peak == [ln for ln in outs["single"].splitlines() if ln.startswith("stream peak")]
    assert stats(outs["mesh"], "stream") == stats(outs["single"], "stream") == stats(outs["jax"], "stream")


def test_cli_stream_mesh_search_and_trigger(cpu, capsys):
    """``stream -search yes -mesh 4x1``: the peaks CSV's windows and bins
    the single-device run's; ``-trigger -mesh``: the same burst files,
    byte for byte, as the single-device run and quadjax."""
    cap = tones(cpu / "cap.sr48000.cf32", 40_000, 2)
    base = ["stream", *STREAM_FLAGS, "-chunk", "2048"]
    three([*base, "-search", "yes", "-out", "{tag}", "-mesh", "4x1", cap],
          [*base, "-search", "yes", "-out", "{tag}", cap], capsys)
    got, single, want = (np.loadtxt(f"{t}.peaks.csv", delimiter=",", skiprows=1) for t in ("mesh", "single", "jax"))
    assert got.shape == single.shape == want.shape
    np.testing.assert_array_equal(got[:, :2], single[:, :2])
    np.testing.assert_allclose(got[:, 2], single[:, 2], rtol=1e-5)
    np.testing.assert_allclose(got[:, 2], want[:, 2], rtol=0, atol=5e-5 * want[:, 2].max())
    outs = three([*base, "-trigger", "0.3", "-pre", "1", "-post", "1", "-out", "b{tag}", "-mesh", "4x1", cap],
                 [*base, "-trigger", "0.3", "-pre", "1", "-post", "1", "-out", "b{tag}", cap], capsys)
    spans = {t: re.findall(r"^stream burst \d+: windows (\d+)\.\.(\d+)", o, re.M) for t, o in outs.items()}
    assert spans["mesh"] == spans["single"] == spans["jax"] and spans["mesh"]
    for t in ("single", "jax"):
        for a, b in zip(sorted(cpu.glob("bmesh.b*")), sorted(cpu.glob(f"b{t}.b*"))):
            assert a.name.replace("bmesh", "") == b.name.replace(f"b{t}", "") and a.read_bytes() == b.read_bytes()


def test_cli_stream_scan_mesh(cpu, capsys):
    """``stream -scan yes -mesh 4x1``: the survey CSV's counts the
    single-device run's, averages and maxima within 1e-5."""
    cap = tones(cpu / "cap.sr48000.cf32", 40_000, 3)
    base = ["stream", *STREAM_FLAGS, "-chunk", "6000", "-scan", "yes", "-threshold", "0.5", "-out", "{tag}"]
    three([*base, "-mesh", "4x1", cap], [*base, cap], capsys)
    rows = {t: np.loadtxt(f"{t}.scan.csv", delimiter=",", skiprows=1) for t in ("mesh", "single", "jax")}
    np.testing.assert_array_equal(rows["mesh"][:, [0, 1, 4]], rows["single"][:, [0, 1, 4]])
    np.testing.assert_allclose(rows["mesh"][:, 2:4], rows["single"][:, 2:4], rtol=1e-5)
    np.testing.assert_allclose(rows["mesh"][:, 2:4], rows["jax"][:, 2:4], rtol=1e-4)
    assert np.abs(rows["mesh"][:, 4] - rows["jax"][:, 4]).max() <= 1


def test_cli_stream_stdin_mesh_fed_by_replay(cpu, capsys, monkeypatch):
    """``replay -speed 0 CAP | stream -stdin yes -mesh 4x1``: the norms file
    of the file run on the same mesh, byte for byte, and its counts."""
    cap = tones(cpu / "cap.sr48k.cs8", 60_011, 4, fmt="cs8")
    env = {**os.environ, "QUADRS_PLATFORM": "cpu", "PYTHONPATH": str(ROOT)}
    piped = subprocess.run([sys.executable, "-m", "quadrs_tpu_torch", "replay", "-speed", "0", cap],
                           capture_output=True, env=env, timeout=120, check=True).stdout
    assert piped == pathlib.Path(cap).read_bytes()
    base = ["stream", *STREAM_FLAGS, "-chunk", "16k", "-mesh", "4x1"]
    rc, file_out, err = run(tcli.main, [*base, "-out", "file", cap], capsys)
    assert rc == 0, err
    monkeypatch.setattr(sys, "stdin", SimpleNamespace(buffer=io.BytesIO(piped)))
    rc, pipe_out, err = run(tcli.main, [*base, "-out", "pipe", "-stdin", "yes", "-sr", "48k", "-format", "cs8"], capsys)
    assert rc == 0, err
    assert norms_of("pipe").tobytes() == norms_of("file").tobytes() and norms_of("file").size > 0
    assert stats(pipe_out, "stream") == stats(file_out, "stream")
    monkeypatch.setattr(sys, "stdin", SimpleNamespace(buffer=io.BytesIO(piped)))
    rc, jax_out, err = run(jcli.main, [*base, "-out", "jax", "-stdin", "yes", "-sr", "48k", "-format", "cs8"], capsys)
    assert rc == 0, err
    np.testing.assert_allclose(norms_of("pipe"), norms_of("jax"), rtol=0, atol=5e-5 * norms_of("jax").max())


def test_cli_waterfall_mesh_bank(cpu, capsys):
    """``waterfall -mesh 2x2`` over a two-file bank: each stream's norms
    file the single-device bank's, bit for bit, and quadjax's mesh run's
    within the bank's tolerance; the peak lines too."""
    a = tones(cpu / "a.sr48000.cf32", 20_000, 5)
    b = tones(cpu / "b.sr48000.cf32", 20_000, 6)
    base = ["waterfall", "-width", "256", "-stride", "128", "-chunk", "8", "-out", "{tag}"]
    outs = three([*base, "-mesh", "2x2", a, b], [*base, a, b], capsys)
    for s in range(2):
        got, single, want = (np.fromfile(f"{t}.s{s}.norms.f32", dtype=np.float32) for t in ("mesh", "single", "jax"))
        assert got.size > 0 and got.tobytes() == single.tobytes()
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5 * want.max())
    lines = {t: [ln for ln in o.splitlines() if " peak " in ln] for t, o in outs.items()}
    assert lines["mesh"] == lines["single"] and len(lines["mesh"]) == 2
    assert stats(outs["mesh"], "waterfall") == stats(outs["single"], "waterfall") == stats(outs["jax"], "waterfall")


@pytest.mark.parametrize("mesh,files", [("2x1", 1), ("2x2", 2)])
def test_cli_scan_mesh_matches_single(mesh, files, cpu, capsys):
    """``scan -mesh``: every stream's survey CSV the single-device run's
    (bins and counts exact, sums within f32 order) and quadjax's."""
    caps = [tones(cpu / f"t{s}.sr48000.cf32", 30_000, 7 + s) for s in range(files)]
    base = ["scan", "-width", "256", "-stride", "128", "-chunk", "8", "-threshold", "10", "-out", "{tag}"]
    three([*base, "-mesh", mesh, *caps], [*base, *caps], capsys)
    for s in range(files):
        rows = {t: np.loadtxt(f"{t}.s{s}.scan.csv", delimiter=",", skiprows=1) for t in ("mesh", "single", "jax")}
        assert rows["mesh"].shape == (256, 6)
        for other in ("single", "jax"):
            np.testing.assert_array_equal(rows["mesh"][:, [0, 1, 4]], rows[other][:, [0, 1, 4]])
            np.testing.assert_allclose(rows["mesh"][:, 2:4], rows[other][:, 2:4], rtol=1e-5)


def test_cli_find_mesh_matches_single(cpu, capsys):
    """``from CAP find -pattern T -mesh 2``: the single-device run's match
    lines (offsets and freqs exact, scores within 2e-4) and quadjax's."""
    rng = np.random.default_rng(47)
    n, l = 30_000, 400
    p = 0.5 * (rng.standard_normal(l) + 1j * rng.standard_normal(l))
    x = 0.01 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    for o in (1_234, 14_000, n - l):
        x[o : o + l] += p
    cap, pat = cpu / "cap.sr48k.cf32", cpu / "pat.sr48k.cf32"
    cap.write_bytes(np.stack([x.real, x.imag], axis=1).astype("<f4").tobytes())
    pat.write_bytes(np.stack([p.real, p.imag], axis=1).astype("<f4").tobytes())
    argv = ["from", str(cap), "find", "-pattern", str(pat), "-threshold", "0.8"]
    outs = three([*argv, "-mesh", "2"], argv, capsys)
    for other in ("single", "jax"):
        got, want = outs["mesh"].splitlines(), outs[other].splitlines()
        assert len(got) == len(want) == 4 and got[-1] == want[-1]
        for g, w in zip(got[:-1], want[:-1]):
            (go, gs, ga, gf), (wo, ws, wa, wf) = g.split(","), w.split(",")
            assert (go, gf) == (wo, wf) and abs(float(gs) - float(ws)) <= 2e-4 + 5e-5
            assert abs(float(ga) - float(wa)) <= 2e-4 * max(1.0, abs(float(wa)))
    assert [int(ln.split(",")[0]) for ln in outs["mesh"].splitlines()[:-1]] == [1_234, 14_000, n - l]


def test_cli_channelize_mesh_matches_single(cpu, capsys):
    """``channelize -mesh 2``: every channel file the single-device run's
    byte for byte (each shard pulls the full chunk) and quadjax's within
    2e-6 of scale; the meter lines equal."""
    cap = tones(cpu / "band.sr48k.cs8", 50_000, 9, fmt="cs8")
    base = ["channelize", "-channels", "8", "-chunk", "512", "-out", "{tag}"]
    outs = three([*base, "-mesh", "2", cap], [*base, cap], capsys)
    assert outs["mesh"].splitlines()[:-1] == outs["single"].splitlines()[:-1] == outs["jax"].splitlines()[:-1]
    for ch in range(8):
        got = (cpu / f"mesh.ch{ch}.sr6000.cf32").read_bytes()
        assert got == (cpu / f"single.ch{ch}.sr6000.cf32").read_bytes()
        want = np.frombuffer((cpu / f"jax.ch{ch}.sr6000.cf32").read_bytes(), dtype="<f4")
        np.testing.assert_allclose(np.frombuffer(got, dtype="<f4"), want, rtol=0, atol=2e-6 * np.abs(want).max())


@pytest.mark.parametrize("argv", [
    ["stream", "-mesh", "16", "CAP"], ["waterfall", "-mesh", "4x4", "CAP"], ["scan", "-mesh", "0x1", "CAP"],
    ["stream", "-mesh", "2x2", "CAP"], ["waterfall", "-mesh", "1x2", "CAP"],
])
def test_cli_mesh_errors_match_jax(argv, cpu, capsys):
    """A mesh larger than the devices, a zero axis, a stream axis the
    sources do not fill: exit 1 with quadjax's message."""
    cap = tones(cpu / "cap.sr48000.cf32", 20_000, 10)
    argv = [cap if a == "CAP" else a for a in argv]
    (t_rc, t_out, t_err), (j_rc, j_out, j_err) = run(tcli.main, argv, capsys), run(jcli.main, argv, capsys)
    assert t_rc == j_rc == 1 and t_err == j_err, (t_err, j_err)
