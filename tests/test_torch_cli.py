"""The ported ``stream`` command end to end: ``quadrs_tpu.cli.main`` and
``quadrs_tpu_torch.cli.main`` (``QUADRS_PLATFORM=cpu``) over the same
captures, compared file by file and line by line; the device rule (no
silent CPU); the flags not ported yet, and ``-stdin`` and ``-trigger``,
which are; and the port's freedom from jax.

Norms agree to ``5e-5 * scale``; peak bins are exact wherever the top
two magnitudes differ by more than that."""

import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from quadrs_tpu import cli as jcli  # noqa: E402

from quadrs_tpu_torch import cli as tcli  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
TOL = 5e-5
SR = 21_000_000


def write_capture(path: pathlib.Path, fmt: str, n: int, seed: int) -> None:
    """Seeded noise plus a tone at -230 kHz (``-shift 280k`` brings it to
    +50 kHz) whose amplitude peaks in one window, so the global peak is
    clear."""
    rng = np.random.default_rng(seed)
    m = np.arange(n)
    ph = 2 * np.pi * ((m * -230_000) % SR) / SR
    amp = 10 + 50 * np.exp(-(((m - n // 3) / 3000.0) ** 2))
    iq = np.stack([amp * np.cos(ph), amp * np.sin(ph)]) + rng.integers(-20, 21, (2, n))
    if fmt == "cs8":
        codes = np.clip(np.rint(iq), -127, 127).astype(np.int8)
    else:  # cu8: codes centred on 127.5
        codes = np.clip(np.rint(iq + 127.5), 0, 255).astype(np.uint8)
    path.write_bytes(codes.T.tobytes())


def run(main, argv, capsys) -> tuple[int, str, str]:
    rc = main(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


def peak_line(out: str) -> tuple[int, int, float]:
    m = re.search(r"^stream peak window=(\d+) bin=(\d+) mag=(\S+)$", out, re.M)
    assert m, out
    return int(m[1]), int(m[2]), float(m[3])


def stats_counts(out: str) -> tuple[int, int]:
    m = re.search(r"^stream: (\d+) samples, (\d+) windows, \S+s, \S+ Msps$", out, re.M)
    assert m, out
    return int(m[1]), int(m[2])


# (file, format, samples, extra flags): one chunk of cs8; three chunks of
# cu8 whose last one's lookahead crosses EOF (zero-padded, masked)
CAPTURES = [
    ("cap.sr21M.cs8", "cs8", 200_000, []),
    ("cap.sr21M.cu8", "cu8", 2 * 63_488 + 14 * 2048 + 300, ["-chunk", "64k"]),
]


@pytest.mark.parametrize("name,fmt,n,flags", CAPTURES, ids=["cs8", "cu8-ragged"])
def test_stream_matches_jax(name, fmt, n, flags, tmp_path, capsys, monkeypatch):
    monkeypatch.setenv("QUADRS_PLATFORM", "cpu")
    path = tmp_path / name
    write_capture(path, fmt, n, seed=len(name) + n)
    base = ["stream", "-shift", "280k", *flags]

    outs = {}
    for tag, main in (("jax", jcli.main), ("torch", tcli.main)):
        rc, out, err = run(main, [*base, "-out", str(tmp_path / tag), str(path)], capsys)
        assert rc == 0, err
        rc, sout, err = run(main, [*base, "-search", "yes", "-out", str(tmp_path / tag), str(path)], capsys)
        assert rc == 0, err
        outs[tag] = (out, sout)
        assert f"wrote {tmp_path / tag}.norms.f32" in out
        assert f"wrote {tmp_path / tag}.peaks.csv" in sout

    want = np.fromfile(tmp_path / "jax.norms.f32", dtype=np.float32).reshape(-1, 64)
    got = np.fromfile(tmp_path / "torch.norms.f32", dtype=np.float32).reshape(-1, 64)
    assert got.shape == want.shape and want.shape[0] > 50
    tol = TOL * want.max()
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)

    jp = np.loadtxt(tmp_path / "jax.peaks.csv", delimiter=",", skiprows=1)
    tp = np.loadtxt(tmp_path / "torch.peaks.csv", delimiter=",", skiprows=1)
    assert tp.shape == jp.shape
    np.testing.assert_array_equal(tp[:, 0], jp[:, 0])
    top2 = np.sort(want, axis=1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > tol
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(tp[clear, 1], jp[clear, 1])
    np.testing.assert_allclose(tp[:, 2], jp[:, 2], rtol=0, atol=tol)

    flat = np.sort(want.ravel())
    assert flat[-1] - flat[-2] > tol  # the global peak is clear
    for j, t in zip(outs["jax"], outs["torch"]):
        (jw, jb, jm), (tw, tb, tm) = peak_line(j), peak_line(t)
        assert (tw, tb) == (jw, jb)
        assert abs(tm - jm) <= tol + 1e-5 * abs(jm)  # printed to 6 digits
        assert stats_counts(t) == stats_counts(j)


def test_cuda_is_required_unless_cpu_is_asked(tmp_path, capsys, monkeypatch):
    """With QUADRS_PLATFORM unset the port runs on CUDA or fails: on a host
    without a card it exits 1 with the CUDA error, never silently on the
    CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card: the unset default runs there")
    path = tmp_path / "cap.sr21M.cs8"
    write_capture(path, "cs8", 50_000, seed=1)
    monkeypatch.delenv("QUADRS_PLATFORM", raising=False)
    rc, out, err = run(tcli.main, ["stream", str(path)], capsys)
    assert rc == 1 and "CUDA is not available" in err and "stream:" not in out
    monkeypatch.setenv("QUADRS_PLATFORM", "cuda")
    assert run(tcli.main, ["stream", str(path)], capsys)[0] == 1
    monkeypatch.setenv("QUADRS_PLATFORM", "tpu")
    rc, _, err = run(tcli.main, ["stream", str(path)], capsys)
    assert rc == 1 and "QUADRS_PLATFORM" in err


@pytest.mark.parametrize(
    "flags,what",
    [
        (["-mesh", "2"], "-mesh"),
        (["-mesh", "1x1", "-scan", "yes"], "-mesh"),
        (["-trigger", "0.5", "-out", "burst"], "-trigger"),
        (["-stdin", "yes", "-sr", "21M", "-format", "cs8"], "-stdin"),
    ],
)
def test_flags_not_yet_ported(flags, what, tmp_path, capsys, monkeypatch):
    """``-mesh`` still waits for its slice.  ``-stdin`` and ``-trigger``
    are ported: the pipe run prints the file run's lines (timing apart),
    and the burst recorder writes slices of the capture under ``-out``."""
    monkeypatch.setenv("QUADRS_PLATFORM", "cpu")
    monkeypatch.chdir(tmp_path)
    path = tmp_path / "cap.sr21M.cs8"
    write_capture(path, "cs8", 50_000, seed=2)
    if what == "-stdin":
        import io
        from types import SimpleNamespace

        monkeypatch.setattr(sys, "stdin", SimpleNamespace(buffer=io.BytesIO(path.read_bytes())))
        rc, out, err = run(tcli.main, ["stream", "-shift", "280k", *flags], capsys)
        assert rc == 0, err
        rc, file_out, err = run(tcli.main, ["stream", "-shift", "280k", str(path)], capsys)
        assert rc == 0, err
        assert out.splitlines()[0] == file_out.splitlines()[0] and out.startswith("stream peak window=")
        assert stats_counts(out) == stats_counts(file_out) == (49_152, 24)
        return
    if what == "-trigger":
        rc, out, err = run(tcli.main, ["stream", "-shift", "280k", *flags, str(path)], capsys)
        assert rc == 0, err
        bursts = sorted(tmp_path.glob("burst.b*.sr21000000.cs8"))
        assert len(bursts) >= 1 and f"stream trigger: {len(bursts)} bursts over 24 windows, level 0.5" in out
        data = path.read_bytes()
        for k, b in enumerate(bursts):
            s0 = int(b.name.split(".s")[1].split(".")[0])
            assert b.name.startswith(f"burst.b{k}.s") and b.read_bytes() == data[2 * s0 : 2 * s0 + b.stat().st_size]
        return
    argv = ["stream", *flags, str(path)]
    rc, out, err = run(tcli.main, argv, capsys)
    assert rc == 1
    assert f"stream {what}" in err and "not yet ported" in err and "ROADMAP" in err
    assert "stream:" not in out


def test_parse_errors_match_jax(capsys):
    for argv in (["stream"], ["stream", "-power", "-3", "x"], ["stream", "-search", "yes", "-scan", "yes", "f"],
                 ["stream", "-shift", "1k", "-shift", "2k", "f"], ["stream", "-bogus", "1", "f"]):
        j_rc, _, j_err = run(jcli.main, argv, capsys)
        t_rc, _, t_err = run(tcli.main, argv, capsys)
        assert (t_rc, t_err) == (j_rc, j_err)
    rc, out, err = run(tcli.main, ["sparkfft", "f"], capsys)
    assert rc == 1 and "unrecognised command" in err and "usage:" in out


def test_package_imports_no_jax():
    """Every module of the port imports without jax or quadrs_tpu."""
    code = (
        "import pkgutil, importlib, sys\n"
        "import quadrs_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, 'quadrs_tpu_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'quadrs_tpu'))\n"
        "assert len(names) >= 15, names\n"
        "assert not bad, bad\n"
        "print('ok', len(names))\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")


def test_module_entry_point():
    res = subprocess.run(
        [sys.executable, "-m", "quadrs_tpu_torch"], cwd=ROOT, capture_output=True, text=True, timeout=300
    )
    assert res.returncode == 1
    assert "usage: python -m quadrs_tpu_torch" in res.stdout and "no commands provided" in res.stderr
