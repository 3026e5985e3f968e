"""The ported ``waterfall``, ``waterfall -search``, ``scan`` and
``stream -scan`` commands end to end: ``quadrs_tpu.cli.main`` and
``quadrs_tpu_torch.cli.main`` (``QUADRS_PLATFORM=cpu``) over the same
captures, compared line by line and file by file; the flags not ported
yet, and ``-stdin``, which is; the parse errors.

Norms agree to ``rtol=2e-5, atol=2e-5·max`` (the JAX package's own
kernel tolerance); peak and CSV bins exactly, wherever a window's top two
magnitudes are further apart than that; survey averages and maxima to
``2e-5·max``, counts exactly."""

import re

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from quadrs_tpu import cli as jcli  # noqa: E402

from quadrs_tpu_torch import cli as tcli  # noqa: E402

RTOL = 2e-5
SR = 48_000


def write_bank(tmp_path, fmt: str, n: int, streams: int) -> list[str]:
    """Seeded noise plus one tone per stream (3 kHz + 1 kHz per stream)
    whose amplitude peaks in one stretch, so each stream's global peak is
    clear."""
    rng = np.random.default_rng(streams + n)
    paths = []
    m = np.arange(n)
    for s in range(streams):
        ph = 2 * np.pi * ((m * (3000 + 1000 * s)) % SR) / SR
        amp = 20 + 30 * np.exp(-(((m - n // (s + 2)) / 2000.0) ** 2))
        iq = np.stack([amp * np.cos(ph), amp * np.sin(ph)]) + rng.integers(-20, 21, (2, n))
        if fmt == "cs8":
            codes = np.clip(np.rint(iq), -127, 127).astype(np.int8)
        else:  # cu8: codes centred on 127.5
            codes = np.clip(np.rint(iq + 127.5), 0, 255).astype(np.uint8)
        path = tmp_path / f"bank{s}.sr48k.{fmt}"
        path.write_bytes(codes.T.tobytes())
        paths.append(str(path))
    return paths


def run(main, argv, capsys) -> tuple[int, str, str]:
    rc = main(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


def both(argv, tmp_path, capsys, monkeypatch) -> dict[str, str]:
    """Run ``argv`` (with ``-out <tag>`` inserted after the command) under
    both CLIs; returns each one's stdout."""
    monkeypatch.setenv("QUADRS_PLATFORM", "cpu")
    outs = {}
    for tag, main in (("jax", jcli.main), ("torch", tcli.main)):
        rc, out, err = run(main, [argv[0], "-out", str(tmp_path / tag), *argv[1:]], capsys)
        assert rc == 0, err
        outs[tag] = out.replace(str(tmp_path / tag), "P")
    return outs


def peaks(out: str, cmd: str) -> list[tuple[int, int, float]]:
    rows = re.findall(rf"^{cmd} peak(?: stream=\d+)? window=(\d+) bin=(\d+) mag=(\S+)$", out, re.M)
    assert rows, out
    return [(int(w), int(b), float(m)) for w, b, m in rows]


def stats_counts(out: str, cmd: str) -> tuple[int, int]:
    m = re.search(rf"^{cmd}: (\d+) samples, (\d+) windows, \S+s, \S+ Msps$", out, re.M)
    assert m, out
    return int(m[1]), int(m[2])


def clear_rows(norms: np.ndarray, tol: float) -> np.ndarray:
    top2 = np.sort(norms, axis=-1)[..., -2:]
    return top2[..., 1] - top2[..., 0] > tol


# (format, samples, streams, width, stride, chunk windows): several chunks
# with a ragged last one; an overlapped stride and one that is no
# 128-multiple
BANKS = [
    ("cs8", 40_000, 2, 256, 128, 100),
    ("cu8", 30_011, 3, 384, 96, 64),
]


@pytest.mark.parametrize("fmt,n,streams,width,stride,chunk", BANKS, ids=["cs8", "cu8"])
def test_waterfall_matches_jax(fmt, n, streams, width, stride, chunk, tmp_path, capsys, monkeypatch):
    files = write_bank(tmp_path, fmt, n, streams)
    flags = ["-width", str(width), "-stride", str(stride), "-chunk", str(chunk)]
    outs = both(["waterfall", *flags, *files], tmp_path, capsys, monkeypatch)
    want = np.stack([np.fromfile(tmp_path / f"jax.s{s}.norms.f32", np.float32) for s in range(streams)])
    got = np.stack([np.fromfile(tmp_path / f"torch.s{s}.norms.f32", np.float32) for s in range(streams)])
    want, got = want.reshape(streams, -1, width), got.reshape(streams, -1, width)
    assert got.shape == want.shape and want.shape[1] == (n - width) // stride + 1
    tol = RTOL * want.max()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=tol)
    for s, (jp, tp) in enumerate(zip(peaks(outs["jax"], "waterfall"), peaks(outs["torch"], "waterfall"))):
        flat = np.sort(want[s].ravel())
        if flat[-1] - flat[-2] > tol:  # a clear global peak (cu8's DC offset ties them)
            assert tp[:2] == jp[:2]
        assert abs(tp[2] - jp[2]) <= tol + 1e-5 * jp[2]
    assert stats_counts(outs["torch"], "waterfall") == stats_counts(outs["jax"], "waterfall")
    assert [ln for ln in outs["torch"].splitlines() if ln.startswith("wrote")] == [
        ln for ln in outs["jax"].splitlines() if ln.startswith("wrote")]

    outs = both(["waterfall", *flags, "-search", "yes", *files], tmp_path, capsys, monkeypatch)
    jp = np.loadtxt(tmp_path / "jax.peaks.csv", delimiter=",", skiprows=1)
    tp = np.loadtxt(tmp_path / "torch.peaks.csv", delimiter=",", skiprows=1)
    assert (tmp_path / "torch.peaks.csv").read_text().splitlines()[0] == "stream,window,bin,mag"
    assert tp.shape == jp.shape == (want.shape[0] * want.shape[1], 4)
    np.testing.assert_array_equal(tp[:, :2], jp[:, :2])
    clear = clear_rows(want, tol).reshape(-1)
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(tp[clear, 2], jp[clear, 2])
    np.testing.assert_allclose(tp[:, 3], jp[:, 3], rtol=RTOL)
    assert [p[:2] for p in peaks(outs["torch"], "waterfall")] == [p[:2] for p in peaks(outs["jax"], "waterfall")]
    assert stats_counts(outs["torch"], "waterfall") == stats_counts(outs["jax"], "waterfall")


def survey(out: str, name: str) -> list[list[tuple]]:
    """Each stream's printed table: (bin, freq, avg, max, occupancy%)."""
    tables = []
    for block in re.split(rf"^{name}(?: stream=\d+)?: (?=\d+ windows of)", out, flags=re.M)[1:]:
        rows = re.findall(r"^\s+(\d+)\s+(\S+)\s+(\S+)\s+(\S+)\s+(\S+)%$", block, re.M)
        tables.append([(int(b), float(f), float(a), float(m), float(o)) for b, f, a, m, o in rows])
    assert tables, out
    return tables


def assert_surveys_match(t_out, j_out, name, tol):
    tt, jt = survey(t_out, name), survey(j_out, name)
    assert len(tt) == len(jt)
    for t_rows, j_rows in zip(tt, jt):
        assert len(t_rows) == len(j_rows) > 0
        for t, j in zip(t_rows, j_rows):
            assert t[0] == j[0] and t[1] == j[1] and t[4] == j[4]
            assert abs(t[2] - j[2]) <= tol + 1e-5 * abs(j[2]) and abs(t[3] - j[3]) <= tol + 1e-5 * abs(j[3])
    head = [ln for ln in t_out.splitlines() if ln.startswith(name) and "windows of" in ln]
    assert head == [ln for ln in j_out.splitlines() if ln.startswith(name) and "windows of" in ln]


def assert_csvs_match(t_path, j_path, tol):
    t, j = (np.loadtxt(p, delimiter=",", skiprows=1) for p in (t_path, j_path))
    assert open(t_path).readline() == open(j_path).readline() == "bin,freq_hz,avg,max,above,occupancy\n"
    np.testing.assert_array_equal(t[:, [0, 1, 4, 5]], j[:, [0, 1, 4, 5]])
    np.testing.assert_allclose(t[:, 2:4], j[:, 2:4], rtol=RTOL, atol=tol)


def mid_gap_threshold(norms: np.ndarray) -> str:
    """A threshold in the widest gap between norms near the median, so
    that no norm sits within the tolerance of it."""
    flat = np.unique(norms.ravel())
    k = len(flat) // 2
    j = int(np.argmax(np.diff(flat[k - 200 : k + 200]))) + k - 200
    return repr(float((flat[j] + flat[j + 1]) / 2))


def test_scan_matches_jax(tmp_path, capsys, monkeypatch):
    files = write_bank(tmp_path, "cs8", 40_000, 2)
    flags = ["-width", "256", "-stride", "96", "-chunk", "150"]
    assert run(jcli.main, ["waterfall", *flags, "-out", str(tmp_path / "n"), *files], capsys)[0] == 0
    norms = np.stack([np.fromfile(tmp_path / f"n.s{s}.norms.f32", np.float32) for s in range(2)])
    flags += ["-threshold", mid_gap_threshold(norms), "-top", "6"]
    outs = both(["scan", *flags, *files], tmp_path, capsys, monkeypatch)
    tol = RTOL * norms.max()
    assert_surveys_match(outs["torch"], outs["jax"], "scan", tol)
    for s in range(2):
        assert_csvs_match(tmp_path / f"torch.s{s}.scan.csv", tmp_path / f"jax.s{s}.scan.csv", tol)
    assert stats_counts(outs["torch"], "scan") == stats_counts(outs["jax"], "scan")
    outs = both(["scan", *flags, "-db", "yes", "-overwrite", "yes", files[0]], tmp_path, capsys, monkeypatch)
    assert " dB " in outs["torch"] and "stream=" not in outs["torch"]
    assert_surveys_match(outs["torch"].replace(" dB", ""), outs["jax"].replace(" dB", ""), "scan", 0.01)
    # without -overwrite an existing table is kept, as quadjax keeps it
    rc, _, err = run(tcli.main, ["scan", "-out", str(tmp_path / "torch"), files[0]], capsys)
    assert rc == 1 and "exists" in err


def test_stream_scan_matches_jax(tmp_path, capsys, monkeypatch):
    path = write_bank(tmp_path, "cs8", 150_000, 1)[0]
    flags = ["-shift", "3k", "-lowpass", "5k", "-decimate", "4", "-chunk", "20k"]
    assert run(jcli.main, ["stream", *flags, "-out", str(tmp_path / "n"), path], capsys)[0] == 0
    norms = np.fromfile(tmp_path / "n.norms.f32", np.float32)
    argv = ["stream", "-scan", "yes", *flags, "-threshold", mid_gap_threshold(norms), "-top", "8", path]
    outs = both(argv, tmp_path, capsys, monkeypatch)
    tol = 5e-5 * norms.max()  # the stream chain's tolerance (tests/test_torch_cli.py)
    assert_surveys_match(outs["torch"], outs["jax"], "stream scan", tol)
    assert_csvs_match(tmp_path / "torch.scan.csv", tmp_path / "jax.scan.csv", tol)
    assert stats_counts(outs["torch"], "stream") == stats_counts(outs["jax"], "stream")
    assert "wrote P.scan.csv" in outs["torch"]


@pytest.mark.parametrize(
    "cmd,flags,what",
    [
        ("waterfall", ["-mesh", "2"], "-mesh"),
        ("waterfall", ["-stdin", "yes", "-sr", "48k", "-format", "cs8"], "-stdin"),
        ("scan", ["-mesh", "1x2"], "-mesh"),
        ("scan", ["-stdin", "yes", "-sr", "48k", "-format", "cs8"], "-stdin"),
        ("scan", ["-plot", "yes"], "-plot"),
    ],
)
def test_bank_flags_not_yet_ported(cmd, flags, what, tmp_path, capsys, monkeypatch):
    """``-mesh`` still waits for its slice; ``-stdin`` and ``scan -plot`` are
    ported: the pipe run prints the file run's lines (timing apart), the
    plot run writes ``scan.s0.png`` as quadjax does (its pixels are held by
    ``tests/test_torch_viz.py``)."""
    monkeypatch.setenv("QUADRS_PLATFORM", "cpu")
    files = write_bank(tmp_path, "cs8", 5_000, 1)
    if what == "-stdin":
        import io
        import sys
        from types import SimpleNamespace

        with open(files[0], "rb") as f:
            monkeypatch.setattr(sys, "stdin", SimpleNamespace(buffer=io.BytesIO(f.read())))
        rc, out, err = run(tcli.main, [cmd, *flags], capsys)
        assert rc == 0, err
        rc, file_out, err = run(tcli.main, [cmd, *files], capsys)
        assert rc == 0, err
        assert [ln.rsplit(" windows, ", 1)[0] for ln in out.splitlines()] == \
            [ln.rsplit(" windows, ", 1)[0] for ln in file_out.splitlines()]
        assert f"{cmd}: 4096 samples, 4 windows" in out
        return
    if what == "-plot":
        monkeypatch.chdir(tmp_path)
    rc, out, err = run(tcli.main, [cmd, *flags, *files], capsys)
    if what == "-plot":
        assert (rc, err) == (0, "") and "wrote scan.s0.png" in out
        assert (tmp_path / "scan.s0.png").exists()
        return
    assert rc == 1
    assert f"{cmd} {what}" in err and "not yet ported" in err and "ROADMAP" in err
    assert f"{cmd}:" not in out


def test_bank_parse_errors_match_jax(capsys):
    for argv in (["waterfall"], ["scan"], ["waterfall", "-window", "hann", "f"], ["scan", "-top", "x", "f"],
                 ["waterfall", "-stdin", "yes"], ["scan", "-stdin", "yes", "-sr", "1k", "-format", "cs8", "f"],
                 ["waterfall", "-width", "1k", "-width", "2k", "f"], ["scan", "-search", "yes", "f"]):
        j_rc, _, j_err = run(jcli.main, argv, capsys)
        t_rc, t_out, t_err = run(tcli.main, argv, capsys)
        assert (t_rc, t_err) == (j_rc, j_err) and t_rc == 1 and "usage:" in t_out


def test_bank_needs_cuda_unless_cpu_is_asked(tmp_path, capsys, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card: the unset default runs there")
    files = write_bank(tmp_path, "cs8", 5_000, 1)
    monkeypatch.delenv("QUADRS_PLATFORM", raising=False)
    for cmd in ("waterfall", "scan"):
        rc, out, err = run(tcli.main, [cmd, "-width", "256", *files], capsys)
        assert rc == 1 and "CUDA is not available" in err and f"{cmd}:" not in out
