"""``info`` and ``replay`` in the port against quadrs_tpu's on the CPU.

``capture_info``'s fields agree with the JAX package's at ``rtol 1e-5``
(both reduce each chunk in f32 and recombine in f64; the orders of the f32
sums differ); the DC offset, a sum that cancels, to ``1e-6 * rms``; the
clipped fraction, an integer count, exactly.  Both decode about the
format's neutral value with the decode's offset and the neutral folded into
one constant (XLA folds the JAX package's two subtractions): the cs16
decode's own ``- 32767.5`` would round every sample to f32's 2^-8 grid.
``info`` prints the JAX
package's lines, numbers compared at ``1e-4``, everything else byte for
byte, the timing line apart.  ``replay`` writes the file's own
bytes.  Inputs are made with numpy from a seed, or are the bundled
``examples/``."""

import io
import pathlib
import re
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from quadrs_tpu import cli as jcli  # noqa: E402
from quadrs_tpu.formats import FileFormat as JFormat  # noqa: E402
from quadrs_tpu.sinks import capture_info as jcapture_info  # noqa: E402
from quadrs_tpu.sources import SampleSource as JSource  # noqa: E402

from quadrs_tpu_torch import args as targs  # noqa: E402
from quadrs_tpu_torch import cli as tcli  # noqa: E402
from quadrs_tpu_torch import sinks as tsinks  # noqa: E402
from quadrs_tpu_torch.formats import FileFormat  # noqa: E402
from quadrs_tpu_torch.serve import run_replay  # noqa: E402
from quadrs_tpu_torch.sinks import capture_info  # noqa: E402
from quadrs_tpu_torch.sources import SampleSource  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
EXAMPLES = ROOT / "examples"
OOK = EXAMPLES / "ook-sim.sr400.cf32"
CPU = torch.device("cpu")


def cf32(z, sr=48_000):
    return np.ascontiguousarray(z.astype(np.complex64)).view(np.uint8), FileFormat.COMPLEX_FLOAT32, sr


def both(buf, fmt, sr, **kw):
    return capture_info(SampleSource(buf, fmt, sr), device=CPU, **kw), jcapture_info(JSource(buf, JFormat(fmt.value), sr), **kw)


def assert_info_close(got, want, rtol=1e-5):
    assert (got.format.value, got.sample_rate, got.samples, got.bytes, got.seconds, got.analyzed) == \
        (want.format.value, want.sample_rate, want.samples, want.bytes, want.seconds, want.analyzed)
    assert got.clipped == want.clipped  # an integer count over 2n
    np.testing.assert_allclose(got.rms, want.rms, rtol=rtol)
    np.testing.assert_allclose(got.peak, want.peak, rtol=rtol)
    assert abs(got.dc - want.dc) <= 0.1 * rtol * want.rms + rtol * abs(want.dc)
    assert abs(got.rho - want.rho) <= rtol + rtol * abs(want.rho)


def seeded(fmt: FileFormat, n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if fmt is FileFormat.COMPLEX_FLOAT32:
        z = 0.3 * (rng.normal(size=n) + 1j * rng.normal(size=n)) + (0.1 - 0.05j)
        z = z + 0.2 * np.conj(z)  # an IQ image
        return cf32(z)[0]
    info = np.iinfo(fmt.raw_dtype)
    mid = (info.max + info.min + 1) // 2
    codes = np.clip(np.rint(mid + rng.normal(scale=(info.max - info.min) / 5, size=2 * n)), info.min, info.max)
    return codes.astype(fmt.raw_dtype).view(np.uint8)  # sigma of a fifth of the range: some samples clip


@pytest.mark.parametrize("chunk,limit", [(1 << 22, None), (1777, None), (1000, 4321)], ids=["one-chunk", "ragged-chunks", "limit"])
@pytest.mark.parametrize("fmt", [f.value for f in FileFormat])
def test_capture_info_matches_jax(fmt, chunk, limit):
    fmt = FileFormat(fmt)
    buf = seeded(fmt, 5003, seed=len(fmt.value) + chunk)
    got, want = both(buf, fmt, 48_000, chunk=chunk, limit=limit)
    assert got.analyzed == (limit or 5003)
    assert_info_close(got, want)
    if fmt is not FileFormat.COMPLEX_FLOAT32:
        assert 0 < got.clipped < 0.2
    assert abs(got.rho) > 0.01 or fmt is not FileFormat.COMPLEX_FLOAT32


def test_stats_match_numpy_cf32():
    rng = np.random.default_rng(2)
    z = 0.3 * (rng.normal(size=5000) + 1j * rng.normal(size=5000)) + (0.1 - 0.05j)
    i, j = both(*cf32(z), chunk=1777)  # several chunks and a ragged tail
    assert_info_close(i, j)
    assert i.samples == 5000 and i.analyzed == 5000 and i.bytes == 5000 * 8 and i.clipped is None
    assert abs(i.dc - z.mean()) < 1e-4
    assert abs(i.rms - np.sqrt(np.mean(np.abs(z) ** 2))) < 1e-4
    assert abs(i.peak - np.abs(z).max()) < 1e-5
    zc = z - z.mean()
    assert abs(i.rho - np.sum(zc * zc) / np.sum(np.abs(zc) ** 2)) < 1e-3
    with pytest.raises(ValueError, match="chunk must be"):
        capture_info(SampleSource(*cf32(z)), chunk=0, device=CPU)


def test_rho_flags_an_iq_image_not_a_dc_offset():
    rng = np.random.default_rng(4)
    s = (rng.normal(size=8000) + 1j * rng.normal(size=8000)) * np.exp(2j * np.pi * 0.13 * np.arange(8000))
    clean, jclean = both(*cf32(s + 3.0))  # a large DC offset alone is no image
    assert abs(clean.rho) < 0.05
    dirty, jdirty = both(*cf32(s + 0.08 * np.conj(s) + 3.0))
    assert abs(dirty.rho) / 2.0 > 0.05
    assert_info_close(clean, jclean)
    assert_info_close(dirty, jdirty)


def test_cu8_neutral_and_clipping():
    buf = np.full(2000, 127, dtype=np.uint8)
    buf[1::2] = 128  # mid codes decode near the cu8 neutral (-127 - 127j): dc about it reads near zero
    i, j = both(buf, FileFormat.COMPLEX_UINT8, 1000)
    assert abs(i.dc) < 0.01 and i.clipped == 0.0 and i.rho == j.rho == 0
    buf2 = buf.copy()
    buf2[:100] = 255
    buf2[100:150] = 0
    i2, j2 = both(buf2, FileFormat.COMPLEX_UINT8, 1000)
    assert i2.clipped == j2.clipped == pytest.approx(150 / 2000)
    assert_info_close(i2, j2)


def test_cs16_neutral_is_decode_of_code_zero():
    raw = np.zeros(4000, dtype="<i2")
    raw[0::2] = 100  # +100 codes on re only
    i, j = both(raw.view(np.uint8), FileFormat.COMPLEX_INT16, 1000)
    assert abs(i.dc - (100 / 65535.0)) < 1e-6 and i.clipped == 0.0
    assert i.rho == j.rho == 0  # a constant capture has no AC power: no image reported
    rails = np.array([-32768, 32767, 0, 0], dtype="<i2")
    i2, j2 = both(rails.view(np.uint8), FileFormat.COMPLEX_INT16, 1000)
    assert i2.clipped == j2.clipped == pytest.approx(0.5)


def test_cs8_limit_and_rails():
    raw = np.zeros(400, dtype=np.int8)
    raw[:4] = 127
    raw[4:8] = -128
    i, j = both(raw.view(np.uint8), FileFormat.COMPLEX_INT8, 1000, limit=100)
    assert i.analyzed == 100 and i.samples == 200
    assert i.clipped == j.clipped == pytest.approx(8 / 200)  # over the analyzed half
    full, _ = both(raw.view(np.uint8), FileFormat.COMPLEX_INT8, 1000)
    assert full.clipped == pytest.approx(8 / 400)


NUMBER = re.compile(r"[-+]?\d+\.?\d*(?:e[-+]?\d+)?")


def assert_lines_close(got: str, want: str, rel: float):
    """The same text around the same numbers; each number within ``rel``
    of its counterpart, or within 2 units of its last printed digit."""
    assert NUMBER.sub("#", got) == NUMBER.sub("#", want)
    for g, w in zip(NUMBER.findall(got), NUMBER.findall(want)):
        if g != w:
            digits = len(w.split("e")[0].split(".")[1]) if "." in w.split("e")[0] else 0
            unit = 10.0 ** (-digits) * 10.0 ** int(w.split("e")[1]) if "e" in w else 10.0 ** (-digits)
            assert abs(float(g) - float(w)) <= max(rel * abs(float(w)), 2 * unit), (g, w)


def run(main, argv, capsys):
    rc = main(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


def test_cli_info_matches_jax_on_the_examples(capsys, monkeypatch):
    monkeypatch.setenv("QUADRS_PLATFORM", "cpu")
    files = sorted(str(p) for p in EXAMPLES.glob("*.cf32"))
    assert len(files) >= 2
    for argv in (["info", *files], ["info", "-limit", "1000", "-chunk", "300", files[0]]):
        rc, out, err = run(tcli.main, argv, capsys)
        jrc, jout, _ = run(jcli.main, argv, capsys)
        assert rc == jrc == 0, err
        lines, jlines = out.splitlines(), jout.splitlines()
        assert len(lines) == len(jlines) == 3 * (len(argv) - 1 if len(argv) == 3 else 1) + 1
        for ln, jln in zip(lines[:-1], jlines[:-1]):
            assert_lines_close(ln, jln, rel=1e-4)
        assert lines[-1].rsplit(" samples, ", 1)[0] == jlines[-1].rsplit(" samples, ", 1)[0]
    assert "stats over the first 1000" in out


def test_cli_info_on_a_generated_capture(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("QUADRS_PLATFORM", "cpu")
    monkeypatch.chdir(tmp_path)
    assert tcli.main("gen -cos 0 -cos 700 -len 0.1 12k write t".split()) == 0
    rc, out, _ = run(tcli.main, "info t.sr12000.cf32 t.sr12000.cf32".split(), capsys)
    assert rc == 0
    assert out.count("cf32, 12000 Hz, 4096 samples") == 2  # the writer's 0x1000-sample pulls never come short
    assert "|dc|/rms -3.0 dB" in out  # the cos-0 tone: unit DC against an rms of sqrt(2)
    assert "clipped: n/a" in out and "info: 2 files, 8192 samples" in out
    for argv in (["info"], "info -limit 0 t.sr12000.cf32".split(), "info -bogus 1 t.sr12000.cf32".split()):
        t, j = run(tcli.main, argv, capsys), run(jcli.main, argv, capsys)
        assert t[0] == j[0] == 1 and t[2] == j[2]


# -- replay --------------------------------------------------------------------------


class BinStdout:
    def __init__(self):
        self.buffer = io.BytesIO()

    def write(self, s):  # stats go to stderr, never here
        raise AssertionError("replay must not write text to stdout")

    def flush(self):
        pass


def replay(monkeypatch, **kw) -> bytes:
    fake = BinStdout()
    with monkeypatch.context() as m:
        m.setattr(sys, "stdout", fake)
        rc = run_replay(targs.ReplayCmd(filename=str(OOK), **kw), CPU)
    assert rc == 0
    return fake.buffer.getvalue()


@pytest.mark.parametrize("kw,times", [(dict(speed=0.0), 1), (dict(speed=0.0, loop=3, chunk=777), 3)], ids=["once", "loop"])
def test_replay_writes_the_files_own_bytes(kw, times, monkeypatch, capsys):
    assert replay(monkeypatch, **kw) == OOK.read_bytes() * times
    assert re.fullmatch(r"replay: %d samples, \S+s, \S+ Msps\n" % (1344 * times), capsys.readouterr().err)


def test_replay_pacing_takes_real_time(monkeypatch):
    t0 = time.perf_counter()
    got = replay(monkeypatch, speed=10.0, chunk=100)  # 3.36 s of capture at 10x
    dt = time.perf_counter() - t0
    assert got == OOK.read_bytes()
    assert dt >= 0.5 * (len(got) // 8 / 400.0 / 10.0)


def test_replay_grammar_matches_jax(capsys):
    from quadrs_tpu import args as jargs

    cmd = targs.parse("replay -speed 2.5 -loop 4 x.sr1M.cu8".split())[0]
    jcmd = jargs.parse("replay -speed 2.5 -loop 4 x.sr1M.cu8".split())[0]
    assert isinstance(cmd, targs.ReplayCmd) and vars(cmd) == vars(jcmd)
    assert vars(targs.parse("info -limit 2k -chunk 1M a b".split())[0]) == vars(jargs.parse("info -limit 2k -chunk 1M a b".split())[0])
    for bad in ("replay", "replay -speed -1 x.cf32", "replay -loop 0 x.cf32", "replay -chunk 0 x.cf32"):
        t, j = run(tcli.main, bad.split(), capsys), run(jcli.main, bad.split(), capsys)
        assert t[0] == j[0] == 1 and t[2] == j[2]


def test_replay_pipes_into_a_stdin_consumer(tmp_path):
    """The advertised one-liner, two real processes and a real pipe:
    ``replay -speed 0 FILE | stream -stdin yes`` gives the file run's
    norms bit for bit, and a consumer that stops early (``-chunks 1``)
    leaves the producer to end quietly on its broken pipe."""
    env = {"QUADRS_PLATFORM": "cpu", "PATH": "/usr/local/bin:/usr/bin:/bin"}
    cap = tmp_path / "cap.sr48k.cs8"
    cap.write_bytes(np.random.default_rng(5).integers(0, 256, 2 * 300_000, dtype=np.int64).astype(np.uint8).tobytes())
    flags = ["-shift", "1k", "-lowpass", "8k", "-power", "20", "-decimate", "4", "-width", "32", "-chunk", "8000"]
    me = [sys.executable, "-m", "quadrs_tpu_torch"]
    direct = subprocess.run([*me, "stream", *flags, "-out", str(tmp_path / "f"), str(cap)],
                            capture_output=True, text=True, env=env, cwd=ROOT, timeout=600)
    assert direct.returncode == 0, direct.stderr
    for tag, extra in (("p", []), ("b", ["-chunks", "1"])):
        producer = subprocess.Popen([*me, "replay", "-speed", "0", str(cap)], stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, env=env, cwd=ROOT)
        piped = subprocess.run([*me, "stream", *flags, *extra, "-stdin", "yes", "-sr", "48k", "-format", "cs8",
                                "-out", str(tmp_path / tag)],
                               stdin=producer.stdout, capture_output=True, text=True, env=env, cwd=ROOT, timeout=600)
        producer.stdout.close()
        err = producer.stderr.read().decode()
        assert producer.wait(timeout=60) == 0, err
        assert piped.returncode == 0, piped.stderr
        assert err.startswith("replay: ") and "Traceback" not in err
    want = (tmp_path / "f.norms.f32").read_bytes()
    assert (tmp_path / "p.norms.f32").read_bytes() == want
    assert piped.stdout.splitlines()[-1].startswith("stream: 7936 samples, 62 windows")
    assert (tmp_path / "b.norms.f32").read_bytes() == want[: 62 * 32 * 4]


def test_glyph_lines_equal_the_row_by_row_form():
    """The vectorized rows are the list-of-``str`` form's, byte for byte,
    at values on, just under and just over every level boundary, at NaN and
    at both infinities, for the default and an inverted range; and the JAX
    package's rows."""
    from quadrs_tpu.sinks import glyph_rows as jglyph_rows

    def loop_rows(norms, lo, hi):
        distinction = np.float32((np.float32(hi) - np.float32(lo)) / np.float32(7.0))
        rows = []
        for row in norms:
            s = ""
            for v in row:
                mid = (v - np.float32(lo)) / distinction
                level = 1 + (min(max(int(mid), 0), 6) if np.isfinite(mid) else 0)
                if v < np.float32(lo):
                    level = 0
                if v >= np.float32(hi):  # wins over the blank where a range is inverted
                    level = 8
                s += tsinks.SPARK_GLYPHS[level]
            rows.append(s)
        return rows

    for lo, hi in ((0.08, 1.0), (0.001, 0.01), (0.5, 0.5), (1.0, 0.08)):
        lo32, hi32 = np.float32(lo), np.float32(hi)
        edges = lo32 + (hi32 - lo32) / np.float32(7.0) * np.arange(8, dtype=np.float32)
        vals = np.concatenate([[np.nextafter(e, np.float32(-np.inf)), e, np.nextafter(e, np.float32(np.inf))] for e in edges])
        vals = np.concatenate([vals, [np.nan, np.inf, -np.inf, 0.0, -1.0, 1e30, 3e38, lo32, hi32]]).astype(np.float32)
        norms = np.stack([vals, vals[::-1], np.roll(vals, 5)])
        with np.errstate(all="ignore"):
            want = loop_rows(norms, lo, hi)
            jrows = list(jglyph_rows(norms, lo, hi))
        assert tsinks.glyph_rows(norms, lo, hi) == want == jrows
        assert tsinks.glyph_lines(norms, lo, hi).encode() == "\n".join(f"│{r}│" for r in want).encode()
        assert tsinks.glyph_rows(norms[0], lo, hi) == want[:1]  # one row, given flat
    assert tsinks.glyph_rows(np.zeros((0, 8), np.float32), 0.08, 1.0) == []
    assert tsinks.glyph_lines(np.zeros((0, 8), np.float32), 0.08, 1.0) == ""
