"""The channelizer (``channelize``, ``ops/channelizer.py``,
``models/channelizer.py``) against the JAX package and against the port's
own ``Shift -> LowPass`` chain.

Captures are made with numpy from a seed and decoded by both packages
from the same bytes.  Tolerances: the host tables bitwise; channel data
within ``2e-6 * scale`` (the JAX tests' own bound,
``tests/test_channelizer.py``): the JAX package's DFT over the K axis is a
matmul, the port's ``torch.fft.fft``, and the branch sums are f32 in both.
``scale`` is the largest output magnitude over every channel of the block:
the DFT mixes every branch, so a channel's rounding is relative to the
whole band (cu8's decode puts 127 of DC into channel 0 and ~1e-7 of it into
each other channel).  The CLI's RMS meter within 1e-5 of its value (it
prints 6 digits).
"""

import re

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from quadrs_tpu import cli as jcli  # noqa: E402
from quadrs_tpu.formats import FileFormat as JFormat  # noqa: E402
from quadrs_tpu.models.channelizer import Channelize as JChannelize  # noqa: E402
from quadrs_tpu.ops import channelizer as jops  # noqa: E402
from quadrs_tpu.sources import SampleSource as JSource  # noqa: E402

from quadrs_tpu_torch import cli as tcli  # noqa: E402
from quadrs_tpu_torch.formats import FileFormat  # noqa: E402
from quadrs_tpu_torch.models.channelizer import Channelize, run_channelize  # noqa: E402
from quadrs_tpu_torch.ops import channelizer as tops  # noqa: E402
from quadrs_tpu_torch.serve import channel_center  # noqa: E402
from quadrs_tpu_torch.sources import SampleSource  # noqa: E402
from quadrs_tpu_torch.stream import LowPass, Shift  # noqa: E402

CPU = torch.device("cpu")
FORMATS = ["cf32", "cs8", "cu8", "cs16"]


def capture_bytes(fmt: str, n: int, seed: int) -> np.ndarray:
    """``n`` samples of noise plus two tones, encoded as ``fmt``."""
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    x = 0.25 * (rng.standard_normal(n) + 1j * rng.standard_normal(n)) + 0.3 * np.exp(0.7j * t) + 0.2 * np.exp(-2.1j * t)
    iq = np.stack([x.real, x.imag], -1).reshape(-1)
    raw = {
        "cf32": lambda: iq.astype("<f4"),
        "cs8": lambda: np.clip(np.rint(iq * 100), -127, 127).astype(np.int8),
        "cu8": lambda: np.clip(np.rint(iq * 100 + 127.5), 0, 255).astype(np.uint8),
        "cs16": lambda: np.clip(np.rint(iq * 20_000), -32767, 32767).astype("<i2"),
    }[fmt]()
    return np.frombuffer(raw.tobytes(), dtype=np.uint8)


def sources(fmt: str, n: int, sr: int, seed: int = 0):
    raw = capture_bytes(fmt, n, seed)
    return SampleSource(raw, FileFormat(fmt), sr), JSource(raw, JFormat(fmt), sr)


@pytest.mark.parametrize("size,k", [(40, 8), (34, 6), (128, 16), (50, 7), (9, 4), (64, 5)])
def test_host_tables_bitwise(size, k):
    taps = np.random.default_rng(size + k).standard_normal(size).astype(np.float32)
    np.testing.assert_array_equal(tops._branch_taps(taps.tobytes(), k), jops._branch_taps(taps.tobytes(), k))
    for a, b in zip(tops._center_phase(size, k), jops._center_phase(size, k)):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("k,size", [(8, 40), (7, 50)])
def test_block_against_jax_and_the_chain(fmt, k, size):
    """Every channel of one read against JAX's, and against the port's own
    ``Shift(-ch*sr/K) -> LowPass(cutoff, decimate=K, size)`` (the channel
    at K/2 of an even K has no Shift: |f| = sr/2 is refused there)."""
    sr = 8_000 if k == 8 else 7_000
    src, jsrc = sources(fmt, 4096 + 13, sr, seed=k)
    chan, jchan = Channelize(src, k, size=size), JChannelize(jsrc, k, size=size)
    assert (chan.length, chan.sample_rate, chan.frequency) == (jchan.length, jchan.sample_rate, jchan.frequency)
    np.testing.assert_array_equal(chan.taps, jchan.taps)
    out, valid = chan.read_at(0, chan.length, CPU)
    want, j_valid = jchan.read_at(0, jchan.length)
    assert valid == j_valid == (src.length - size) // k and out.shape == want.shape and out.dtype == np.complex64
    scale = float(np.abs(want[:valid]).max())
    for ch in range(k):
        assert float(np.abs(out[:valid, ch] - want[:valid, ch]).max()) <= 2e-6 * scale, ch
        if 2 * ch == k:
            continue
        f = -channel_center(ch, sr, k)
        ref, v = LowPass(Shift(src, f, sr), chan.frequency, k, size).read_at(0, chan.length, CPU)
        assert v == valid
        assert float(np.abs(out[:v, ch] - ref[:v]).max()) <= 2e-6 * scale, ch


def test_tones_land_in_their_channels():
    """Tones at the centres of channels 3 and K-2 (bin order: -2 * sr/K)."""
    from quadrs_tpu_torch.sources import ToneGen

    k, sr = 16, 64_000
    gen = ToneGen([3 * sr // k, -2 * sr // k], sr, 0.25)
    out, valid = Channelize(gen, k, size=128).read_at(0, 512, CPU)
    power = np.mean(np.abs(out[: valid - 16]) ** 2, axis=0)
    for ch in range(k):
        if ch in (3, k - 2):
            assert power[ch] > 0.5, (ch, power)
        else:
            assert power[ch] < 1e-3 * power.max(), (ch, power)


@pytest.mark.parametrize("chunk", [128, 500, 4096])
def test_chunked_runs_against_jax_and_the_chain(chunk):
    """Pulls of ``chunk`` outputs truncate where the JAX package's and a
    chain pulled at the same size do (per-read truncation is semantics):
    every chunk against JAX's run and against the chain's read of it."""
    from quadrs_tpu.models.channelizer import run_channelize as j_run

    k, size, sr = 4, 40, 4_000
    src, jsrc = sources("cs8", 6000, sr, seed=5)
    chan = Channelize(src, k)
    got = list(run_channelize(chan, device=CPU, chunk=chunk))
    want = list(j_run(JChannelize(jsrc, k), chunk=chunk))
    assert [(p.start, p.data.shape) for p in got] == [(p.start, p.data.shape) for p in want]
    for p, q in zip(got, want):
        assert p.data.dtype == np.complex64 and p.data.flags.c_contiguous
        scale = max(float(np.abs(q.data).max()), 1e-3)
        assert float(np.abs(p.data - q.data).max()) <= 2e-6 * scale, p.start
    for ch in (1, 3):
        ref = LowPass(Shift(src, -channel_center(ch, sr, k), sr), chan.frequency, k, size)
        for p in got:
            want_row, v = ref.read_at(p.start, chunk, CPU)
            n = min(v, p.data.shape[1])
            scale = max(float(np.abs(p.data).max()), 1e-3)
            assert float(np.abs(p.data[ch, :n] - want_row[:n]).max()) <= 2e-6 * scale


@pytest.mark.parametrize("max_out,chunk", [(100, 64), (1, 64), (10_000, 300)])
def test_max_out(max_out, chunk):
    """``max_out`` bounds the outputs a channel; past the capture the last
    chunk is as short as JAX's (``length`` over-reports by one, as
    LowPass's does)."""
    from quadrs_tpu.models.channelizer import run_channelize as j_run

    src, jsrc = sources("cf32", 4096, 8_000)
    pieces = list(run_channelize(Channelize(src, 8), device=CPU, chunk=chunk, max_out=max_out))
    want = list(j_run(JChannelize(jsrc, 8), chunk=chunk, max_out=max_out))
    assert [(p.start, p.data.shape) for p in pieces] == [(p.start, p.data.shape) for p in want]
    assert sum(p.data.shape[1] for p in pieces) == min(max_out, (src.length - 40) // 8)


def test_validation_errors():
    src, _ = sources("cf32", 256, 8_000)
    with pytest.raises(ValueError, match="at least 2"):
        Channelize(src, 1)
    with pytest.raises(ValueError, match="cutoff"):
        Channelize(src, 8, frequency=0)
    with pytest.raises(ValueError, match="shorter than the filter"):
        Channelize(sources("cf32", 16, 8_000)[0], 8, size=40)


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


METER = re.compile(r"channel (\d+): center (-?\d+) Hz, rms ([^,]+)(.*)")


def assert_same_meter(t_out: str, j_out: str) -> None:
    """Meter lines equal but for the rms's last digits (within 1e-5) and the
    closing line's time and Msps."""
    t_lines, j_lines = t_out.splitlines(), j_out.splitlines()
    assert len(t_lines) == len(j_lines)
    for a, b in zip(t_lines[:-1], j_lines[:-1]):
        ma, mb = METER.fullmatch(a), METER.fullmatch(b)
        assert ma and mb and (ma[1], ma[2], ma[4]) == (mb[1], mb[2], mb[4])
        assert abs(float(ma[3]) - float(mb[3])) <= 1e-5 * float(mb[3])
    strip = r", [0-9.]+s, [0-9.]+ Msps$"
    assert re.sub(strip, "", t_lines[-1]) == re.sub(strip, "", j_lines[-1])


@pytest.mark.parametrize("fmt,k,extra", [("cf32", 4, ["-select", "0,3"]), ("cs8", 7, ["-select", "6,1,3", "-chunk", "1000"]),
                                         ("cu8", 8, ["-power", "30", "-freq", "3k"])])
def test_cli_files_and_meter_against_quadjax(fmt, k, extra, cpu, capsys):
    """``-out`` files within ``2e-6 * scale`` of ``quadjax``'s, the same
    names and lengths; the meter as :func:`assert_same_meter` says;
    unselected channels are not written."""
    cap = cpu / f"band.sr48k.{fmt}"
    capture_bytes(fmt, 9000, seed=k).tofile(cap)
    outs = {}
    for name, main in (("t", tcli.main), ("j", jcli.main)):
        rc, outs[name], err = run(main, ["channelize", "-channels", str(k), *extra, "-out", name, str(cap)], capsys)
        assert (rc, err) == (0, "")
    assert_same_meter(outs["t"].replace("wrote t.", "wrote ?."), outs["j"].replace("wrote j.", "wrote ?."))
    select = [int(c) for c in extra[1].split(",")] if extra[0] == "-select" else range(k)
    rate = 48_000 // k
    got, want = {}, {}
    for ch in range(k):
        t_path, j_path = cpu / f"t.ch{ch}.sr{rate}.cf32", cpu / f"j.ch{ch}.sr{rate}.cf32"
        assert t_path.exists() == j_path.exists() == (ch in select)
        if ch in select:
            got[ch], want[ch] = np.fromfile(t_path, "<c8"), np.fromfile(j_path, "<c8")
            assert got[ch].shape == want[ch].shape and len(got[ch]) > 1000
    # the band's scale: channel 0 of cu8 carries the decode's DC
    scale = float(np.abs(Channelize(SampleSource(capture_bytes(fmt, 9000, seed=k), FileFormat(fmt), 48_000), k,
                                    **({"size": 60, "frequency": 3000} if "-power" in extra else {}))
                         .read_at(0, 1200, CPU)[0]).max())
    for ch in got:
        assert float(np.abs(got[ch] - want[ch]).max()) <= 2e-6 * scale, ch


def test_cli_meter_and_overwrite(cpu, capsys):
    """No ``-out``: the meter alone, equal to ``quadjax``'s; an existing file
    is not clobbered without ``-overwrite yes``."""
    cap = cpu / "band.sr48k.cs16"
    capture_bytes("cs16", 20_000, seed=3).tofile(cap)
    argv = ["channelize", str(cap)]
    rc, t_out, err = run(tcli.main, argv, capsys)
    assert (rc, err) == (0, "") and "channelize: 8 channels @ 6000 Hz" in t_out
    assert_same_meter(t_out, run(jcli.main, argv, capsys)[1])
    assert [int(m[2]) for m in map(METER.fullmatch, t_out.splitlines()[:-1])] == \
        [0, 6000, 12000, 18000, -24000, -18000, -12000, -6000]
    argv = ["channelize", "-select", "2", "-out", "p", str(cap)]
    assert run(tcli.main, argv, capsys)[0] == 0
    rc, out, err = run(tcli.main, argv, capsys)
    assert rc == 1 and "File exists" in err
    assert run(tcli.main, argv[:1] + ["-overwrite", "yes"] + argv[1:], capsys)[0] == 0


def test_cli_stdin(cpu, capsys, monkeypatch):
    import io
    import sys
    from types import SimpleNamespace

    cap = cpu / "band.sr48k.cs8"
    capture_bytes("cs8", 9000, seed=1).tofile(cap)
    rc, file_out, err = run(tcli.main, ["channelize", "-channels", "4", str(cap)], capsys)
    assert rc == 0
    monkeypatch.setattr(sys, "stdin", SimpleNamespace(buffer=io.BytesIO(cap.read_bytes())))
    rc, out, err = run(tcli.main, ["channelize", "-channels", "4", "-stdin", "yes", "-sr", "48k", "-format", "cs8"], capsys)
    assert (rc, err) == (0, "")
    assert out.splitlines()[:-1] == file_out.splitlines()[:-1]


def test_cli_mesh_refused_and_parse_errors_match_jax(cpu, capsys):
    cap = cpu / "band.sr48k.cf32"
    capture_bytes("cf32", 2000, seed=1).tofile(cap)
    rc, out, err = run(tcli.main, ["channelize", "-mesh", "2", str(cap)], capsys)
    assert rc == 1 and "channelize -mesh" in err and "ROADMAP A13" in err and out == ""
    for argv in (["channelize", "-channels", "1", "cap.sr8k.cf32"], ["channelize", "-select", "9", "cap.sr8k.cf32"],
                 ["channelize", "-select", ",", "cap.sr8k.cf32"], ["channelize"], ["channelize", "-mesh", "2x2", "c.sr8k.cf32"],
                 ["channelize", "-mesh", "2", "-stdin", "yes", "-sr", "8k", "-format", "cf32"],
                 ["channelize", "-bogus", "1", "c.sr8k.cf32"], ["channelize", "-stdin", "yes"]):
        j_rc, _, j_err = run(jcli.main, argv, capsys)
        t_rc, _, t_err = run(tcli.main, argv, capsys)
        assert (t_rc, t_err) == (j_rc, j_err) and t_rc == 1, argv
    from quadrs_tpu_torch import args as targs

    (cmd,) = targs.parse("channelize -channels 16 -power 30 cap.sr8k.cf32".split())
    assert (cmd.channels, cmd.size, cmd.select, cmd.chunk) == (16, 60, None, 256_000)
    assert "channelize [-channels 8]" in tcli.USAGE
