"""The receiver commands through the CLI: the same argv through
``quadrs_tpu.cli.main`` and ``quadrs_tpu_torch.cli.main``
(``QUADRS_PLATFORM=cpu``) prints the same stdout, the throughput field
(``R Msps``) aside; audio files agree within ``1e-5`` of full scale, WAV
headers byte for byte; ``-out -`` writes the audio bytes and nothing else to
stdout; ``-stdin yes`` buffers the pipe (up to its cap) and gives the file
run's output; ``-mesh T`` prints the single-device run's lines and
quadjax's (``tests/test_torch_demod_mesh.py`` holds the sharded front end
itself); parse errors are the JAX package's.  Captures are made with numpy from a
seed."""

import io
import pathlib
import re
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from quadrs_tpu import cli as jcli  # noqa: E402

from quadrs_tpu_torch import cli as tcli  # noqa: E402
from quadrs_tpu_torch import serve as tserve  # noqa: E402

EXAMPLES = pathlib.Path(__file__).resolve().parent.parent / "examples"
OOK = str(EXAMPLES / "ook-sim.sr400.cf32")
FSK = str(EXAMPLES / "fsk-sim.sr48k.cf32")
SR = 96_000


def run(main, argv, capsys) -> tuple[int, str, str]:
    rc = main(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


def no_rate(text: str) -> str:
    return re.sub(r"[0-9.]+ Msps", "R Msps", text)


@pytest.fixture
def cpu(monkeypatch, tmp_path):
    monkeypatch.setenv("QUADRS_PLATFORM", "cpu")
    monkeypatch.chdir(tmp_path)
    return tmp_path


def write_capture(path: pathlib.Path, kind: str, n: int = 48_000, seed: int = 2) -> str:
    """A cs8 capture at ``SR``: ``fm`` a 1 kHz tone at 3 kHz deviation on a
    carrier at +12 kHz; ``am`` a 500 Hz tone at depth 0.4 on a carrier at
    -10 kHz; ``ssb`` a tone 800 Hz above a suppressed carrier at +15 kHz."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / SR
    x = {
        "fm": lambda: 0.7 * np.exp(1j * (2 * np.pi * 12_000 * t + 3 * np.sin(2 * np.pi * 1000 * t))),
        "am": lambda: 0.5 * (1 + 0.4 * np.cos(2 * np.pi * 500 * t)) * np.exp(-2j * np.pi * 10_000 * t),
        "ssb": lambda: 0.6 * np.exp(2j * np.pi * 15_800 * t),
    }[kind]() + 0.01 * (rng.normal(size=n) + 1j * rng.normal(size=n))
    iq = np.stack([x.real, x.imag], axis=-1) * 127
    name = path / f"{kind}.sr96k.cs8"
    np.clip(np.rint(iq), -127, 127).astype(np.int8).tofile(name)
    return str(name)


AUDIO_ARGV = {
    "fm": ["fm", "-shift", "-12k", "-lowpass", "8k", "-power", "32", "-decimate", "4", "-deviation", "3k"],
    "am": ["am", "-shift", "10k", "-lowpass", "3k", "-power", "64", "-decimate", "8"],
    "ssb": ["ssb", "-shift", "-15k", "-bandwidth", "2k", "-power", "64", "-decimate", "8"],
}
AUDIO_TAILS = [[], ["-audio-rate", "8000"], ["-audio-decimate", "2", "-audio-lowpass", "2k", "-audio-power", "16"]]


@pytest.mark.parametrize(
    "argv",
    [
        ["ook", "-bit", "16", OOK],
        ["ook", "-bit", "16", "-raw", "yes", OOK],
        ["ook", "-width", "8", "-stride", "4", "-threshold", "0.002", "-bit", "8", OOK],
        ["fsk", "-lowpass", "8k", "-power", "10", "-decimate", "4", "-stride", "600", FSK],
        ["fsk", "-shift", "-6k", "-lowpass", "8k", "-power", "20", "-decimate", "4", "-width", "32", FSK],
        ["fsk", "-lowpass", "8k", "-power", "10", "-decimate", "4", "-stride", "150", "-bit", "4", FSK],
    ],
    ids=["ook", "ook-raw", "ook-wide", "fsk", "fsk-shifted", "fsk-bits"],
)
def test_bit_receivers_match_jax(argv, cpu, capsys):
    j_rc, j_out, j_err = run(jcli.main, argv, capsys)
    t_rc, t_out, t_err = run(tcli.main, argv, capsys)
    assert (t_rc, t_err) == (j_rc, j_err) == (0, "")
    assert t_out == j_out and t_out.count("\n") == 2


@pytest.mark.parametrize("tail", AUDIO_TAILS, ids=["plain", "resample", "audio-fir"])
@pytest.mark.parametrize("kind", ["fm", "am", "ssb"])
def test_audio_receivers_match_jax(kind, tail, cpu, capsys):
    """The meter line (stdout), and the ``-out`` f32 file within 1e-5 of
    full scale."""
    cap = write_capture(cpu, kind)
    lines = {}
    for tag, main in (("j", jcli.main), ("t", tcli.main)):
        rc, out, err = run(main, AUDIO_ARGV[kind] + tail + [cap], capsys)
        assert (rc, err) == (0, "")
        rc, written, err = run(main, AUDIO_ARGV[kind] + tail + ["-out", tag, cap], capsys)
        assert (rc, err) == (0, "")
        lines[tag] = (out, written)
    (j_out, j_written), (t_out, t_written) = lines["j"], lines["t"]
    assert no_rate(t_out) == no_rate(j_out) and t_out.startswith(f"{kind}: ")
    assert no_rate(t_written) == no_rate(j_written).replace("j.sr", "t.sr")
    rate = re.search(r"@ (\d+) Hz", t_out).group(1)
    got = np.fromfile(cpu / f"t.sr{rate}.f32", dtype="<f4")
    want = np.fromfile(cpu / f"j.sr{rate}.f32", dtype="<f4")
    assert got.shape == want.shape and len(got) > 100
    assert float(np.abs(got - want).max()) <= 1e-5


def test_wav_and_overwrite(cpu, capsys):
    cap = write_capture(cpu, "fm")
    argv = AUDIO_ARGV["fm"] + ["-audio-rate", "8000", "-wav", "yes"]
    for tag, main in (("j", jcli.main), ("t", tcli.main)):
        rc, out, err = run(main, argv + ["-out", tag, cap], capsys)
        assert rc == 0 and out.startswith(f"{tag}.wav\nfm: ")
    got, want = (cpu / "t.wav").read_bytes(), (cpu / "j.wav").read_bytes()
    assert len(got) == len(want) and got[:56] == want[:56]  # RIFF, fmt, fact and data headers
    assert np.abs(np.frombuffer(got[56:], "<f4") - np.frombuffer(want[56:], "<f4")).max() <= 1e-5
    rc, _, err = run(tcli.main, argv + ["-out", "t", cap], capsys)
    assert rc == 1 and "File exists" in err  # no clobber
    assert run(tcli.main, argv + ["-out", "t", "-overwrite", "yes", cap], capsys)[0] == 0


class BinaryStdout:
    """A stdout whose ``buffer`` collects bytes (the audio) apart from text."""

    def __init__(self):
        self.buffer = io.BytesIO()
        self.text = io.StringIO()

    def write(self, s):
        return self.text.write(s)

    def flush(self):
        pass


@pytest.mark.parametrize("wav", ["no", "yes"])
@pytest.mark.parametrize("kind", ["fm", "ssb"])
def test_out_dash_streams_audio_bytes_only(kind, wav, cpu, capsys, monkeypatch):
    """``-out -``: stdout holds the audio bytes (f32, or the WAV) and no
    text; the meter line goes to stderr."""
    cap = write_capture(cpu, kind)
    argv = AUDIO_ARGV[kind] + ["-wav", wav, "-out", "-", cap]
    got = {}
    for tag, main in (("j", jcli.main), ("t", tcli.main)):
        out = BinaryStdout()
        with monkeypatch.context() as m:
            m.setattr(sys, "stdout", out)
            rc = main(argv)
        err = capsys.readouterr().err
        assert rc == 0 and out.text.getvalue() == "" and err.startswith(f"{kind}: ")
        got[tag] = (out.buffer.getvalue(), no_rate(err))
    (t_bytes, t_err), (j_bytes, j_err) = got["t"], got["j"]
    assert t_err == j_err and len(t_bytes) == len(j_bytes) > 400
    head = 56 if wav == "yes" else 0
    assert t_bytes[:head] == j_bytes[:head]
    assert np.abs(np.frombuffer(t_bytes[head:], "<f4") - np.frombuffer(j_bytes[head:], "<f4")).max() <= 1e-5


def feed_stdin(monkeypatch, data: bytes) -> None:
    monkeypatch.setattr(sys, "stdin", SimpleNamespace(buffer=io.BytesIO(data)))


@pytest.mark.parametrize("kind", ["ook", "fsk", "fm"])
def test_stdin_buffers_the_pipe_and_equals_the_file_run(kind, cpu, capsys, monkeypatch):
    if kind == "ook":
        path, argv, sr, fmt = OOK, ["ook", "-bit", "16"], "400", "cf32"
    elif kind == "fsk":
        path, argv, sr, fmt = FSK, ["fsk", "-lowpass", "8k", "-power", "10", "-decimate", "4", "-stride", "600"], "48k", "cf32"
    else:
        path, argv, sr, fmt = write_capture(cpu, "fm"), AUDIO_ARGV["fm"] + ["-audio-rate", "8k"], "96k", "cs8"
    rc, file_out, err = run(tcli.main, argv + [path], capsys)
    assert (rc, err) == (0, "")
    feed_stdin(monkeypatch, pathlib.Path(path).read_bytes())
    rc, pipe_out, err = run(tcli.main, argv + ["-stdin", "yes", "-sr", sr, "-format", fmt], capsys)
    assert (rc, err) == (0, "") and no_rate(pipe_out) == no_rate(file_out)
    if kind == "fm":  # the audio, bit for bit
        for tag, extra in (("file", [path]), ("pipe", ["-stdin", "yes", "-sr", sr, "-format", fmt])):
            feed_stdin(monkeypatch, pathlib.Path(path).read_bytes())
            assert run(tcli.main, argv + ["-out", tag] + extra, capsys)[0] == 0
        assert (cpu / "file.sr8000.f32").read_bytes() == (cpu / "pipe.sr8000.f32").read_bytes()


def test_stdin_cap(cpu, capsys, monkeypatch):
    monkeypatch.setattr(tserve, "_STDIN_BUFFER_CAP", 1000)
    feed_stdin(monkeypatch, bytes(1001))
    rc, out, err = run(tcli.main, ["ook", "-stdin", "yes", "-sr", "400", "-format", "cf32"], capsys)
    assert rc == 1 and "exceeds the demod buffer cap (1 GiB)" in err and out == ""
    argv = ["ook", "-stdin", "yes", "-sr", "400", "-format", "cf32"]
    feed_stdin(monkeypatch, bytes(1000))  # at the cap: buffered (all zeros)
    rc, out, err = run(tcli.main, argv, capsys)
    feed_stdin(monkeypatch, bytes(1000))
    assert (rc, err) == (0, "") and (rc, out, err) == run(jcli.main, argv, capsys)


MESH_ARGV = {
    "ook": ["ook", "-bit", "16"],
    "fsk": ["fsk", "-lowpass", "8k", "-power", "10", "-decimate", "4", "-stride", "600"],
    **AUDIO_ARGV,
}


@pytest.mark.parametrize("cmd", ["ook", "fsk", "fm", "am", "ssb"])
def test_mesh_refused(cmd, cpu, capsys):
    """A receiver's ``-mesh 2x2`` is refused with quadjax's text (one
    capture shards over time only); ``-mesh 2`` runs, time-sharding the
    front end over the CPU repeated, and prints the single-device run's
    lines and quadjax's (the throughput aside).  The audio captures run 12.5
    s, so that two of the front end's 65536-sample windows are full and the
    mesh dispatch engages."""
    path = {"ook": OOK, "fsk": FSK}.get(cmd) or write_capture(cpu, cmd, n=1_200_000)
    argv = MESH_ARGV[cmd]
    t_rc, _, t_err = run(tcli.main, [*argv, "-mesh", "2x2", path], capsys)
    j_rc, _, j_err = run(jcli.main, [*argv, "-mesh", "2x2", path], capsys)
    assert t_rc == j_rc == 1 and t_err == j_err == f"Error: processing command '{cmd}': {cmd} -mesh shards one capture: use T or Tx1\n"
    outs = []
    for main, mesh in ((tcli.main, ["-mesh", "2"]), (tcli.main, []), (jcli.main, ["-mesh", "2"])):
        rc, out, err = run(main, [*argv, *mesh, path], capsys)
        assert (rc, err) == (0, "")
        outs.append(no_rate(out))
    assert outs[0] == outs[1] == outs[2] and outs[0].startswith(f"{cmd}: ") == (cmd in AUDIO_ARGV)


def test_psk_refused_and_parse_errors_match_jax(cpu, capsys):
    """``psk -mesh 2`` runs as the single-device run does (here the burst
    is too slow for the symbol rate: the same error, exit 1, in both and in
    quadjax); the receivers' parse errors, ``-mesh 2x2`` and ``-mesh`` with
    ``-stdin`` among them, are quadjax's."""
    got = [run(main, ["psk", "-symbol-rate", "1k", *mesh, FSK], capsys)
           for main, mesh in ((tcli.main, ["-mesh", "2"]), (tcli.main, []), (jcli.main, ["-mesh", "2"]))]
    assert got[0][::2] == got[1][::2] == got[2][::2] == (1, "Error: 1.50 channel samples/symbol < 2: lower the "
                                                           "symbol rate or the decimation\n")
    for argv in (["ook"], ["fm", "-wav", "yes", FSK], ["ssb", "-sideband", "dsb", FSK], ["fm", "-deviation", "0", FSK],
                 ["am", "-stdin", "yes"], ["fsk", "-mesh", "2x2", FSK], ["ook", "-mesh", "2", "-stdin", "yes", "-sr", "1k",
                                                                        "-format", "cf32"], ["fm", "-bogus", "1", FSK],
                 ["ssb", "-out", "a", "-out", "b", FSK]):
        j_rc, _, j_err = run(jcli.main, argv, capsys)
        t_rc, _, t_err = run(tcli.main, argv, capsys)
        assert (t_rc, t_err) == (j_rc, j_err) and t_rc == 1, argv
