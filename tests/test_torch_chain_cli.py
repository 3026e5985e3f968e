"""The reference command chain through the CLI: the same argv through
``quadrs_tpu.cli.main`` and ``quadrs_tpu_torch.cli.main``
(``QUADRS_PLATFORM=cpu``) prints the same stdout and writes files that
agree (cf32 within ``1e-5``, integer formats byte for byte); the
commands that are not ported yet (``ui``, ``eui``) parse and exit 1;
parse errors are the JAX package's."""

import pathlib

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from quadrs_tpu import cli as jcli  # noqa: E402

from quadrs_tpu_torch import cli as tcli  # noqa: E402

EXAMPLES = pathlib.Path(__file__).resolve().parent.parent / "examples"
OOK = str(EXAMPLES / "ook-sim.sr400.cf32")
FSK = str(EXAMPLES / "fsk-sim.sr48k.cf32")


def run(main, argv, capsys) -> tuple[int, str, str]:
    rc = main(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


@pytest.fixture
def cpu(monkeypatch, tmp_path):
    monkeypatch.setenv("QUADRS_PLATFORM", "cpu")
    monkeypatch.chdir(tmp_path)
    return tmp_path


@pytest.mark.parametrize(
    "argv",
    [
        # the verify skill's OOK flow, on the bundled example
        ["from", OOK, "sparkfft", "-width", "4", "-stride", "2", "-range", "0.001:0.01"],
        # an FSK flow: shift -> lowpass -> sparkfft, then a second sink
        ["from", FSK, "shift", "6k", "lowpass", "-power", "20", "-decimate", "4", "8k",
         "sparkfft", "-width", "64", "-stride", "32", "bucket", "-width", "64", "-by", "freq", "2"],
        ["from", "-sr", "24k", "-format", "cf32", FSK, "shift", "-500", "lowpass", "3k",
         "sparkfft", "-width", "16"],
    ],
    ids=["ook", "fsk-chain", "sr-override"],
)
def test_stdout_matches_jax(argv, cpu, capsys):
    j_rc, j_out, j_err = run(jcli.main, argv, capsys)
    t_rc, t_out, t_err = run(tcli.main, argv, capsys)
    assert (t_rc, t_err) == (j_rc, j_err) == (0, "")
    assert t_out == j_out and t_out.count("\n") > 50


def test_gen_write_then_from_bucket(cpu, capsys):
    """``gen -cos 1k 48k write P``, then ``from P.sr48000.cf32 bucket -by
    freq 2``, through each package; then the integer writer."""
    for tag, main in (("j", jcli.main), ("t", tcli.main)):
        assert run(main, ["gen", "-cos", "1k", "-cos", "-3k", "-noise", "0.1", "48k", "write", tag], capsys)[0] == 0
    got = np.fromfile(cpu / "t.sr48000.cf32", np.complex64)
    want = np.fromfile(cpu / "j.sr48000.cf32", np.complex64)
    assert got.shape == want.shape == (12 * 0x1000,)  # gen fills its last 0x1000 pull
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    outs = [run(main, ["from", f"{tag}.sr48000.cf32", "bucket", "-by", "freq", "2"], capsys)
            for tag, main in (("j", jcli.main), ("t", tcli.main))]
    assert outs[0] == outs[1] and outs[0][0] == 0 and len(outs[0][1].strip()) > 300

    argv = ["from", "j.sr48000.cf32", "shift", "2k", "lowpass", "4k", "write", "-format", "cs8"]
    with pytest.warns(UserWarning, match="saturate"):
        j_rc, _, j_err = run(jcli.main, argv + ["jq"], capsys)
        t_rc, _, t_err = run(tcli.main, argv + ["tq"], capsys)
    # a decimated file stream ends on the reference's zero-length read
    assert (t_rc, t_err) == (j_rc, j_err) == (1, "Error: short read at offset 6139 of 6140\n")
    assert (cpu / "tq.sr6000.cs8").read_bytes() == (cpu / "jq.sr6000.cs8").read_bytes()

    rc, _, err = run(tcli.main, ["gen", "-cos", "1k", "48k", "write", "t"], capsys)
    assert rc == 1 and "File exists" in err  # no clobber
    assert run(tcli.main, ["gen", "-cos", "1k", "48k", "write", "-overwrite", "yes", "t"], capsys)[0] == 0


@pytest.mark.parametrize(
    "argv,what",
    [
        (["from", OOK, "resample", "3/2", "sparkfft"], "resample"),
        (["from", OOK, "dcblock", "sparkfft"], "dcblock"),
        (["from", OOK, "agc", "sparkfft"], "agc"),
        (["from", OOK, "iqbal", "-c", "0.1:0", "sparkfft"], "iqbal"),
        (["from", FSK, "find", "-pattern", OOK], "find"),
        (["from", OOK, "ui"], "ui"),
        (["eui", OOK], "eui"),
    ],
)
def test_not_yet_ported(argv, what, cpu, capsys):
    """Every command here is ported now and prints what ``quadjax`` prints
    on the same argv (``find`` here the pattern-rate error, ``eui`` the
    slice too short for its 2048 rows); ``ui``'s printed range is compared
    as numbers (within 1e-5 of the larger; another FFT's rounding), and its
    image by ``tests/test_torch_viz.py``."""
    rc, out, err = run(tcli.main, argv, capsys)
    if what == "ui":
        j_rc, j_out, j_err = run(jcli.main, argv, capsys)
        assert (rc, err) == (j_rc, j_err) == (0, "")
        (lo, hi), (j_lo, j_hi) = (map(float, o.splitlines()[0].split()) for o in (out, j_out))
        assert abs(lo - j_lo) <= 1e-5 * j_hi and abs(hi - j_hi) <= 1e-5 * j_hi
        assert out.splitlines()[1:] == j_out.splitlines()[1:] == ["wrote ui.png"]
        return
    if what == "eui":
        assert (rc, out, err) == run(jcli.main, argv, capsys)
        assert rc == 1 and "must be greater than output length (2048)" in err
        return
    assert (rc, out, err) == run(jcli.main, argv, capsys)
    assert (rc, err) == ((1, "Error: pattern rate 400 != stream rate 48000: resample one side first\n")
                         if what == "find" else (0, ""))
    assert what == "find" or out.startswith("sparkfft sample_rate=") and out.count("\n") > 10


def test_chain_parse_errors_match_jax(cpu, capsys):
    for argv in (
        ["from"],
        ["from", OOK, "shift"],
        ["from", OOK, "lowpass", "-power", "x", "1k"],
        ["from", OOK, "sparkfft", "-range", "1"],
        ["from", OOK, "bucket", "-by", "time", "2"],
        ["from", OOK, "write", "-format", "f64", "p"],
        ["gen", "48k"],
        ["gen", "-cos", "1k", "-len", "1", "-len", "2", "48k"],
        ["from", OOK, "shift", "-5k"],  # the reference's quirk: -5k is a flag
        ["from", OOK, "resample", "3"],
        ["from", OOK, "find"],
        ["shift", "1k"],
        ["from", OOK, "sparkfft", "-width", "4000"],
    ):
        j_rc, j_out, j_err = run(jcli.main, argv, capsys)
        t_rc, t_out, t_err = run(tcli.main, argv, capsys)
        assert (t_rc, t_err) == (j_rc, j_err), argv
        assert t_rc == 1
        assert ("usage:" in t_out) == ("usage:" in j_out)
