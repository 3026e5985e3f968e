"""The live terminal waterfall (``viz/live.py``, ``ui -live``, ``eui
-live``) against the JAX package: the seven cases of
``tests/test_viz_live.py``, each run through both packages, with the port's
output lines held equal to the JAX package's, and the live pipe's end.

The rows are ANSI cells of 8-bit colours of f32 norms, so a cell may
differ where its (pooled) norm lies within the two FFTs' rounding of a
colour boundary: every other line and cell is held equal as text, and each
differing cell must be one whose colour differs between ``norm - margin``
and ``norm + margin`` (``MARGIN`` of the row's largest norm), counted."""

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
from quadrs_tpu.sources import SampleSource as JSource  # noqa: E402
from quadrs_tpu.utils.sniff import guess_details as j_guess  # noqa: E402
from quadrs_tpu.viz import live as jlive  # noqa: E402

from quadrs_tpu_torch import cli as tcli  # noqa: E402
from quadrs_tpu_torch.sources import SampleSource  # noqa: E402
from quadrs_tpu_torch.utils.sniff import guess_details  # noqa: E402
from quadrs_tpu_torch.viz import live as tlive  # noqa: E402

EXAMPLES = pathlib.Path(__file__).parent.parent / "examples"
CAPTURE = EXAMPLES / "fsk-sim.sr48k.cf32"
CPU = torch.device("cpu")
MARGIN = 1e-5
CELL = re.compile(r"\x1b\[48;2;(\d+);(\d+);(\d+)m ")


def assert_rows(text: str, j_text: str, fw: int, stride: int, cols: int, cmap: str = "hsv",
                windowing: str = "rectangular") -> int:
    """The live run's lines equal JAX's but at near-boundary cells (the
    window of data row ``r`` starts at ``r * stride`` of the example
    capture: runs with no retuning key); returns the differing cells."""
    from quadrs_tpu_torch.ops.stft import blackman_harris_window, stft_norms

    src, _ = sources()
    lines, j_lines = text.splitlines(), j_text.splitlines()
    assert len(lines) == len(j_lines)
    flipped, r = 0, -1
    for line, j_line in zip(lines, j_lines):
        cells = CELL.findall(line)
        if not cells:
            assert line == j_line
            continue
        r += 1
        if line == j_line:
            continue
        x, _ = src.read_at(r * stride, fw, CPU)
        w = torch.from_numpy(blackman_harris_window(fw)) if windowing != "rectangular" else None
        norms = stft_norms(torch.from_numpy(x)[None, :], window=w).numpy()
        pooled = tlive._pool_bins(norms, cols)[0]
        m = MARGIN * float(norms.max())
        lo, hi = (CELL.findall(tlive._row_line(pooled + d, cols, cmap)) for d in (-m, m))
        for i, (a, b) in enumerate(zip(cells, CELL.findall(j_line))):
            if a != b:
                assert lo[i] != hi[i], f"row {r} cell {i}: {a} != {b} away from a colour boundary"
                flipped += 1
    return flipped


def sources():
    return (SampleSource.from_file(str(CAPTURE), guess_details(str(CAPTURE))),
            JSource.from_file(str(CAPTURE), j_guess(str(CAPTURE))))


def both(params: dict, keys=None) -> tuple[tuple[dict, str], tuple[dict, str]]:
    """The same loop through both packages: (stats, text) of each."""
    src, jsrc = sources()
    t_out, j_out = io.StringIO(), io.StringIO()
    t_keys = None if keys is None else list(keys)
    t = tlive.live_waterfall(src, tlive.LiveParams(**params), device=CPU, out=t_out, keys=t_keys)
    j = jlive.live_waterfall(jsrc, jlive.LiveParams(**params), out=j_out, keys=keys)
    return (t, t_out.getvalue()), (j, j_out.getvalue())


def test_live_streams_rows_and_applies_keys():
    (stats, text), (j_stats, j_text) = both(dict(fft_width=16, stride=64, cols=24, max_rows=30, batch=8),
                                           keys=[(5, "+"), (10, "]"), (20, "q")])
    assert stats == j_stats == {"rows": 20, "fft_width": 32, "stride": 128}
    assert text == j_text  # retuned mid-run: held as text
    lines = text.strip().splitlines()
    data = [ln for ln in lines if not ln.startswith("-- live ")]
    assert len(data) == 20 and all(ln.count("\x1b[48;2;") == 24 for ln in data)
    assert "-- live fft 32 stride 64 --" in lines and "-- live fft 32 stride 128 --" in lines


def test_live_runs_to_eof_without_bound():
    (stats, text), (j_stats, j_text) = both(dict(fft_width=32, stride=1024, cols=16))
    src, _ = sources()
    assert stats == j_stats and stats["rows"] == (src.length - 32) // 1024 + 1
    assert_rows(text, j_text, 32, 1024, 16)


def test_live_row_colors_track_magnitude():
    """Max-pooling keeps a hot bin visible at terminal width, as JAX's; the
    pooled rows equal JAX's at every width."""
    norms = np.zeros((1, 64), dtype=np.float32)
    norms[0, 37] = 2.0
    pooled = tlive._pool_bins(norms, 8)
    assert pooled.shape == (1, 8) and pooled[0, (37 * 8) // 64] == 2.0
    rng = np.random.default_rng(0)
    many = rng.uniform(0, 3, (5, 64)).astype(np.float32)
    for cols in (8, 13, 64, 100):
        np.testing.assert_array_equal(tlive._pool_bins(many, cols), jlive._pool_bins(many, cols))
        for cmap in ("hsv", "blue"):
            row = tlive._pool_bins(many, cols)[0]
            assert tlive._row_line(row, cols, cmap) == jlive._row_line(row, cols, cmap)


def test_live_rejects_bad_params():
    src, _ = sources()
    with pytest.raises(ValueError, match="fft width"):
        tlive.live_waterfall(src, tlive.LiveParams(fft_width=1), device=CPU, out=io.StringIO())


def test_live_blue_colormap_and_bh_window():
    (stats, text), (j_stats, j_text) = both(dict(fft_width=32, stride=512, cols=16, max_rows=6,
                                                windowing="blackman-harris", colormap="blue"))
    assert stats == j_stats and stats["rows"] == 6
    assert_rows(text, j_text, 32, 512, 16, "blue", "blackman-harris")
    cells = re.findall(r"\x1b\[48;2;(\d+);(\d+);(\d+)m", text)
    assert len(cells) == 6 * 16 and all(r == "0" and g == "0" for r, g, _ in cells)
    assert any(int(b) > 0 for _, _, b in cells)


def run(main, argv, capsys):
    rc = main(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


@pytest.fixture
def cpu(monkeypatch):
    monkeypatch.setenv("QUADRS_PLATFORM", "cpu")


def test_cli_eui_live(cpu, capsys):
    argv = ["eui", "-live", "yes", "-fft", "32", "-rows", "3", "-cols", "10", str(CAPTURE)]
    rc, out, err = run(tcli.main, argv, capsys)
    j_rc, j_out, j_err = run(jcli.main, argv, capsys)
    assert (rc, err) == (j_rc, j_err) == (0, "")
    assert_rows(out, j_out, 32, 32, 10, "blue", "blackman-harris")
    assert out.strip().splitlines()[-1] == "live: 3 rows, fft 32, stride 32"
    data = [ln for ln in out.splitlines() if "\x1b[48;2;" in ln]
    assert len(data) == 3 and all(ln.count("\x1b[48;2;0;0;") == 10 for ln in data)


def test_cli_ui_live(cpu, capsys):
    argv = ["from", str(CAPTURE), "ui", "-live", "yes", "-fft", "16", "-stride", "256", "-rows", "4", "-cols", "12"]
    rc, out, err = run(tcli.main, argv, capsys)
    j_rc, j_out, j_err = run(jcli.main, argv, capsys)
    assert (rc, err) == (j_rc, j_err) == (0, "")
    assert_rows(out, j_out, 16, 256, 12)
    lines = out.strip().splitlines()
    assert lines[-1] == "live: 4 rows, fft 16, stride 256"
    assert len([ln for ln in lines if "\x1b[48;2;" in ln]) == 4


def feed_stdin(monkeypatch, data: bytes) -> None:
    monkeypatch.setattr(sys, "stdin", SimpleNamespace(buffer=io.BytesIO(data)))


@pytest.mark.parametrize("cmd,flags", [("ui", ["-fft", "16", "-stride", "700"]), ("eui", ["-fft", "64", "-stride", "333"])])
def test_cli_live_stdin_rows_equal_the_file_run(cmd, flags, cpu, capsys, monkeypatch):
    """``-live yes -stdin yes`` off a pipe: the rows the file run gives, to
    the pipe's end, where the batch that crosses EOF renders its full
    windows and stops (a pipe's length is unknown until then); quadjax's
    lines on the same pipe."""
    data = CAPTURE.read_bytes()
    pipe = [cmd, "-live", "yes", "-stdin", "yes", "-sr", "48k", "-format", "cf32", "-cols", "20", *flags]
    feed_stdin(monkeypatch, data)
    rc, out, err = run(tcli.main, pipe, capsys)
    assert (rc, err) == (0, "")
    feed_stdin(monkeypatch, data)
    j_rc, j_out, j_err = run(jcli.main, pipe, capsys)
    assert (j_rc, j_err) == (0, "")
    fft, stride = int(flags[1]), int(flags[3])
    assert_rows(out, j_out, fft, stride, 20, "hsv" if cmd == "ui" else "blue",
                "rectangular" if cmd == "ui" else "blackman-harris")
    file_argv = (["from", str(CAPTURE), "ui"] if cmd == "ui" else ["eui"]) + ["-live", "yes", "-cols", "20", *flags] + \
        ([] if cmd == "ui" else [str(CAPTURE)])
    rc, file_out, err = run(tcli.main, file_argv, capsys)
    assert (rc, err) == (0, "") and out == file_out
    n = len(data) // 8
    assert f"live: {(n - fft) // stride + 1} rows, fft {fft}, stride {stride}" in out


def test_live_pipe_eof_inside_a_batch(cpu, capsys, monkeypatch):
    """A pipe whose end falls inside a batch: the full windows before it are
    rendered and the run ends there, as quadjax's; a file whose windows come
    back short is an error instead."""
    data = CAPTURE.read_bytes()[: 8 * 5000]
    argv = ["ui", "-live", "yes", "-stdin", "yes", "-sr", "48k", "-format", "cf32", "-fft", "64", "-stride", "10", "-cols", "8"]
    feed_stdin(monkeypatch, data)
    rc, out, err = run(tcli.main, argv, capsys)
    feed_stdin(monkeypatch, data)
    j_rc, j_out, j_err = run(jcli.main, argv, capsys)
    assert (rc, err) == (j_rc, j_err) == (0, "")
    assert_rows(out, j_out, 64, 10, 8)
    assert f"live: {(5000 - 64) // 10 + 1} rows" in out
    from quadrs_tpu_torch.stream import LowPass

    src, _ = sources()
    lp = LowPass(src, 4000, 4, 40)  # over-reports its length by one: the last window is short
    with pytest.raises(RuntimeError, match="read-exact messed up in live render"):
        tlive.live_waterfall(lp, tlive.LiveParams(fft_width=16, stride=1, cols=8), device=CPU, out=io.StringIO())


def test_no_keyboard_without_a_tty(monkeypatch):
    """With stdout not a TTY (tests, pipes, the smoke run) the terminal's
    keyboard is never touched."""
    def refuse(stream):
        raise AssertionError("tried the keyboard without a TTY")

    monkeypatch.setattr(tlive, "_try_tty_keys", refuse)
    src, _ = sources()
    stats = tlive.live_waterfall(src, tlive.LiveParams(fft_width=16, stride=512, cols=8, max_rows=3), device=CPU,
                                 out=io.StringIO())
    assert stats["rows"] == 3
