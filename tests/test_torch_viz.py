"""The renderers (``ui``, ``eui``, ``scan -plot``, ``psk -plot``'s
constellation), ``sinks.take_fft`` and the PNG writer against the JAX
package.

Captures are made with numpy from a seed.  What is held, and how:
- ``take_fft``'s window offsets and ``eui``'s percentage slice bit for bit
  (captured from the JAX package's own calls);
- norms within ``1e-5 * max`` (another FFT's f32 rounding);
- images pixel for pixel, but at pixels whose value lies within a margin
  of a quantization boundary of its colour map, counted.  The margin is
  ``MARGIN * max(norms)`` for ``ui`` and ``eui`` (a pixel whose colour
  differs between ``norm - margin`` and ``norm + margin``), and for the
  survey a rounding edge of its dB row within the same relative margin,
  or a threshold count that differs between the packages' scans;
- the colour maps and rasterizers on the same inputs exactly;
- the PNG writer's files decoded by PIL (here only: the port has no
  Pillow) to the array written.
"""

import re

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from PIL import Image  # noqa: E402

from quadrs_tpu import cli as jcli  # noqa: E402
from quadrs_tpu import sinks as jsinks  # noqa: E402
from quadrs_tpu.viz import waterfall as jwf  # noqa: E402

from quadrs_tpu_torch import cli as tcli  # noqa: E402
from quadrs_tpu_torch import sinks as tsinks  # noqa: E402
from quadrs_tpu_torch.sources import SampleSource, ToneGen, open_capture  # noqa: E402
from quadrs_tpu_torch.utils.png import png_bytes, read_png, write_png  # noqa: E402
from quadrs_tpu_torch.viz import waterfall as twf  # noqa: E402

CPU = torch.device("cpu")
MARGIN = 1e-5  # of the largest norm: the two packages' FFTs differ below it


def write_capture(path, n=60_000, seed=0, fmt="cs8", rate="48k", stem="cap"):
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    x = 0.2 * (rng.standard_normal(n) + 1j * rng.standard_normal(n)) + 0.5 * np.exp(0.9j * t) + 0.3 * np.exp(-0.25j * t * (1 + t / n))
    iq = np.stack([x.real, x.imag], -1).reshape(-1)
    raw = iq.astype("<f4") if fmt == "cf32" else np.clip(np.rint(iq * 100), -127, 127).astype(np.int8)
    name = path / f"{stem}.sr{rate}.{fmt}"
    raw.tofile(name)
    return str(name)


def png(path) -> np.ndarray:
    return np.asarray(Image.open(path).convert("RGB"))


def assert_pixels(got: np.ndarray, want: np.ndarray, near: np.ndarray) -> int:
    """Images equal but at ``near`` pixels; returns the differing count."""
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    diff = (got != want).any(axis=-1)
    assert not (diff & ~near).any(), f"{int((diff & ~near).sum())} pixels differ away from a boundary"
    return int(diff.sum())


# ------------------------------------------------------------ the PNG writer


@pytest.mark.parametrize("h,w", [(1, 1), (3, 5), (48, 64), (17, 256)])
def test_png_writer_decodes_to_the_pixels(h, w, tmp_path):
    img = np.random.default_rng(h * w).integers(0, 256, (h, w, 3), dtype=np.uint8)
    path = write_png(tmp_path / "a.png", img)
    np.testing.assert_array_equal(png(path), img)
    np.testing.assert_array_equal(read_png(path), img)
    assert png_bytes(img) == path.read_bytes()
    with pytest.raises(FileExistsError):
        write_png(path, img, overwrite=False)
    write_png(path, img[::-1].copy())  # a plain overwrite
    np.testing.assert_array_equal(png(path), img[::-1])
    with pytest.raises(ValueError, match="uint8"):
        png_bytes(img.astype(np.int16))


# ---------------------------------------------------------------- take_fft


@pytest.mark.parametrize("start,visible,rows", [(0, 1000, 7), (12_345, 20_000, 2048), (5, 4097, 4096), (0, 3, 2)])
def test_take_fft_offsets_bitwise(start, visible, rows, monkeypatch):
    """Rust's half-away-from-zero rounding of ``step * i`` in f64, as the JAX
    package computes it (its offsets captured from its own call)."""
    seen = {}
    real = jsinks.window_batches

    def spy(offsets, width, **kw):
        seen["offsets"] = np.asarray(offsets)
        return real(offsets, width, **kw)

    monkeypatch.setattr(jsinks, "window_batches", spy)
    from quadrs_tpu.sources import ToneGen as JTone

    jsinks.take_fft(JTone([100], 48_000, 10.0), (start, start + visible), 8, rows)
    np.testing.assert_array_equal(tsinks.take_fft_offsets(start, visible, rows), seen["offsets"])


@pytest.mark.parametrize("windowing", ["blackman-harris", "rectangular"])
@pytest.mark.parametrize("fmt", ["cs8", "cf32"])
def test_take_fft_norms_against_jax(windowing, fmt, tmp_path):
    from quadrs_tpu.sources import open_capture as j_open

    path = write_capture(tmp_path, fmt=fmt)
    got = tsinks.take_fft(open_capture(path), (1000, 50_000), 256, 300, windowing, device=CPU)
    want = jsinks.take_fft(j_open(path), (1000, 50_000), 256, 300, windowing)
    assert (got.output_len, got.fft_width) == (want.output_len, want.fft_width) == (300, 256)
    assert float(np.abs(got.norms - want.norms).max()) <= MARGIN * want.max()
    assert got.get(299).shape == (256,) and abs(got.max() - want.max()) <= MARGIN * want.max()


def test_take_fft_errors_keep_their_words():
    src = ToneGen([100], 4000, 1.0)
    from quadrs_tpu.sources import ToneGen as JTone

    jsrc = JTone([100], 4000, 1.0)
    for args in (((10, 10), 8, 2), ((0, 4000), 8, 2), ((0, 100), 8, 100), ((0, 100), 8, 2, "hann")):
        with pytest.raises(ValueError) as t_err:
            tsinks.take_fft(src, *args, device=CPU)
        with pytest.raises(ValueError) as j_err:
            jsinks.take_fft(jsrc, *args)
        assert str(t_err.value) == str(j_err.value)
    with pytest.raises(IndexError):
        tsinks.FftResult(np.zeros((2, 4), np.float32), 4).get(2)


def test_take_fft_short_window_raises():
    """A window that comes back short is an error here ("read-exact messed
    up"); the live waterfall stops at one instead (test_torch_viz_live)."""
    from quadrs_tpu_torch.formats import FileFormat
    from quadrs_tpu_torch.stream import LowPass

    raw = np.random.default_rng(1).standard_normal(8000).astype("<f4")
    src = SampleSource(np.frombuffer(raw.tobytes(), dtype=np.uint8), FileFormat.COMPLEX_FLOAT32, 4000)
    lp = LowPass(src, 500, 4, 40)  # over-reports its length by one
    with pytest.raises(RuntimeError, match="read-exact messed up in take_fft"):
        tsinks.take_fft(lp, (lp.length - 300, lp.length - 1), 32, 100, device=CPU)


# ----------------------------------------------------------------- colour maps


def test_colour_maps_equal_jax():
    s = np.concatenate([np.linspace(-0.2, 1.3, 20_001), [0.0, 0.25, 0.5, 0.75, 1.0, 1.1]])
    np.testing.assert_array_equal(twf._hsv_to_rgb_u8(s), jwf._hsv_to_rgb_u8(s))
    norms = np.array([[0.0, 1.0, 5.0, 9.96, 10.0, 1e6, -3.0]], dtype=np.float32)
    np.testing.assert_array_equal(twf.blue_map(norms), np.clip(norms / 10.0 * 256.0, 0, 255).astype(np.uint8))
    assert list(twf.blue_map(norms)[0]) == [0, 25, 128, 254, 255, 255, 0]


def test_rasterizers_equal_jax():
    """The survey and constellation rasterizers on the same inputs."""
    from quadrs_tpu.viz.constellation import constellation_render as j_const
    from quadrs_tpu.viz.survey import survey_render as j_survey
    from quadrs_tpu_torch.viz.constellation import constellation_render
    from quadrs_tpu_torch.viz.survey import survey_render

    rng = np.random.default_rng(3)
    avg = rng.uniform(0.01, 5, 300).astype(np.float32)
    mx = avg * rng.uniform(1, 4, 300).astype(np.float32)
    occ = rng.uniform(0, 1, 300).astype(np.float32)
    np.testing.assert_array_equal(survey_render(avg, mx, occ), j_survey(avg, mx, occ))
    for order in (2, 4):
        sym = (np.exp(2j * np.pi * rng.integers(0, order, 500) / order) + 0.1 * rng.standard_normal(500)).astype(np.complex64)
        np.testing.assert_array_equal(constellation_render(sym, order), j_const(sym, order))
    with pytest.raises(ValueError, match="no symbols"):
        constellation_render(np.zeros(0, np.complex64), 2)


# --------------------------------------------------------------------- ui


def ui_near(norms: np.ndarray, p) -> np.ndarray:
    m = MARGIN * float(norms.max())
    return (twf.ui_paint(norms - m, p)[0] != twf.ui_paint(norms + m, p)[0]).any(axis=-1)


@pytest.mark.parametrize("params", [dict(width=100, height=80, fft_width=8, stretch=2, stride=5),
                                    dict(width=64, height=48, stride=3), dict()])
def test_ui_render_against_jax(params, tmp_path):
    """The canvas and its printed (min, max) against JAX's, on a capture and
    on a tone generator."""
    from quadrs_tpu.sources import open_capture as j_open

    path = write_capture(tmp_path, n=20_000)
    p, jp = twf.UiParams(**params), jwf.UiParams(**params)
    norms = twf.ui_norms(open_capture(path), p, device=CPU)
    img, lo, hi = twf.ui_paint(norms, p)
    want, j_lo, j_hi = jwf.ui_render(j_open(path), jp)
    assert_pixels(img, want, ui_near(norms, p))
    assert abs(lo - j_lo) <= MARGIN * hi and abs(hi - j_hi) <= MARGIN * hi
    got, _, _ = twf.ui_render(ToneGen([100, -300], 4000, 0.5), p, device=CPU)
    assert got.shape == (p.height, p.width, 3)


def test_ui_render_errors():
    g = ToneGen([100], 4000, 0.5)
    with pytest.raises(ValueError, match="too narrow"):
        twf.ui_render(g, twf.UiParams(width=8, height=80, fft_width=8), device=CPU)
    with pytest.raises(ValueError, match="stretching"):
        twf.ui_render(g, twf.UiParams(stretch=0), device=CPU)
    with pytest.raises(ValueError, match="shorter than fft"):
        twf.ui_render(ToneGen([100], 4, 1.0), twf.UiParams(), device=CPU)


def run(main, argv, capsys):
    rc = main(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


@pytest.fixture
def cpu(monkeypatch, tmp_path):
    monkeypatch.setenv("QUADRS_PLATFORM", "cpu")
    monkeypatch.chdir(tmp_path)
    return tmp_path


def split_run(pkg: str, out: str) -> tuple[list[tuple[float, float]], list[str]]:
    """A ``ui`` run's printed (min, max) pairs and its other lines, with the
    written names' directory dropped."""
    pairs, rest = [], []
    for line in out.splitlines():
        m = re.fullmatch(r"(\S+) (\S+)", line)
        if m and not line.startswith("wrote"):
            pairs.append((float(m[1]), float(m[2])))
        else:
            rest.append(line.replace(f"{pkg}/", ""))
    return pairs, rest


@pytest.mark.parametrize("frames", [1, 3])
def test_cli_ui_against_quadjax(frames, cpu, capsys):
    """``from CAP ui [-frames N]``: the same files (``ui.png``, or
    ``ui000.png``... with the fft width doubling a frame), the same pixels
    but at counted boundary pixels, the printed ranges as numbers."""
    path = write_capture(cpu, n=30_000)
    (cpu / "t").mkdir()
    (cpu / "j").mkdir()
    flags = ["-frames", str(frames)] if frames > 1 else []
    outs = {}
    for pkg, main in (("t", tcli.main), ("j", jcli.main)):
        rc, outs[pkg], err = run(main, ["from", path, "ui", "-fft", "16", "-stride", "5", *flags], capsys)
        assert (rc, err) == (0, "")
        for name in cpu.glob("ui*.png"):
            name.rename(cpu / pkg / name.name)
    t_pairs, t_rest = split_run("t", outs["t"])
    j_pairs, j_rest = split_run("j", outs["j"])
    assert t_rest == j_rest == ([f"wrote ui{k:03d}.png" for k in range(frames)] if frames > 1 else ["wrote ui.png"])
    assert len(t_pairs) == len(j_pairs) == frames
    flipped = 0
    for k in range(frames):
        name = f"ui{k:03d}.png" if frames > 1 else "ui.png"
        p = twf.UiParams(fft_width=16 << k, stride=5)
        norms = twf.ui_norms(open_capture(path), p, device=CPU)
        flipped += assert_pixels(png(cpu / "t" / name), png(cpu / "j" / name), ui_near(norms, p))
        (lo, hi), (j_lo, j_hi) = t_pairs[k], j_pairs[k]
        assert abs(lo - j_lo) <= MARGIN * j_hi and abs(hi - j_hi) <= MARGIN * j_hi
    assert flipped <= 1e-3 * frames * 600 * 800


def test_cli_ui_takes_the_accumulator(cpu, capsys):
    """``ui`` takes the samples: a chain command after it has no input, as
    in quadjax; ``ui`` with no input is an error."""
    path = write_capture(cpu, n=5_000)
    for argv in (["from", path, "ui", "sparkfft"], ["ui"]):
        t = run(tcli.main, argv, capsys)
        assert t == run(jcli.main, argv, capsys) or (t[0], t[2]) == run(jcli.main, argv, capsys)[::2]
        assert t[0] == 1


# -------------------------------------------------------------------- eui


def eui_near(norms: np.ndarray) -> np.ndarray:
    m = MARGIN * float(norms.max())
    return twf.blue_map(norms - m) != twf.blue_map(norms + m)


@pytest.mark.parametrize("start,end", [(46.0, 46.3), (10.0, 40.0), (0.0, 99.5), (33.3, 33.4)])
def test_eui_slice_bitwise(start, end, monkeypatch):
    """eui's slice bounds in f32 products, as the JAX package's (captured)."""
    seen = {}
    real = jwf.take_fft

    def spy(stream, slice_, *a, **kw):
        seen["slice"] = slice_
        return real(stream, slice_, *a, **kw)

    monkeypatch.setattr(jwf, "take_fft", spy)
    from quadrs_tpu.sources import ToneGen as JTone

    for n_sec in (1.0, 3.7, 10.0):
        jwf.eui_render(JTone([100], 100_003, n_sec), jwf.EuiParams(start, end, 16, 8))
        assert twf.eui_slice(int(100_003 * n_sec), twf.EuiParams(start, end, 16, 8)) == seen["slice"]


@pytest.mark.parametrize("flags,names", [([], ["eui.png"]), (["-frames", "3", "-start", "10", "-end", "30", "-fft", "64"],
                                                               ["eui000.png", "eui001.png", "eui002.png"]),
                                         (["-frames", "5", "-start", "10", "-end", "40", "-fft", "32"],
                                          ["eui000.png", "eui001.png"])])
def test_cli_eui_against_quadjax(flags, names, cpu, capsys):
    """``eui [-frames N] FILE``: the same files and lines; pixels equal but at
    counted boundary pixels of the blue map; the scroll stops before the
    slice reaches the end of the file."""
    path = write_capture(cpu, n=1_000_000, seed=4)
    outs = {}
    for pkg, main in (("t", tcli.main), ("j", jcli.main)):
        (cpu / pkg).mkdir()
        rc, outs[pkg], err = run(main, ["eui", *flags, path], capsys)
        assert (rc, err) == (0, "")
        for name in cpu.glob("eui*.png"):
            name.rename(cpu / pkg / name.name)
    assert outs["t"] == outs["j"] == "".join(f"wrote {n}\n" for n in names)
    fft = int(flags[flags.index("-fft") + 1]) if "-fft" in flags else 512
    start = float(flags[flags.index("-start") + 1]) if "-start" in flags else 46.0
    end = float(flags[flags.index("-end") + 1]) if "-end" in flags else 46.3
    src = open_capture(path)
    flipped = 0
    for k, name in enumerate(names):
        p = twf.EuiParams(start + k * (end - start), end + k * (end - start), fft, 2048)
        norms = tsinks.take_fft(src, twf.eui_slice(src.length, p), fft, 2048, device=CPU).norms
        got, want = png(cpu / "t" / name), png(cpu / "j" / name)
        assert got.shape == (2048, fft, 3) and not got[..., :2].any()
        flipped += assert_pixels(got, want, eui_near(norms))
    assert flipped <= 1e-3 * len(names) * 2048 * fft


def test_cli_eui_errors_match_quadjax(cpu, capsys):
    path = write_capture(cpu, n=1_000)
    for argv in (["eui"], ["eui", path], ["eui", "-live", "yes"], ["eui", "-frames", "2", "-start", "50", "-end", "40", path]):
        t_rc, _, t_err = run(tcli.main, argv, capsys)
        j_rc, _, j_err = run(jcli.main, argv, capsys)
        assert (t_rc, t_err) == (j_rc, j_err) and t_rc == 1, argv


# -------------------------------------------------------------- scan -plot


def survey_near(result, j_result, s: int) -> np.ndarray:
    """Columns of stream ``s``'s survey whose picture may differ: a dB row
    within the relative margin of a rounding edge (lo and hi move with
    every column's), or a threshold count that differs between the scans."""
    from quadrs_tpu_torch.viz.survey import SPECTRUM_H

    a_db = 20 * np.log10(np.maximum(j_result.avg[s].astype(np.float64), 1e-30))
    m_db = 20 * np.log10(np.maximum(j_result.max_norms[s].astype(np.float64), 1e-30))
    lo, hi = a_db.min(), m_db.max()
    slack = 3 * 20 * np.log10(1 + MARGIN) * (SPECTRUM_H - 1) / max(hi - lo, 1e-9)
    near = np.zeros(a_db.shape, dtype=bool)
    for db in (a_db, m_db):
        rows = (db - lo) / max(hi - lo, 1e-9) * (SPECTRUM_H - 1)
        near |= np.abs(rows - np.floor(rows) - 0.5) < slack
    return near | (result.above[s] != j_result.above[s])


def test_cli_scan_plot_against_quadjax(cpu, capsys, monkeypatch):
    """``scan -plot yes`` writes ``scan.sK.png`` a stream (``-out P``:
    ``P.sK.png``) as quadjax does; the pictures equal but at counted columns
    (:func:`survey_near`); the port's own files are its survey rasterized."""
    from quadrs_tpu.stream_runner import WaterfallRunner as JRunner
    from quadrs_tpu_torch.stream_runner import WaterfallRunner as TRunner
    from quadrs_tpu_torch.viz.survey import survey_render

    files = [write_capture(cpu, n=40_000, seed=s, stem=f"cap{s}") for s in range(2)]
    results = {}

    def keep(runner_cls, key):
        real = runner_cls.run_scan

        def spy(self, *a, **kw):
            results[key] = real(self, *a, **kw)
            return results[key]

        monkeypatch.setattr(runner_cls, "run_scan", spy)

    keep(TRunner, "t")
    keep(JRunner, "j")
    for flags, stem in (([], "scan"), (["-out", "P"], "P")):
        outs = {}
        for pkg, main in (("t", tcli.main), ("j", jcli.main)):
            (cpu / pkg).mkdir(exist_ok=True)
            rc, outs[pkg], err = run(main, ["scan", "-width", "256", "-threshold", "12", "-plot", "yes", *flags, *files], capsys)
            assert (rc, err) == (0, "")
            for name in cpu.glob(f"{stem}.s*.*"):
                name.rename(cpu / pkg / name.name)
        for pkg in ("t", "j"):
            assert f"wrote {stem}.s0.png" in outs[pkg] and f"wrote {stem}.s1.png" in outs[pkg]
        t_res, j_res = results["t"], results["j"]
        for s in range(2):
            got, want = png(cpu / "t" / f"{stem}.s{s}.png"), png(cpu / "j" / f"{stem}.s{s}.png")
            np.testing.assert_array_equal(got, survey_render(t_res.avg[s], t_res.max_norms[s], t_res.occupancy[s]))
            near = np.broadcast_to(survey_near(t_res, j_res, s)[None, :], got.shape[:2])
            assert_pixels(got, want, near)
    assert run(tcli.main, ["scan", "-width", "256", "-plot", "yes", *files], capsys)[0] == 0
    rc, _, err = run(tcli.main, ["scan", "-width", "256", "-plot", "yes", *files], capsys)
    assert rc == 1 and "File exists" in err
    assert run(tcli.main, ["scan", "-width", "256", "-plot", "yes", "-overwrite", "yes", *files], capsys)[0] == 0
