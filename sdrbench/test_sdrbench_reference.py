"""The plain reference against the port's CPU route, at small sizes, for
the chains of both cells, and the reference's own tables.

    QUADRS_PLATFORM=cpu python -m pytest sdrbench/test_sdrbench_reference.py
"""

from __future__ import annotations

import ast
import contextlib
import io
import os
import pathlib
import threading
import types

import numpy as np
import pytest
import torch

from sdrbench import capture as synth
from sdrbench import spec
from sdrbench.reference import chain as ref
from sdrbench.outputs import glyph_levels
from sdrbench.tiny import tiny_root
from sdrbench.traffic import capture_cli, live_pipe

os.environ.setdefault("QUADRS_PLATFORM", "cpu")
CPU = torch.device("cpu")
SEED = 2**31 + 77


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("cells"))


def _capture(cell: spec.Cell, samples: int | None = None) -> torch.Tensor:
    cfg = cell.config
    return synth.synthesize(cfg["signal"], cfg["sample_rate"], samples or cfg["capture"]["samples"], SEED, CPU)


def test_reference_imports_nothing_of_the_program():
    for path in pathlib.Path(ref.__file__).parent.glob("*.py"):
        tree = ast.parse(path.read_text())
        names = {a.name.split(".")[0] for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
        names |= {n.module.split(".")[0] for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module}
        assert names <= {"__future__", "math", "torch"}, (path.name, names)


def test_taps_are_the_ports_windowed_sinc():
    from quadrs_tpu_torch.ops.fir import lowpass_taps

    h = ref.lowpass_taps(200_000, 21_000_000, 400)
    assert abs(float(h.sum()) - 1.0) < 1e-12
    assert torch.allclose(h, h.flip(0), atol=1e-15)
    assert np.max(np.abs(h.numpy() - lowpass_taps(200_000 / 21_000_000, 400))) < 1e-7


def test_nco_is_exact_at_large_offsets():
    m = torch.tensor([0, 75, 21_000_000 * 1000 + 75, 2**40 + 3], dtype=torch.int64)
    c, s = ref.nco(m, 280_000, 21_000_000, "f64")
    want = [np.exp(2j * np.pi * ((280_000 * int(i)) % 21_000_000) / 21_000_000) for i in m]
    assert np.allclose(c.numpy(), np.real(want), atol=1e-12) and np.allclose(s.numpy(), np.imag(want), atol=1e-12)
    assert float(c[1]) == float(c[2])  # the phase repeats with the rate


def test_glyph_levels_and_gaps():
    v = torch.tensor([0.0, 0.0799, 0.08, 0.2115, 0.9999, 1.0, 5.0], dtype=torch.float64)
    lv = ref.glyph_levels(v, 0.08, 1.0)
    assert lv.tolist() == [0, 0, 1, 2, 7, 8, 8]
    assert ref.level_gap(v, lv, 0.08, 1.0).max() == 0
    d = 0.92 / 7
    gap = ref.level_gap(torch.tensor([0.08 + 2.5 * d], dtype=torch.float64), torch.tensor([1]), 0.08, 1.0)
    assert abs(float(gap) - 1.5) < 1e-12
    assert float(ref.level_gap(torch.tensor([0.5]), torch.tensor([8]), 0.08, 1.0)) == pytest.approx(0.5 / d)


def test_tf32_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2**-10, 1.0 + 2**-11 + 2**-13, 1.0 + 2**-12, -3.0 - 2**-9], dtype=torch.float32)
    y = ref.tf32_round(x)
    assert y.tolist() == [1.0 + 2**-10, 1.0 + 2**-10, 1.0, -3.0 - 2**-9]


def test_sparkfft_chain_against_the_port(root, tmp_path):
    """``cond.sparkfft_capture``'s chain through the CLI: every printed row's levels
    hold the reference's magnitudes, read row by row as upstream reads
    them and all at once (``sparkfft_all``, what the check uses)."""
    from quadrs_tpu_torch import cli

    cell = spec.Cell("cond.sparkfft_capture", root=root)
    data = _capture(cell)
    path = str(tmp_path / "cap.sr21000000.cs8")
    synth.write(data, path)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert cli.main(capture_cli.argv(cell.config, path)) == 0
    lines = out.getvalue().splitlines()
    cap = ref.Capture(data)
    n = ref.sparkfft_rows(cell.config, cap)
    assert lines[0] == f"sparkfft sample_rate={21_000_000 // 32}" and len(lines) == n + 1
    width = cell.config["sink"]["width"]
    levels = glyph_levels("\n".join(lines[1:]) + "\n", width)
    rows = torch.arange(n)
    norms = torch.cat([ref.sparkfft_norms(cell.config, cap, rows[i : i + 16]) for i in range(0, n, 16)])
    assert torch.allclose(ref.sparkfft_all(cell.config, cap), norms, rtol=0, atol=1e-11)  # the two forms agree
    lo, hi = cell.config["sink"]["range"]
    gap = ref.level_gap(norms, torch.as_tensor(levels), lo, hi)
    assert float(gap.max()) < 1e-3
    assert len(np.unique(levels)) >= 5  # the rows use most of the nine levels


def test_live_chain_against_the_port(root):
    """``fsk.live``'s chain: a ``PipeSource`` over a pipe that carries a looped
    capture, ``StreamRunner.run``, against the reference's loop."""
    from quadrs_tpu_torch.models.receiver import PipelineModel
    from quadrs_tpu_torch.sources import PipeSource
    from quadrs_tpu_torch.stream_runner import StreamRunner

    cell = spec.Cell("fsk.live", root=root)
    loop = _capture(cell, 1 << 16)
    total = 5 * (1 << 16) - 2048  # not a whole number of loops nor of chunks
    payload = np.concatenate([loop.numpy()] * 5)[: 2 * total].tobytes()
    r, w = os.pipe()

    def feed():
        with os.fdopen(w, "wb") as f:
            for i in range(0, len(payload), 40_000):
                f.write(payload[i : i + 40_000])

    t = threading.Thread(target=feed)
    t.start()
    pcfg = live_pipe._config(types.SimpleNamespace(config=cell.config))
    rows = {}
    with os.fdopen(r, "rb") as f:
        runner = StreamRunner(PipeSource(f, pcfg.fmt, pcfg.sample_rate), PipelineModel(pcfg), CPU,
                              chunk_samples=live_pipe.whole_windows(cell.config, 30_000))
        runner.run(lambda w0, n: rows.update({w0: n.copy()}))
    t.join(10)
    got = np.concatenate([rows[k] for k in sorted(rows)])
    cap = ref.Capture(loop, length=total, loop=True)
    want = live_pipe.stream_reference(cell.config, cap, np.arange(len(got)))
    assert len(got) == total // 2048
    assert np.max(np.abs(got - want)) / np.median(want.max(axis=1)) < 2e-6
    assert want.max() / np.median(want) > 10  # the FSK tones stand above the noise
