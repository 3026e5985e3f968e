"""The output check fails what it must, on the CPU at a small size:

* the control, the plain reference put in the program's place and
  computed in TF32 (one precision below the configurations' float32 with
  TF32 off), against each cell's own limits;
* a whole run of each cell with the program broken underneath: an answer
  altered where it is produced (a magnitude, a printed glyph), half of
  each batch left out, and a step that leaves its state unchanged (each
  chunk or batch computed from the first one's samples).  No cell runs
  on more than one chip, so none can leave out an exchange between chips.

    QUADRS_PLATFORM=cpu python -m pytest sdrbench/test_sdrbench_control.py
"""

from __future__ import annotations

import os

import pytest
import torch

from sdrbench import control, spec
from sdrbench import run as bench_run
from sdrbench.reference.chain import GLYPHS
from sdrbench.tiny import tiny_root

os.environ.setdefault("QUADRS_PLATFORM", "cpu")
CPU = torch.device("cpu")
CELLS = ["cond.sparkfft_capture", "fsk.live"]
STREAM_CELLS = ["fsk.live"]
CHAIN_CELLS = ["cond.sparkfft_capture"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("cells"))


def _failed(cell: spec.Cell, readings: dict) -> list[str]:
    limits = dict(cell.limits, passes_failed=0.0)
    return [k for k, v in readings.items() if not v <= limits[k]]


@pytest.mark.parametrize("seed", [3, 2**31 + 9, 2**32 + 1])
@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails_and_float32_passes(root, name, seed):
    cell = spec.Cell(name, root=root)
    assert _failed(cell, control.readings(cell, seed, "tf32", CPU, 3, 3.0))
    assert not _failed(cell, control.readings(cell, seed, "f32", CPU, 3, 3.0))


def _run(root, tmp_path, name) -> dict:
    result, _ = bench_run.run_cell(spec.Cell(name, root=root), 2**31 + 21, 0.5, False, CPU, str(tmp_path))
    return result


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(root, tmp_path, name):
    assert _run(root, tmp_path, name)["correct"]


def _alter(out):
    """One answer changed where it is made: one magnitude raised by a
    tenth of its row's largest."""
    out = out.clone()
    out[0, 5] += 0.1 * out[0].max()
    return out


def _halve(out):
    """Half of the batch left out: its later rows never computed."""
    out = out.clone()
    out[out.shape[0] // 2 :] = 0
    return out


@pytest.mark.parametrize("fault", [_alter, _halve])
@pytest.mark.parametrize("name", STREAM_CELLS)
def test_a_broken_stream_step_is_caught(root, tmp_path, monkeypatch, name, fault):
    from quadrs_tpu_torch.stream_runner import StreamRunner

    step = StreamRunner._step
    monkeypatch.setattr(StreamRunner, "_step", lambda self, *a: fault(step(self, *a)))
    assert not _run(root, tmp_path, name)["correct"]


@pytest.mark.parametrize("name", CHAIN_CELLS)
def test_an_altered_glyph_is_caught(root, tmp_path, monkeypatch, name):
    """One glyph of each batch's first row printed four levels off."""
    from quadrs_tpu_torch import sinks

    lines = sinks.glyph_lines

    def altered(norms, lo, hi, frame=True):
        text = lines(norms, lo, hi, frame)
        i = 6
        return text[:i] + GLYPHS[(GLYPHS.index(text[i]) + 4) % 9] + text[i + 1 :]

    monkeypatch.setattr(sinks, "glyph_lines", altered)
    assert not _run(root, tmp_path, name)["correct"]


@pytest.mark.parametrize("name", CHAIN_CELLS)
def test_a_half_batch_is_caught(root, tmp_path, monkeypatch, name):
    from quadrs_tpu_torch import sinks

    post = sinks.stft_norms
    monkeypatch.setattr(sinks, "stft_norms", lambda x, **kw: _halve(post(x, **kw)))
    assert not _run(root, tmp_path, name)["correct"]


@pytest.mark.parametrize("name", STREAM_CELLS)
def test_a_stream_that_does_not_advance_is_caught(root, tmp_path, monkeypatch, name):
    """Each step computes from the state the first one had: the first
    chunk's samples and phases, whatever chunk it is given."""
    from quadrs_tpu_torch.stream_runner import StreamRunner

    step = StreamRunner._step
    first = {}

    def frozen(self, mode, off, raw, head, valid, threshold):
        if not first:
            first.update(off=off, raw=raw.clone(), head=None if head is None else head.clone())
        if first["raw"].shape != raw.shape:
            return step(self, mode, off, raw, head, valid, threshold)
        return step(self, mode, first["off"], first["raw"], first["head"], valid, threshold)

    monkeypatch.setattr(StreamRunner, "_step", frozen)
    assert not _run(root, tmp_path, name)["correct"]


@pytest.mark.parametrize("name", CHAIN_CELLS)
def test_a_chain_that_does_not_advance_is_caught(root, tmp_path, monkeypatch, name):
    """Every batch computed from the span the first batch of its pass and
    shape staged (batches cut to 16 windows, so a small pass has many)."""
    from quadrs_tpu_torch import sinks
    from quadrs_tpu_torch.runtime import Executor

    batches = sinks.stream_batches
    monkeypatch.setattr(sinks, "stream_batches", lambda *a, **kw: batches(*a, **kw, budget=16 * a[2]))
    stage = Executor._stage
    first = {}

    def frozen(self, lo, hi):
        buf = stage(self, lo, hi)
        if first.get("executor") is not self:
            first.clear()
            first["executor"] = self
        return first.setdefault(tuple(buf.shape), buf.clone())

    monkeypatch.setattr(Executor, "_stage", frozen)
    assert not _run(root, tmp_path, name)["correct"]
