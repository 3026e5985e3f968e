"""The per-layer metrics that read the program's spans, on the CPU over
the tiny cells: each reads a finite number in its own cell's traced run,
and nothing in an untraced run, in the other cell, or from a program that
keeps no spans.

    QUADRS_PLATFORM=cpu python -m pytest sdrbench/test_sdrbench_spans.py
"""

from __future__ import annotations

import json
import math
import os
import pathlib
from types import SimpleNamespace

import pytest
import torch

from sdrbench import run as bench_run
from sdrbench import spec
from sdrbench.tiny import tiny_root

os.environ.setdefault("QUADRS_PLATFORM", "cpu")
CHECKOUT = pathlib.Path(__file__).resolve().parent.parent
SPANS = {
    "cond.sparkfft_capture": ["executor_stage_ms_per_batch", "executor_plan_ms_per_batch",
                              "executor_sync_upload_ms_per_batch", "executor_wait_ms_per_batch",
                              "sink_render_ms_per_batch"],
    "fsk.live": ["runner_holdback_ms.live", "chunk_host_ms_p95.live"],
}
KIND = {"cond.sparkfft_capture": "capture", "fsk.live": "live"}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("cells"))


@pytest.fixture(scope="module")
def bench():
    return json.loads((CHECKOUT / "BENCHMARK.json").read_text())


def test_each_span_metric_is_declared_for_its_cell(bench):
    per_layer = {m["name"]: m for m in bench["per_layer"]}
    for cell, names in SPANS.items():
        for name in names:
            m = per_layer[name]
            assert m["source"] == "program_span" and m["workloads"] == [cell] and m["unit"] == "ms"
            assert name in {x["name"] for x in spec.cell_metrics(bench, cell, True)}


@pytest.mark.parametrize("trace", [True, False])
@pytest.mark.parametrize("name", list(SPANS))
def test_the_span_metrics_read_their_own_cells_traced_run(root, bench, tmp_path, name, trace):
    from quadrs_tpu_torch.utils.profiling import PROFILER

    PROFILER.reset()  # no spans an earlier test left
    cell = spec.Cell(name, root=root, bench=bench)
    result, _ = bench_run.run_cell(cell, 2**31 + 7, 0.5, trace, torch.device("cpu"), str(tmp_path))
    assert result["correct"] is True
    mine, others = SPANS[name], [m for c, ms in SPANS.items() if c != name for m in ms]
    for m in mine:
        if trace:
            assert math.isfinite(result["metrics"][m]["value"]) and result["metrics"][m]["value"] >= 0, m
            assert result["metrics"][m]["unit"] == "ms"
        else:
            assert m not in result["metrics"]
    assert not set(others) & set(result["metrics"])
    # the spans the run left: the other cell's readers find nothing in them,
    # whatever kind of run they are asked about
    for kind in ("capture", "live"):
        fake = SimpleNamespace(trace=True, kind=kind)
        for m in others:
            assert cell.reader(m).read(fake) is None, m
    # an untraced run reads nothing, whatever spans are held
    for m in mine:
        assert cell.reader(m).read(SimpleNamespace(trace=False, kind=KIND[name])) is None


def test_a_program_without_spans_reads_nothing(root, monkeypatch):
    """The parent's program has a ``PROFILER`` with no ``spans``: every
    reader gives None and raises nothing."""
    from quadrs_tpu_torch.utils import profiling

    monkeypatch.setattr(profiling, "PROFILER", SimpleNamespace(enabled=False, stages={}))
    for cell, names in SPANS.items():
        for m in names:
            reader = spec.load_module("metrics", m, root)
            assert reader.read(SimpleNamespace(trace=True, kind=KIND[cell])) is None
