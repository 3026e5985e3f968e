"""The harness on the CPU: discovery by name, the last line's shape, its
arithmetic, the check for JAX, and a run without a card.

    QUADRS_PLATFORM=cpu python -m pytest sdrbench/test_sdrbench_harness.py
"""

from __future__ import annotations

import hashlib
import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from sdrbench import arith, devtrace, spec
from sdrbench import run as bench_run
from sdrbench.tiny import tiny_root

os.environ.setdefault("QUADRS_PLATFORM", "cpu")
CHECKOUT = pathlib.Path(__file__).resolve().parent.parent
CELLS = ["cond.sparkfft_capture", "fsk.live"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("cells"))


@pytest.fixture(scope="module")
def bench():
    return json.loads((CHECKOUT / "BENCHMARK.json").read_text())


def _digest(root: pathlib.Path) -> dict[str, str]:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest() for p in root.rglob("*") if p.is_file()}


def test_a_config_a_cell_and_a_metric_are_added_as_files(root, bench):
    before = _digest(root)
    cfg = json.loads((root / "configs" / "fsk_conditioned_cs8.json").read_text())
    cfg["name"] = "fsk_conditioned_cs8_shift300k"
    cfg["chain"][0]["freq"] = 300_000
    (root / "configs" / "fsk_conditioned_cs8_shift300k.json").write_text(json.dumps(cfg))
    cell = json.loads((root / "workloads" / "cond.sparkfft_capture.json").read_text())
    cell["config"] = "fsk_conditioned_cs8_shift300k"
    (root / "workloads" / "cond300.sparkfft_capture.json").write_text(json.dumps(cell))
    (root / "metrics" / "passes_per_s.py").write_text(
        "def read(run):\n    return run.passes / run.window_s if run.passes else None\n")
    added = dict(bench)
    added["per_layer"] = bench["per_layer"] + [
        {"name": "passes_per_s", "unit": "1/s", "better": "higher", "source": "host_clock", "layer": "CLI",
         "moves": "msps", "workloads": ["cond300.sparkfft_capture"]}]
    added["end_to_end"] = [dict(m, workloads=m["workloads"] + ["cond300.sparkfft_capture"]) if m["name"] == "msps" else m
                           for m in bench["end_to_end"]]
    after = _digest(root)
    assert {k: v for k, v in after.items() if k in before} == before  # nothing that was there changed
    c = spec.Cell("cond300.sparkfft_capture", root=root, bench=added)
    assert c.config["chain"][0]["freq"] == 300_000
    assert [m["name"] for m in c.metrics(False)] == ["msps", "setup_s"]
    assert [m["name"] for m in c.metrics(True)] == ["passes_per_s"]
    (root / "tmp_run").mkdir()
    result, _ = bench_run.run_cell(c, 5, 0.3, True, torch.device("cpu"), str(root / "tmp_run"))
    assert result["correct"]
    assert result["metrics"]["passes_per_s"]["value"] > 0


def test_every_cell_names_files_that_exist(bench):
    for w in bench["workloads"]:
        c = spec.Cell(w["name"], bench=bench)
        assert c.workload["config"] == w["config"] and c.workload["traffic"] == w["traffic"]
        assert c.workload["chips"] == w["chips"] and c.workload["why"] == w["why"]
        for m in c.metrics(False) + c.metrics(True):
            assert callable(c.reader(m["name"]).read)
        assert any(m["name"] == "setup_s" for m in c.metrics(False)) and len(c.metrics(False)) >= 2
        assert c.metrics(True)
    for cfg in bench["configs"]:
        d = json.loads((CHECKOUT / cfg["file"]).read_text())
        assert d["source"] == cfg["source"] and d["reduced"] == cfg["reduced"] == []


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("name", CELLS)
def test_the_last_line(root, bench, tmp_path, name, trace):
    result, lines = bench_run.run_cell(spec.Cell(name, root=root, bench=bench), 2**31 + 3, 0.5, trace,
                                       torch.device("cpu"), str(tmp_path))
    text = json.dumps(result)
    assert json.loads(text) == result
    keys = list(result)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics", "device"] and keys[-1] == "checks"
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] > 0
    assert set(result["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    want = {m["name"] for m in spec.cell_metrics(bench, name, trace)}
    assert set(result["metrics"]) <= want
    if not trace and name in {w["name"] for w in bench["workloads"]}:
        assert {"setup_s"} < set(result["metrics"])
    for m in result["metrics"].values():
        assert set(m) == {"value", "unit"}
    # the CPU reads no device number
    assert not any(n.startswith(("device_idle", "chain_roofline", "peak_device")) for n in result["metrics"])
    assert lines[-len(result["checks"]):] == [f"check {k}: {v['value']!r} (limit {v['limit']!r})"
                                              for k, v in result["checks"].items()]


def test_percentile_spread_and_union():
    v = list(range(1, 101))
    assert arith.percentile(v, 95) == pytest.approx(95.05)
    assert arith.percentile(v, 50) == pytest.approx(50.5)
    assert arith.spread([10, 10, 10, 10, 10, 10]) == 0
    assert arith.spread([9, 10, 10, 10, 10, 11]) == pytest.approx(0.05)  # quartiles 9.75 and 10.25
    assert arith.union_length([(0, 2), (1, 3), (5, 6), (5.5, 5.7)]) == 4
    assert arith.merged([(0, 2), (1, 3), (5, 6)]) == [(0, 3), (5, 6)]


def test_roofline_and_idle_share_arithmetic():
    assert arith.least_seconds(67e12, 1.0) == (pytest.approx(1.0), "flops")
    assert arith.least_seconds(1.0, 3.35e12) == (pytest.approx(1.0), "bytes")
    per = arith.conditioned_flops_per_sample(400, 32, 64, 16)
    assert per == pytest.approx(6 + 50 + 19 / 32 + (5 * 64 * 6 + 4 * 64) / 512)
    # 2^24 samples of the conditioned chain: 2 bytes in a sample, a 64-bin
    # f32 row out every 512; its operations, not its bytes, set the bound
    n = 1 << 24
    t, by = arith.least_seconds(n * per, 2 * n + (n // 512) * 64 * 4)
    assert by == "flops" and t == pytest.approx(n * per / 67e12)
    reader = spec.load_module("metrics", "device_idle_share.capture")
    fake = type("R", (), {"kind": "capture", "device": torch.device("cuda"), "trace_out": {"busy_s": 1.5},
                          "window_s": 6.0})()
    assert reader.read(fake) == pytest.approx(75.0)
    roof = spec.load_module("metrics", "chain_roofline_share.conditioned")
    cfg = json.loads((spec.HERE / "configs" / "fsk_conditioned_cs8.json").read_text())
    fake = type("R", (), {"kind": "capture", "device": torch.device("cuda"), "config": cfg, "samples": n,
                          "trace_out": {"kernel_s": 2 * t}})()
    assert roof.read(fake) == pytest.approx(50.0)


def test_idle_gaps_are_labelled_by_the_launching_threads_calls():
    from torch.autograd import DeviceType

    class Ev:
        def __init__(self, name, a, b, dev, thread=1):
            self.name, self.device_type, self.thread = name, dev, thread
            self.time_range = type("T", (), {"start": a, "end": b})()

    class Prof:
        def events(self):
            C, G = DeviceType.CPU, DeviceType.CUDA
            return [Ev("cudaLaunchKernel", 0, 5, C), Ev("cudaStreamSynchronize", 100, 400, C),
                    Ev("cudaMemcpyAsync", 500, 600, C, 2),
                    Ev("kern", 0, 100, G), Ev("Memcpy HtoD (Pinned -> Device)", 400, 450, G), Ev("kern", 700, 1000, G)]

    out = devtrace.read(Prof())
    assert out["busy_s"] == pytest.approx(450e-6) and out["kernel_s"] == pytest.approx(400e-6)
    assert dict(out["idle_gaps"]) == pytest.approx({"host: cudaStreamSynchronize": 300e-6,
                                                    "host: no CUDA call (Python or native host work)": 250e-6})
    assert out["device_ops"][0] == ["kern", pytest.approx(400e-6)]


def test_forbidden_modules_compare_whole_top_level_names():
    mods = {"quadrs_tpu_torch": 1, "quadrs_tpu_torch.cli": 1, "jaxtyping": 1, "flaxen": 1}
    assert bench_run.forbidden_modules(mods) == []
    assert bench_run.forbidden_modules({**mods, "quadrs_tpu.stream": 1, "jaxlib": 1, "flax": 1}) == [
        "flax", "jaxlib", "quadrs_tpu.stream"]


@pytest.mark.parametrize("name", CELLS)
def test_a_cell_rehearsed_on_the_cpu_loads_no_jax(tmp_path, name):
    code = (
        "import os, sys, torch\n"
        "from sdrbench import spec, run\n"
        "from sdrbench.tiny import tiny_root\n"
        f"root = tiny_root({str(tmp_path / 'cells')!r})\n"
        f"c = spec.Cell({name!r}, root=root, bench=spec.load_benchmark())\n"
        f"r, _ = run.run_cell(c, 11, 0.3, False, torch.device('cpu'), {str(tmp_path)!r})\n"
        "assert r['correct']\n"
        "print('FOUND', run.forbidden_modules())\n"
    )
    env = dict(os.environ, QUADRS_PLATFORM="cpu")
    out = subprocess.run([sys.executable, "-c", code], cwd=CHECKOUT, capture_output=True, text=True, timeout=300, env=env)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "FOUND []"


def test_a_run_without_a_card_fails_and_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-m", "sdrbench.run", "--workload", "fsk.live", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], cwd=CHECKOUT, capture_output=True, text=True, timeout=300, env=env)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "no result" in out.stderr


@pytest.mark.cuda
def test_a_short_run_on_the_card():
    """On the card: one short run of the live cell gives a correct line."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, "-m", "sdrbench.run", "--workload", "fsk.live", "--seed", "3",
                          "--seconds", "2", "--trace", "0"], cwd=CHECKOUT, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
    assert result["device"]["kind"] == torch.cuda.get_device_name(0)
