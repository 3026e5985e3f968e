"""The port's bench (``quadrs_tpu_torch.bench``, ``bench_suite``,
``utils.timing``) on the CPU against the JAX package's root ``bench.py``
and ``bench_suite.py``.

Every entry runs at the ``smoke`` scale (the JAX entries' shapes, shorter
lengths, 0.02 s windows) and must print one parsable line that carries
its JAX counterpart's fields, read from the JAX source, but for the TPU's
own.  The flop models, the receivers' combined rate and the synthetic
captures equal the JAX bench's; the chain entries' step equals the JAX
stream chain's norms within ``5e-5 * scale`` (the kernel-versus-chain
bound).  Nothing here is a speed figure."""

import ast
import importlib.util
import io
import json
import math
import os
import pathlib
import subprocess
import sys
import time
import types

import numpy as np
import pytest
import torch

from quadrs_tpu.models.receiver import PipelineConfig as JConfig
from quadrs_tpu.models.receiver import PipelineModel as JModel
from quadrs_tpu.formats import FileFormat as JFormat

from quadrs_tpu_torch import bench
from quadrs_tpu_torch import bench_suite as bs
from quadrs_tpu_torch.models.receiver import PipelineModel
from quadrs_tpu_torch.utils.timing import measure_msps

ROOT = pathlib.Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
TOL = 5e-5


def _load(name: str):
    spec = importlib.util.spec_from_file_location(f"jax_{name}", ROOT / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


jbs = _load("bench_suite")

# the JAX fields the port does not carry: the v5e's MXU peak is the H100's
# f32 peak, and the MXU FFT factorizations of ``find`` are not ported
RENAMED = {"pct_f32_matmul_peak": "pct_f32_peak"}
TPU_ONLY = {"bench_find": {"four_step_msps", "xla_fft_msps"}, "headline": {"suite", "suite_error"}}


def _functions(path: pathlib.Path) -> dict[str, ast.FunctionDef]:
    tree = ast.parse(path.read_text())
    return {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}


def _keys(fn: ast.FunctionDef, dicts_need_metric: bool = True) -> set[str]:
    """The string keys of ``fn``'s result: dict literals (those holding a
    ``metric``, but not an ``error``), ``x["k"] = ...`` assignments, and
    what ``**tstats``, ``roofline(...)`` and ``_overlap_fields(...)`` add."""
    keys: set[str] = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Dict):
            names = {k.value for k in node.keys if isinstance(k, ast.Constant)}
            if ("metric" in names or not dicts_need_metric) and "error" not in names:
                keys |= names
                if any(k is None and getattr(v, "id", "") == "tstats" for k, v in zip(node.keys, node.values)):
                    keys |= {"linearity", "n1"}
        elif isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Subscript) and isinstance(t.slice, ast.Constant):
                    keys.add(t.slice.value)
        elif isinstance(node, ast.Call) and isinstance(node.func, ast.Name):
            if node.func.id == "roofline":
                keys |= set(jbs.roofline(1.0, 1.0, 1.0))
            elif node.func.id == "_overlap_fields":
                keys |= _keys(_functions(ROOT / "bench_suite.py")["_overlap_fields"], dicts_need_metric=False)
                if not any(kw.arg == "staging_msps" for kw in node.keywords):
                    keys.discard("serial_msps")
    return keys


def jax_fields(name: str) -> set[str]:
    """The fields of the JAX entry ``name`` (``headline``: ``bench.main``'s
    line), mapped to the port's names."""
    fn = _functions(ROOT / "bench.py")["main"] if name == "headline" else _functions(ROOT / "bench_suite.py")[name]
    keys = _keys(fn) - TPU_ONLY.get(name, set()) - {"fields"}
    return {RENAMED.get(k, k) for k in keys}


def smoke(tmp_path) -> bs.Scale:
    return bs.Scale("smoke", CPU, str(tmp_path))


@pytest.mark.parametrize("name", list(bench.ENTRIES))
def test_entry_smoke(name, tmp_path):
    out = io.StringIO()
    (line,) = bench.run([name], smoke(tmp_path), out=out)
    printed = out.getvalue().splitlines()
    assert len(printed) == 1 and json.loads(printed[0]) == line
    assert "error" not in line, line.get("error")
    assert line["entry"] == name and isinstance(line["metric"], str) and line["unit"].startswith("Msamples/sec")
    assert math.isfinite(line["value"]) and line["value"] > 0
    assert line["device"] == "cpu" and line["scale"] == "smoke"
    missing = jax_fields(name) - set(line)
    assert not missing, f"{name} lacks the JAX fields {sorted(missing)}"
    for key in ("pct_f32_peak", "pct_hbm_peak"):
        if key in line:
            assert 0 <= line[key] <= 100
    if name in bs.KERNEL_ENTRIES:
        # the CPU takes the plain versions: nothing launched, the outputs
        # equal but for the scan check's f64 sums of the f32 norms
        assert line["launches"] == {} and line["max_err_over_scale"] <= 1e-6 and line["route"]


def test_entries_are_the_jax_suite():
    assert list(bench.ENTRIES)[0] == "headline"
    assert list(bs.SUITE) == list(jbs._SUITE)
    assert set(bs.KERNEL_ENTRIES) <= set(bench.ENTRIES)


@pytest.mark.parametrize("fn,args", [
    ("chain_flops_per_sample", [(400, 32, 64), (512, 64, 64), (4000, 32, 64), (40, 3, 8, False)]),
    ("stft_flops_per_sample", [(1024, 1024), (1024, 256), (4096, 1024), (4, 2)]),
    ("_combined", [(3000.0, 80.0, 10), (1.5, 2.5, 20), (123.4, 0.7, 400)]),
])
def test_models_equal_jax(fn, args):
    for a in args:
        assert getattr(bs, fn)(*a) == getattr(jbs, fn)(*a)


def _redirect_tmp(monkeypatch, module, directory: pathlib.Path) -> None:
    """Point the JAX bench's hard-coded ``/tmp`` captures at ``directory``."""

    def here(p):
        return str(directory / os.path.basename(p))

    fake = types.SimpleNamespace(
        path=types.SimpleNamespace(exists=lambda p: os.path.exists(here(p)), getsize=lambda p: os.path.getsize(here(p))),
        replace=lambda a, b: os.replace(here(a), here(b)),
    )
    monkeypatch.setattr(module, "os", fake)
    monkeypatch.setattr(module, "open", lambda p, mode="r": open(here(p), mode), raising=False)


@pytest.mark.parametrize("n", [(1 << 17) + 3, 1])
def test_sustained_capture_equals_jax(n, tmp_path, monkeypatch):
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    _redirect_tmp(monkeypatch, jbs, tmp_path / "jax")
    want = pathlib.Path(jbs._sustained_capture(n))
    got = pathlib.Path(bs._sustained_capture(n, str(tmp_path / "port")))
    assert got.parent == tmp_path / "port" and got.name == want.name
    assert (tmp_path / "jax" / want.name).read_bytes() == got.read_bytes()
    assert got.stat().st_size == 2 * n
    stamp = got.stat().st_mtime_ns
    bs._sustained_capture(n, str(tmp_path / "port"))  # kept: not written again
    assert got.stat().st_mtime_ns == stamp


def test_roofline_hand_computed():
    # 10^12 samples a second at 20 flops and 2.125 bytes a sample:
    # 20 TFLOP/s of 67, 2.125 TB/s of 3.35
    got = bs.roofline(1e6, 20.0, 2.125)
    assert got == pytest.approx({"gflops": 20_000.0, "pct_f32_peak": 100 * 20 / 67,
                                 "hbm_gbps": 2125.0, "pct_hbm_peak": 100 * 2.125 / 3.35})
    at_peak = bs.roofline(1e6, 67.0, 3.35)  # exactly the peaks: no error
    assert at_peak["pct_f32_peak"] == pytest.approx(100.0) and at_peak["pct_hbm_peak"] == pytest.approx(100.0)


@pytest.mark.parametrize("flops,nbytes,over", [(1e5, 1.0, "pct_f32_peak"), (1.0, 4e3, "pct_hbm_peak")])
def test_roofline_over_the_peak_is_an_error(flops, nbytes, over):
    with pytest.raises(ValueError, match=over):
        bs.roofline(1000.0, flops, nbytes)


def test_measure_msps_linearity():
    def step(i):
        time.sleep(0.002)

    stats: dict = {}
    msps = measure_msps(step, 1000, 0.1, stats_out=stats, device="cpu")
    assert set(stats) == {"linearity", "n1", "reps", "min", "max"}
    assert 2.5 <= stats["linearity"] <= 3.5 and stats["n1"] >= 4 and stats["reps"] == 2
    assert stats["min"] <= msps <= stats["max"]
    assert 0.1 < msps <= 0.5  # 1000 samples every 2 ms at most


def test_measure_msps_refuses_a_step_that_stops_working():
    def step(i):  # work that does not grow with the window: one wait a window
        if i == 0:
            time.sleep(0.01)

    with pytest.raises(RuntimeError, match="scaled linearly"):
        measure_msps(step, 1000, 0.5, device="cpu")


@pytest.mark.parametrize("cfg,chunk", [(bs.HEADLINE_CFG, 1 << 13), (bs.CS16_CFG, 1 << 13), (bs.LONG_FIR_CFG, 1 << 13)],
                         ids=["headline", "cs16", "long_fir"])
def test_chain_step_matches_jax(cfg, chunk):
    """``make_step``'s fused route against the JAX ``make_acc_step``'s
    programs on the same planes: ``step_stream_pallas`` (interpreted) under
    the same planned bases and the XLA chain under the same phases."""
    jcfg = JConfig(**{**cfg.__dict__, "fmt": JFormat(cfg.fmt.value)})
    jm = JModel(jcfg)
    raw = jm.synth_raw(chunk + cfg.taps, seed=3)
    step, route, want = bs.make_step(PipelineModel(cfg), chunk, torch.from_numpy(raw))
    assert want == ("frontend_fir",) and "fused frontend" in route
    thetas = jm.theta0(np.arange(16, dtype=np.int64) * chunk)
    for i in (0, 21):
        got = step(i).numpy()
        xla = np.asarray(jm.jit_step_stream(raw, np.float32(thetas[i % 16]), np.int32(raw.shape[1])))
        pallas = np.asarray(jm.jit_step_stream_pallas(raw, jm.stream_bases((i % 16) * chunk, chunk + cfg.taps)))
        scale = max(np.abs(xla).max(), 1e-6)
        for ref in (xla, pallas):
            assert got.shape == ref.shape
            np.testing.assert_allclose(got, ref, rtol=0, atol=TOL * scale)


def test_chain_entry_outside_the_fused_envelope(tmp_path):
    """Decimate 100 is outside the fused frontend: the entry takes
    ``step_stream`` and says so, and expects no kernel."""
    cfg = bs.PipelineConfig(sample_rate=21_000_000, shift_freq=280_000, lp_freq=100_000, decimate=100, taps=400,
                            fft_width=64, fmt=bs.FileFormat.COMPLEX_INT8)
    entry = bs.chain_entry(smoke(tmp_path), cfg, 1 << 14, "decimate 100", 2.0)
    assert entry["route"] == "chain of torch ops (step_stream)" and entry["launches"] == {}
    assert "max_err_over_scale" not in entry and entry["value"] > 0


def test_main_exits_1_when_an_entry_raises(tmp_path, monkeypatch, capsys):
    def broken(sc):
        raise RuntimeError("broken on purpose")

    monkeypatch.setenv("QUADRS_PLATFORM", "cpu")
    monkeypatch.setattr("tempfile.tempdir", str(tmp_path))
    monkeypatch.setitem(bench.ENTRIES, "bench_resample", broken)
    assert bench.main(["--entries", "bench_resample,bench_fsk"]) == 1
    lines = [json.loads(s) for s in capsys.readouterr().out.splitlines()]
    assert [line["entry"] for line in lines] == ["bench_resample", "bench_fsk"]
    assert lines[0]["error"] == "RuntimeError: broken on purpose" and "value" not in lines[0]
    assert "error" not in lines[1] and lines[1]["value"] > 0
    assert bench.main(["--entries", "bench_fsk"]) == 0
    with pytest.raises(SystemExit):
        bench.main(["--entries", "bench_nothing"])


def _run_module(code_or_args: list[str], env: dict) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, *code_or_args], cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=120)


def test_bench_without_a_card_refuses():
    env = {k: v for k, v in os.environ.items() if k != "QUADRS_PLATFORM"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    proc = _run_module(["-m", "quadrs_tpu_torch.bench", "--headline-only"], env)
    assert proc.returncode == 1
    assert "CUDA is not available" in proc.stderr and proc.stdout == ""


def test_bench_imports_no_jax():
    code = ("import sys, quadrs_tpu_torch.bench, quadrs_tpu_torch.bench_suite, quadrs_tpu_torch.utils.timing; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'quadrs_tpu')); "
            "print(bad); sys.exit(1 if bad else 0)")
    proc = _run_module(["-c", code], dict(os.environ))
    assert proc.returncode == 0, proc.stdout + proc.stderr
