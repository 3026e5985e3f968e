"""Run one benchmark cell once and print its result line.

    python3 -m sdrbench.run --workload CELL --seed N --seconds S --trace 0|1

From the checkout's root.  It needs CUDA and as many cards as the cell
asks for, or it exits 2 and prints no result.  It makes the cell's inputs
from ``--seed``, warms the cell's own shapes (set-up), measures for
``--seconds`` (a capture cell to the end of the first pass that ends after
them), reads the device's memory peak, frees the program's state, checks
the outputs against the plain reference, and prints:

* on standard error, as its last lines, each number the check compared
  beside its limit;
* on standard output, as its last line, one JSON object: ``correct``,
  ``attempted``, ``failed``, ``metrics`` (with ``--trace 0`` the cell's
  end-to-end metrics, with ``--trace 1`` its per-layer ones, each from
  ``metrics/<name>.py``), ``device``, with ``--trace 1`` ``breakdown``,
  and last ``checks``.

It exits 3 and prints no result if JAX, jaxlib, flax or the JAX package
was loaded by the end of the window.
"""

from __future__ import annotations

import time

T_IMPORT = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

from sdrbench import hoststat  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "quadrs_tpu")
CHECKOUT = pathlib.Path(__file__).resolve().parent.parent
CACHE = CHECKOUT / "build" / "sdrbench"


def process_start() -> float:
    """This process's start on the monotonic clock, from the kernel's
    record of it; the module's import time where that cannot be read."""
    try:
        with open("/proc/self/stat") as fh:
            ticks = int(fh.read().rsplit(")", 1)[1].split()[19])
        boot = time.clock_gettime(time.CLOCK_BOOTTIME) - time.monotonic()
        return ticks / os.sysconf("SC_CLK_TCK") - boot
    except (OSError, ValueError, IndexError, AttributeError):
        return T_IMPORT


def forbidden_modules(modules=None) -> list[str]:
    """Loaded modules whose top-level name, whole, is JAX's or the JAX
    package's (``quadrs_tpu_torch`` is not ``quadrs_tpu``)."""
    modules = sys.modules if modules is None else modules
    return sorted({m for m in list(modules) if m.split(".", 1)[0] in FORBIDDEN})


def set_environment() -> None:
    """Caches inside the checkout at fixed paths; keep libraries from
    loading JAX."""
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")


class Run:
    """One run of one cell: what the traffic driver sets up and measures,
    and what the metric readers read.  Times on ``time.monotonic``."""

    def __init__(self, cell, seed: int, seconds: float, trace: bool, device, tmp: str):
        self.cell = cell
        self.config = cell.config
        self.traffic = cell.traffic
        self.limits = cell.limits
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.trace = bool(trace)
        self.device = device
        self.tmp = tmp
        self.state: dict = {}
        self.processes: list = []
        self.notes: list[str] = []
        self.kind = ""
        self.t_process = process_start()
        self.t_start = math.nan
        self.t_end = math.nan
        self.attempted = 0
        self.failed = 0
        self.samples = 0
        self.passes = 0
        self.chunks = 0
        self.latencies: list[float] = []
        self.net_latencies: list[float] = []
        self.cpu_s = 0.0
        self.trace_out: dict = {}
        self.stages: dict = {}
        self.window_peak_bytes = 0
        self.setup_peak_bytes = 0
        self._prof = None
        self._profiled = None
        self._host = None

    @staticmethod
    def clock() -> float:
        return time.monotonic()

    @property
    def setup_s(self) -> float:
        return self.t_start - self.t_process

    @property
    def window_s(self) -> float:
        return self.t_end - self.t_start

    def inputs_made(self) -> None:
        """The harness's own inputs are made: the device's memory peak from
        here on is the program's (its set-up and its window)."""
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()

    def begin(self) -> None:
        """The window opens: reset the device's memory peak; in a traced
        run start the profiler and the program's stage accounting."""
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize()
            self.setup_peak_bytes = torch.cuda.max_memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        if self.trace:
            from torch.profiler import ProfilerActivity, profile

            from quadrs_tpu_torch.utils.profiling import PROFILER, profiled

            # on the card the device's activity and the CUDA calls that
            # launched it; the host's ops would multiply the events to read
            acts = [ProfilerActivity.CUDA] if self.device.type == "cuda" else [ProfilerActivity.CPU]
            PROFILER.reset()
            self._profiled = profiled()
            self._profiled.__enter__()
            self._prof = profile(activities=acts)
            self._prof.start()
        self._host = hoststat.sample()
        self.t_start = self.clock()

    def end(self) -> None:
        """The window closes once the device has finished its work."""
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize()
        self.t_end = self.clock()
        host = hoststat.sample()
        self.cpu_s = host["own_cpu_s"] - self._host["own_cpu_s"]
        self.notes.append(hoststat.describe(self._host, host))
        if self.device.type == "cuda":
            self.window_peak_bytes = torch.cuda.max_memory_allocated()
        if self._prof is not None:
            from quadrs_tpu_torch.utils.profiling import PROFILER

            from sdrbench import devtrace

            t = self.clock()
            self._prof.stop()
            self._profiled.__exit__(None, None, None)
            self.stages = {k: (v.samples, v.steps, v.seconds) for k, v in PROFILER.stages.items()}
            t_read = self.clock()
            self.trace_out = devtrace.read(self._prof)
            self.notes.append(f"trace: stopped in {t_read - t:.1f} s, read in {self.clock() - t_read:.1f} s")
            self._prof = None


def _result(run: Run, names: list[dict], checks, device: dict) -> dict:
    metrics = {}
    for m in names:
        value = run.cell.reader(m["name"]).read(run)
        if value is not None and math.isfinite(value):
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    correct = bool(checks) and all(v <= lim for _, v, lim in checks)
    out = {"correct": correct, "attempted": run.attempted, "failed": run.failed, "metrics": metrics, "device": device}
    if run.trace and run.trace_out.get("device_ops") is not None:
        out["breakdown"] = {"device_ops": run.trace_out["device_ops"], "idle_gaps": run.trace_out["idle_gaps"]}
    # JSON has no infinity: a number that could not be read is null
    out["checks"] = {name: {"value": v if math.isfinite(v) else None, "limit": lim} for name, v, lim in checks}
    return out


def _card() -> tuple[str, str]:
    import subprocess

    import torch

    name = torch.cuda.get_device_name(0)
    try:
        limit = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader", "-i", "0"],
                               capture_output=True, text=True, timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        limit = "unknown"
    return name, limit or "unknown"


def run_cell(cell, seed: int, seconds: float, trace: bool, device, tmp: str) -> tuple[dict, list[str]]:
    """Set up, measure and check one cell on ``device``; returns the
    result and the check's lines.  The caller has made sure of the card."""
    import torch

    run = Run(cell, seed, seconds, trace, device, tmp)
    drv = cell.driver
    try:
        drv.setup(run)
        drv.window(run)
        found = forbidden_modules()
        if found:
            raise ForbiddenImport(found)
        cuda = device.type == "cuda"
        dev = {"platform": "gpu" if cuda else "cpu", "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
               "count": cell.chips if cuda else 0,
               "memory_peak_bytes": int(max(run.setup_peak_bytes, run.window_peak_bytes))}
        if trace:
            dev["busy_s"] = float(run.trace_out.get("busy_s", 0.0))
            dev["window_s"] = float(run.window_s)
        names = cell.metrics(trace)
        drv.release(run)
        if cuda:
            torch.cuda.empty_cache()
        checks = drv.check(run)
    finally:
        for p in run.processes:
            if p.poll() is None:
                p.kill()
            p.wait()
    lines = list(run.notes) + [f"check {n}: {v!r} (limit {lim!r})" for n, v, lim in checks]
    return _result(run, names, checks, dev), lines


class ForbiddenImport(RuntimeError):
    def __init__(self, found):
        super().__init__("loaded by the end of the window: " + ", ".join(found))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m sdrbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)

    set_environment()
    from sdrbench import spec

    cell = spec.Cell(a.workload, bench=spec.load_benchmark())
    import torch

    if not torch.cuda.is_available():
        print("sdrbench: CUDA is not available (torch.cuda.is_available() is False): no result", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"sdrbench: {cell.name} needs {cell.chips} cards, {torch.cuda.device_count()} present: no result",
              file=sys.stderr)
        return 2
    name, limit = _card()
    tmp = tempfile.mkdtemp(prefix="sdrbench-")
    try:
        result, lines = run_cell(cell, a.seed, a.seconds, bool(a.trace), torch.device("cuda", 0), tmp)
    except ForbiddenImport as e:
        print(f"sdrbench: {e}", file=sys.stderr)
        return 3
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    found = forbidden_modules()
    if found:
        print(f"sdrbench: {ForbiddenImport(found)}", file=sys.stderr)
        return 3
    print(f"sdrbench: {cell.name} seed {a.seed} on {name}, power limit {limit}", file=sys.stderr)
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
