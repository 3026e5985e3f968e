"""The live traffic on the CPU: the generator's schedule and its
write-start times, the latencies that read them, and the trimmed spread by
which a set of runs is read.

    QUADRS_PLATFORM=cpu python -m pytest sdrbench/test_sdrbench_live.py
"""

from __future__ import annotations

import fcntl
import json
import math
import os
import pathlib
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from sdrbench import arith, spec
from sdrbench import run as bench_run
from sdrbench.arith import percentile
from sdrbench.tiny import tiny_root
from sdrbench.traffic import live_gen, live_pipe

os.environ.setdefault("QUADRS_PLATFORM", "cpu")
CHECKOUT = pathlib.Path(__file__).resolve().parent.parent
NET = "latency_net_p95_ms.live"


def test_the_generator_writes_each_block_in_order_and_never_before_it_is_due(tmp_path):
    # seven 1 ms blocks of 40,000 bytes, the last a half, from a capture of
    # two and a half blocks looped
    rate, block, samples, period, pair = 20_000_000, 20_000, 130_000, 50_000, 2
    data = (np.arange(period * pair) * 7 % 256).astype(np.uint8)
    capture, started = tmp_path / "loop.cs8", tmp_path / "started.npy"
    data.tofile(capture)
    r, w = os.pipe()
    fcntl.fcntl(w, fcntl.F_SETPIPE_SZ, 1 << 16)
    room = fcntl.fcntl(r, fcntl.F_GETPIPE_SZ)
    gen = subprocess.Popen(
        [sys.executable, "-m", "sdrbench.traffic.live_gen", "--fd", str(w), "--capture", str(capture), "--rate",
         str(rate), "--samples", str(samples), "--block", str(block), "--pair", str(pair), "--started", str(started)],
        pass_fds=(w,), stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True, cwd=CHECKOUT,
        env={**os.environ, **live_gen.ENV})
    os.close(w)
    try:
        assert gen.stdout.readline().strip() == "ready"
        t0 = time.monotonic() + 0.05
        gen.stdin.write(f"{t0!r}\n")
        gen.stdin.flush()
        got, seen = bytearray(), []  # each read's bytes so far and when it returned
        paused = resumed = None  # the reader stops for 50 ms once it has three blocks
        while chunk := os.read(r, 1 << 16):
            got += chunk
            seen.append((len(got), time.monotonic()))
            if paused is None and len(got) >= 3 * block * pair:
                paused = len(got)
                time.sleep(0.05)
                resumed = time.monotonic()
        report = json.loads(gen.stdout.readline())
        assert gen.wait(30) == 0
    finally:
        os.close(r)
        if gen.poll() is None:
            gen.kill()
            gen.wait()
    n = -(-samples // block)
    dues = [t0 + min((b + 1) * block, samples) / rate for b in range(n)]
    # the samples in order, the capture looped
    want = np.tile(data, 3)[: samples * pair]
    assert bytes(got) == want.tobytes()
    # a block's first byte is read no sooner than the block is due
    for b in range(n):
        first_read = next(t for size, t in seen if size > b * block * pair)
        assert first_read >= dues[b], b
    assert report["blocks"] == n and report["broken_pipe"] is False
    assert 0 <= report["late_p95_ms"] <= report["late_max_ms"] and 0 < report["cpu_share"] <= 1.5
    starts = np.load(started)
    assert starts.shape == (n,) and np.all(np.isfinite(starts))
    assert np.all(starts >= np.asarray(dues)) and np.all(np.diff(starts) >= 0)
    # a write starts before its first byte can be read
    for b in range(n):
        assert starts[b] < next(t for size, t in seen if size > b * block * pair), b
    # the bytes past what the pipe holds beyond the pause could not go in
    # before the reader resumed: the first such write started while it was
    # paused and blocked, and its start, not its end, is recorded
    stuck = [b for b in range(n) if min((b + 1) * block, samples) * pair > paused + room]
    assert stuck and starts[stuck[0]] < resumed
    assert report["blocked_max_ms"] >= 1e3 * (resumed - starts[stuck[0]]) - 1.0


def _fake_run():
    # 4 chunks of 100 samples in blocks of 50 at 1000 samples a second; a
    # chunk's last sample read is 3 + 4 - 1 past its last decimation point
    return SimpleNamespace(kind="live", config={"chain": [{"stage": "lowpass", "power": 2, "decimate": 2}]},
                           state={"chunk": 100, "total": 400, "block": 50, "rate": 1000.0, "t0": 10.0})


def test_the_latencies_start_at_the_due_time_and_the_net_one_at_the_blocks_write():
    run = _fake_run()
    assert [live_pipe.last_block(run, k) for k in range(4)] == [2, 4, 6, 7]
    dues = [10.15, 10.25, 10.35, 10.40]
    assert [live_pipe.due(run, k) for k in range(4)] == pytest.approx(dues)
    # each write starts 0.1 ms past its block's due time
    started = 10.0 + 0.05 * np.arange(1, 9) + 0.0001
    started[4] += 0.030  # chunk 1's last block: the generator was 30 ms late
    # chunk 2's last block started on time and blocked 20 ms on a full
    # pipe: that wait is the program's and stays in its net latency;
    # chunk 3 never reached the sink
    stamps = {0: dues[0] + 0.005, 1: dues[1] + 0.035, 2: dues[2] + 0.025}
    lat, net = live_pipe.latencies(run, stamps, started)
    assert lat == pytest.approx([0.005, 0.035, 0.025])
    assert net == pytest.approx([0.0049, 0.0049, 0.0249])
    run.latencies, run.net_latencies = lat, net
    reader = spec.load_module("metrics", NET)
    assert reader.read(run) == pytest.approx(1e3 * percentile(net, 95))
    assert reader.read(run) < spec.load_module("metrics", "latency_p95_ms.live").read(run)
    assert reader.read(SimpleNamespace(kind="capture", net_latencies=net)) is None


def test_the_net_latency_is_found_by_name_and_read_in_a_traced_live_run(tmp_path):
    bench = spec.load_benchmark(CHECKOUT / "BENCHMARK.json")
    entry = next(m for m in bench["per_layer"] if m["name"] == NET)
    live_e2e = {m["name"] for m in spec.cell_metrics(bench, "fsk.live", False)}
    assert entry["workloads"] == ["fsk.live"] and entry["moves"] in live_e2e and entry["layer"] == "runner"
    assert NET in {m["name"] for m in spec.cell_metrics(bench, "fsk.live", True)}
    assert NET not in {m["name"] for m in spec.cell_metrics(bench, "cond.sparkfft_capture", True)}
    root = tiny_root(tmp_path / "cells")
    cell = spec.Cell("fsk.live", root=root, bench=bench)
    assert callable(cell.reader(NET).read)
    (tmp_path / "run").mkdir()
    result, lines = bench_run.run_cell(cell, 2**31 + 11, 0.5, True, torch.device("cpu"), str(tmp_path / "run"))
    assert result["correct"] is True
    assert math.isfinite(result["metrics"][NET]["value"]) and result["metrics"][NET]["unit"] == "ms"
    assert any(line.startswith("net latency ms p50/p95: ") for line in lines)


def test_the_live_cells_end_to_end_metric_is_its_host_cpu_a_chunk(tmp_path):
    bench = spec.load_benchmark(CHECKOUT / "BENCHMARK.json")
    assert [m["name"] for m in spec.cell_metrics(bench, "fsk.live", False)] == ["host_cpu_ms_per_chunk", "setup_s"]
    # every per-layer metric of the cell moves it, the p95 among them
    layer = spec.cell_metrics(bench, "fsk.live", True)
    assert "latency_p95_ms.live" in {m["name"] for m in layer}
    assert {m["moves"] for m in layer} == {"host_cpu_ms_per_chunk"}
    reader = spec.load_module("metrics", "host_cpu_ms_per_chunk")
    assert reader.read(SimpleNamespace(kind="live", chunks=1051, cpu_s=12.6)) == pytest.approx(1e3 * 12.6 / 1051)
    assert reader.read(SimpleNamespace(kind="live", chunks=0, cpu_s=0.0)) is None
    assert reader.read(SimpleNamespace(kind="capture", chunks=0, cpu_s=3.0)) is None
    # a run on the CPU reads the process's own CPU time over its window
    cell = spec.Cell("fsk.live", root=tiny_root(tmp_path / "cells"), bench=bench)
    (tmp_path / "run").mkdir()
    result, lines = bench_run.run_cell(cell, 2**31 + 13, 0.5, False, torch.device("cpu"), str(tmp_path / "run"))
    assert result["correct"] is True and set(result["metrics"]) == {"host_cpu_ms_per_chunk", "setup_s"}
    assert result["metrics"]["host_cpu_ms_per_chunk"]["value"] > 0
    assert any(" this process " in line for line in lines)


def test_a_sets_trimmed_spread_leaves_out_its_farthest_run():
    # a set of six live p95s (ms): the farthest run, 12.16, widens the quartiles
    v = [8.27, 7.52, 8.44, 12.16, 9.99, 9.43]
    assert arith.spread(v) == pytest.approx(0.27420, abs=1e-5)
    assert arith.trimmed_spread(v) == pytest.approx(0.21505, abs=1e-5)
    # where leaving it out does not narrow them, the whole set's spread stands
    w = [9, 10, 10, 10, 10, 11]
    assert arith.trimmed_spread(w) == arith.spread(w) == pytest.approx(0.05)
