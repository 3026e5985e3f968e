"""Where the time of quadrs_tpu_torch's ``stream`` and waterfall-bank
paths goes, on one CUDA card.

Run from the root of a checkout: ``python3 profile_stream.py``.  It writes
the same 2^26-sample cs8 capture as ``chip_smoke.py`` (21 Msps, D 32,
400 taps, W 64, 4M-sample chunks) to a temp directory, then:

1. times two warm ``StreamRunner.run`` passes with a file sink, the
   CLI's route (kernel 1 + ``stft_norms``), after one pass that builds
   the kernels and the loader, plans cuFFT and fills the page cache;
2. for each route of ``step_stream_fused`` (``fuse_stft`` False, the
   CLI's, and True, kernel 2) runs the runner's chunks one stage at a time,
   with a device sync between stages, and prints each stage's share:
   staging (the loader's ring prefetcher into a page-locked slot), H2D
   (the slot's copy on the copy stream), device, D2H (into page-locked
   memory), sink;
3. profiles one more warm ``StreamRunner.run`` with ``torch.profiler``
   and prints the wall time, the device's busy time (the union of its
   kernel and copy intervals) and idle share, how long copies and kernels
   ran at once (the copy stream's overlap), and the busy time by kind;
4. the same warm runs and profile for the live path: the capture through
   ``replay -speed 0`` in another process, read by a ``PipeSource``.

``python3 profile_stream.py mesh`` profiles the mesh runs alone
(:func:`profile_mesh`): the stream on a 4x1 mesh and the bank on a 2x2
mesh of the repeated card, each beside its single-device run.

Stage 2 runs the runner's own staging generator and ring one stage at a
time, so its total is longer than a run's wall time; it says what each
stage costs, not how they overlap.  Stage 3 says how they overlap.

Then the same three stages for the reference chain's ``from CAP shift
280k lowpass -power 200 -decimate 32 200k sparkfft -width 64 -stride 16``
over the same capture (its Executor batches of 16384 windows; staging
includes the host's planning, the sink is the glyph strings and their
lines), and for the waterfall bank over ``chip_smoke.py``'s 64 cs8
captures of 2^21 samples (1024 points, 2000-window chunks), for the CLI's
three runs: ``waterfall`` (stride 1024, its sink the CLI's per-stream peak
tracking and norms files), ``waterfall -stride 256 -search`` (the CLI's
CSV lines) and ``scan -stride 256`` (the host's f64 totals).
"""

from __future__ import annotations

import os
import sys
import tempfile
import time

import numpy as np
import torch

import chip_smoke as cs


def stage_breakdown(ring, staged, step, sink, dev) -> dict[str, float]:
    """Seconds per stage over a runner's chunks, one stage at a time:
    staging (``staged``, the runner's own generator, fills a slot of
    ``ring``), H2D (the slot's upload, awaited), device (``step(first
    window, buffers)``), D2H (into page-locked memory, awaited), sink."""
    from quadrs_tpu_torch.staging import Download

    t = dict(staging=0.0, h2d=0.0, device=0.0, d2h=0.0, sink=0.0)
    ring.reset()
    try:
        while True:
            a = time.perf_counter()
            item = next(staged, None)
            b = time.perf_counter()
            t["staging"] += b - a
            if item is None:
                return t
            k, w0, shapes, _ = item
            bufs = ring.upload(k, **shapes)
            torch.cuda.synchronize(dev)
            c = time.perf_counter()
            out = step(w0, bufs)
            ring.consumed(k)
            torch.cuda.synchronize(dev)
            d = time.perf_counter()
            host = Download(out).wait()
            e = time.perf_counter()
            sink(w0, host)
            ring.recycle(k)
            t["h2d"] += c - b
            t["device"] += d - c
            t["d2h"] += e - d
            t["sink"] += time.perf_counter() - e
    finally:
        staged.close()


def sequential_breakdown(runner, sink, fuse_stft: bool) -> dict[str, float]:
    """Stage seconds over the stream runner's chunks."""
    from quadrs_tpu_torch.staging import UploadRing

    model = runner.model
    ring = UploadRing(runner.device, 3, **runner._slot_buffers())

    def step(at, bufs):
        off, cols, valid = at
        raw = bufs["planes"][:, :cols]
        return model.step_stream_fused(raw, bufs["bases"], None if valid == cols else valid, fuse_stft=fuse_stft)

    return stage_breakdown(ring, runner._staged(ring, 0, lambda cols: None), step, lambda at, rows: sink(0, rows), runner.device)


def bank_breakdown(runner, step, sink) -> dict[str, float]:
    """Stage seconds over the bank runner's chunks."""
    runner.run(max_chunks=1)  # makes the runner's ring
    ring = runner._ring
    staged = runner._staged(ring, 0, None, lambda n_w, new: None)
    return stage_breakdown(ring, staged, lambda w, bufs: step(bufs["planes"]), sink, runner.device)


def bank_sinks(tmp: str, n_streams: int):
    """The CLI's per-chunk host work for each bank run (serve.py):
    peak tracking and one norms file per stream; CSV peak lines; the f64
    survey totals."""
    from quadrs_tpu_torch.serve import _PeakTracker
    from quadrs_tpu_torch.stream_runner import _ScanTotals

    files = [open(os.path.join(tmp, f"p.s{s}.norms.f32"), "wb") for s in range(n_streams)]
    csv = open(os.path.join(tmp, "p.peaks.csv"), "w")
    tracker = _PeakTracker(n_streams)

    def on_norms(w0, norms):
        for s in range(norms.shape[0]):
            tracker.update(s, w0, np.argmax(norms[s], axis=-1), np.max(norms[s], axis=-1))
            files[s].write(np.ascontiguousarray(norms[s]))

    def on_peaks(w0, out):
        idx, val = out
        for s in range(idx.shape[0]):
            tracker.update(s, w0, idx[s], val[s])
            for i in range(idx.shape[1]):
                csv.write(f"{s},{w0 + i},{int(idx[s, i])},{float(val[s, i]):.9g}\n")

    def close():
        for f in [*files, csv]:
            f.close()

    return {"norms": on_norms, "search": on_peaks, "scan": _ScanTotals(n_streams, 1024).add}, close


def profile_bank(card: str) -> None:
    from torch.profiler import ProfilerActivity, profile

    from quadrs_tpu_torch.formats import FileFormat
    from quadrs_tpu_torch.models.waterfall import WaterfallConfig, WaterfallModel
    from quadrs_tpu_torch.sources import open_capture
    from quadrs_tpu_torch.stream_runner import WaterfallRunner

    with tempfile.TemporaryDirectory() as tmp:
        files = cs.write_bank(tmp, cs.BANK_STREAMS, cs.BANK_SAMPLES)
        sources = [open_capture(f) for f in files]
        sinks, close = bank_sinks(tmp, cs.BANK_STREAMS)
        try:
            for name, stride in (("norms", 1024), ("search", 256), ("scan", 256)):
                cfg = WaterfallConfig(n_streams=cs.BANK_STREAMS, fft_width=1024, stride=stride,
                                      fmt=FileFormat.COMPLEX_INT8)
                model = WaterfallModel(cfg)
                runner = WaterfallRunner(sources, model, cs.DEVICE, chunk_windows=cs.BANK_CHUNK)
                step = {"norms": model.step, "search": model.search,
                        "scan": lambda raw: model.scan(raw, 20.0)}[name]
                run = {"norms": runner.run, "search": runner.run_search,
                       "scan": lambda sink: runner.run_scan(20.0)}[name]
                run(sinks[name])  # warm-up: page cache, allocator
                st = run(sinks[name])
                st = st.stats if hasattr(st, "stats") else st
                print(f"bank {name}, stride {stride}: warm run {st.samples_in} samples, {st.seconds * 1e3:.2f} ms, "
                      f"{st.msps:.1f} Msps ({card})")
                t = bank_breakdown(runner, step, sinks[name])
                total = sum(t.values())
                print(f"  sequential breakdown, total {total * 1e3:.2f} ms: "
                      + ", ".join(f"{k} {v * 1e3:.2f} ms ({100 * v / total:.1f}%)" for k, v in t.items()))
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    t0 = time.perf_counter()
                    st = run(sinks[name])
                    wall = (time.perf_counter() - t0) * 1e3
                busy, kinds, both = device_busy(prof)
                print(f"  profiled warm run: wall {wall:.2f} ms, device busy {busy:.2f} ms, "
                      f"idle share {100 * (1 - busy / wall):.1f}%, copies and kernels at once {both:.2f} ms ({card})")
                for k, (ms, n) in sorted(kinds.items(), key=lambda kv: -kv[1][0])[:6]:
                    print(f"    {ms:9.3f} ms  {n:4d}x  {k}")
        finally:
            close()


def profile_chain(card: str, path: str) -> None:
    """The reference chain's sparkfft over the capture at ``path``: two
    warm runs, the stage breakdown of its Executor batches, a profiled
    warm run."""
    import io

    from torch.profiler import ProfilerActivity, profile

    from quadrs_tpu_torch import sinks
    from quadrs_tpu_torch.ops.stft import stft_norms
    from quadrs_tpu_torch.runtime import Executor, _to_device, root_step_of, window_batches
    from quadrs_tpu_torch.sources import open_capture
    from quadrs_tpu_torch.stream import LowPass, Shift

    stream = LowPass(Shift(open_capture(path), 280_000), 200_000, 32, 400)
    src, width, stride = stream.root(), 64, 16
    out = io.StringIO()

    def run() -> float:
        out.seek(0)
        out.truncate()
        t0 = time.perf_counter()
        sinks.spark_fft(stream, width, stride, out=lambda block: print(block, file=out), device=cs.DEVICE, batched=True)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    run()  # warm-up: page cache, cuFFT plans, allocator
    for rep in range(2):
        wall = run()
        print(f"chain sparkfft warm run {rep}: {wall * 1e3:.2f} ms, {src.length / wall / 1e6:.1f} Msps ({card})")
    offsets = np.arange(0, stream.length - width, stride, dtype=np.int64)
    _, batches = window_batches(offsets, width, root_step=root_step_of(stream))

    # the executor's stages, one at a time: the root span through the loader into its
    # page-locked slot (with the host's planning), the slot's copy, the batch, its
    # output into page-locked memory, the glyph rows and their one write
    from quadrs_tpu_torch.staging import Download

    ex = Executor(stream, width, cs.DEVICE, post=stft_norms)
    t = dict(staging=0.0, h2d=0.0, device=0.0, d2h=0.0, sink=0.0)
    for offs in batches:
        a = time.perf_counter()
        lo = stream.span(int(offs.min()), width)[0]
        s_off, s_n = stream.span(int(offs.max()), width)
        buf = ex._stage(lo, s_off + s_n)  # fills a slot, enqueues its copy
        plan = stream.plan(offs, width, lo)
        b = time.perf_counter()
        ctx = {"buf": buf, "device": cs.DEVICE}
        prep = _to_device(plan.prep, cs.DEVICE)
        torch.cuda.synchronize()
        c = time.perf_counter()
        norms = stft_norms(stream.read_batch(ctx, prep, width))
        torch.cuda.synchronize()
        d = time.perf_counter()
        rows = Download(norms).wait()
        e = time.perf_counter()
        print(sinks.glyph_lines(rows, sinks.DEFAULT_SPARK_MIN, sinks.DEFAULT_SPARK_MAX), file=out)
        t["staging"] += b - a
        t["h2d"] += c - b
        t["device"] += d - c
        t["d2h"] += e - d
        t["sink"] += time.perf_counter() - e
    total = sum(t.values())
    print(f"  sequential breakdown, {len(batches)} batches, total {total * 1e3:.2f} ms: "
          + ", ".join(f"{k} {v * 1e3:.2f} ms ({100 * v / total:.1f}%)" for k, v in t.items()) + f" ({card})")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall = run() * 1e3
    busy, kinds, both = device_busy(prof)
    print(f"  profiled warm run: wall {wall:.2f} ms, device busy {busy:.2f} ms, idle share "
          f"{100 * (1 - busy / wall):.1f}%, copies and kernels at once {both:.2f} ms ({card})")
    for k, (ms, n) in sorted(kinds.items(), key=lambda kv: -kv[1][0])[:8]:
        print(f"    {ms:9.3f} ms  {n:4d}x  {k}")


def _union(spans) -> list[tuple[float, float]]:
    out: list[tuple[float, float]] = []
    for lo, hi in sorted(spans):
        if out and lo <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], hi))
        else:
            out.append((lo, hi))
    return out


def device_busy(prof) -> tuple[float, dict[str, list], float]:
    """(union of the device's event intervals in ms, {kind: [ms, count]},
    ms during which a copy and a kernel ran at once: what the copy stream
    hides behind the compute stream)."""
    from torch.autograd import DeviceType

    copies, kernels, kinds = [], [], {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA or e.name.startswith("Activity Buffer"):
            continue
        (copies if e.name.startswith(("Memcpy", "Memset")) else kernels).append((e.time_range.start, e.time_range.end))
        k = kinds.setdefault(e.name[:70], [0.0, 0])
        k[0] += (e.time_range.end - e.time_range.start) / 1e3
        k[1] += 1
    busy = sum(hi - lo for lo, hi in _union(copies + kernels))
    both, cu, ku = 0.0, _union(copies), _union(kernels)
    i = j = 0
    while i < len(cu) and j < len(ku):
        both += max(0.0, min(cu[i][1], ku[j][1]) - max(cu[i][0], ku[j][0]))
        if cu[i][1] < ku[j][1]:
            i += 1
        else:
            j += 1
    return busy / 1e3, kinds, both / 1e3


def profile_pipe(card: str, path: str, cfg, sink) -> None:
    """The live path: two warm runs and a profiled one of ``StreamRunner``
    over a ``PipeSource`` that reads ``replay -speed 0`` of the capture from
    another process (each run a new producer, started before the clock)."""
    import subprocess

    from torch.profiler import ProfilerActivity, profile

    from quadrs_tpu_torch.models.receiver import PipelineModel
    from quadrs_tpu_torch.sources import PipeSource
    from quadrs_tpu_torch.stream_runner import StreamRunner

    model = PipelineModel(cfg)

    def run():
        env = dict(os.environ, QUADRS_PLATFORM="cpu")  # replay moves bytes: no device work
        producer = subprocess.Popen([sys.executable, "-m", "quadrs_tpu_torch", "replay", "-speed", "0", path],
                                    stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, env=env)
        try:
            producer.stdout.peek(1)  # the producer is up
            return StreamRunner(PipeSource(producer.stdout, cfg.fmt, cs.SAMPLE_RATE), model, cs.DEVICE,
                                chunk_samples=cs.CHUNK).run(sink)
        finally:
            producer.stdout.close()
            producer.wait(timeout=120)

    run()
    for rep in range(2):
        st = run()
        print(f"pipe (replay | stream -stdin) warm run {rep}: {st.samples_in} samples, {st.seconds * 1e3:.2f} ms, "
              f"{st.msps:.1f} Msps ({card})")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        st = run()
    busy, _, both = device_busy(prof)
    wall = st.seconds * 1e3
    print(f"  profiled warm run: wall {wall:.2f} ms, device busy {busy:.2f} ms, idle share {100 * (1 - busy / wall):.1f}%, "
          f"copies and kernels at once {both:.2f} ms ({card})")


def host_split(run) -> tuple[float, dict[str, float]]:
    """One call of ``run()`` (a runner's run, whose outputs its sink
    drops) timed by host step: (wall ms, {step: ms}).  The consumer's
    steps: awaiting the staging thread's next chunk, the uploads, the
    launches (the runner's ``step``), the downloads started and awaited,
    the sink.  The staging thread's: its time producing chunks, of which
    waiting for a free slot and for its pool of reader threads; the file
    reads (summed over the reader threads, or the loader's prefetcher as
    the staging thread waits on it) and the NCO bases' planning."""
    import threading
    from unittest import mock

    from quadrs_tpu_torch import stream_runner as sr
    from quadrs_tpu_torch.models.receiver import PipelineModel
    from quadrs_tpu_torch.native.loader import NativeCapture
    from quadrs_tpu_torch.sources import SampleSource
    from quadrs_tpu_torch.staging import UploadRing

    ms: dict[str, float] = {}
    lock = threading.Lock()

    def add(key, seconds):
        with lock:
            ms[key] = ms.get(key, 0.0) + seconds * 1e3

    def timed(fn, key):
        def call(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                add(key, time.perf_counter() - t0)

        return call

    def timed_gen(gen, key):
        try:
            while True:
                t0 = time.perf_counter()
                try:
                    item = next(gen)
                except StopIteration:
                    return
                finally:
                    add(key, time.perf_counter() - t0)
                yield item
        finally:
            gen.close()

    background, pipelined, prefetch = sr._background, sr._pipelined, NativeCapture.prefetch

    class Pool(sr.ThreadPoolExecutor):
        def map(self, fn, *iterables, **k):
            return list(timed(super().map, "reader pool")(fn, *iterables, **k))

    class Download(sr.Download):
        __init__ = timed(sr.Download.__init__, "downloads started")
        wait = timed(sr.Download.wait, "downloads awaited")

    def pipelined_timed(ring, staged, step, emit, devices, max_chunks):
        return pipelined(ring, staged, timed(step, "launches"), None if emit is None else timed(emit, "sink"),
                         devices, max_chunks)

    with mock.patch.object(sr, "_background", lambda gen, depth=2: timed_gen(
            background(timed_gen(gen, "staging thread"), depth), "awaiting staged chunks")), \
            mock.patch.object(sr, "_pipelined", pipelined_timed), mock.patch.object(sr, "Download", Download), \
            mock.patch.object(sr, "ThreadPoolExecutor", Pool), \
            mock.patch.object(UploadRing, "upload", timed(UploadRing.upload, "uploads")), \
            mock.patch.object(UploadRing, "take", timed(UploadRing.take, "slot waits")), \
            mock.patch.object(SampleSource, "stage", timed(SampleSource.stage, "reads")), \
            mock.patch.object(NativeCapture, "prefetch", lambda self, *a, **k: timed_gen(prefetch(self, *a, **k), "reads")), \
            mock.patch.object(PipelineModel, "stream_bases", timed(PipelineModel.stream_bases, "bases")):
        t0 = time.perf_counter()
        run()
        wall = (time.perf_counter() - t0) * 1e3
    return wall, ms


def profile_mesh(card: str) -> None:
    """The mesh runs of ``chip_smoke.py``'s phase 4 against their
    single-device runs, warm: the stream (2^24 samples, 4M-sample chunks)
    on a 4x1 mesh of the repeated card, the bank (8 captures of 2^21, 2000
    windows a chunk) at strides 1024 and 256 on a 2x2 mesh; each run's
    wall, the device's busy time under ``torch.profiler``, one run split
    by host step (:func:`host_split`), and the host functions that took
    the most of the run under ``cProfile`` (its own time, callees
    excluded; the consumer's thread only).  The sinks drop each output,
    as the CLI's file sinks do once written."""
    import cProfile
    import pstats

    from torch.profiler import ProfilerActivity, profile

    from quadrs_tpu_torch.formats import FileFormat
    from quadrs_tpu_torch.models.receiver import PipelineModel
    from quadrs_tpu_torch.models.waterfall import WaterfallConfig, WaterfallModel
    from quadrs_tpu_torch.parallel.sharding import make_mesh
    from quadrs_tpu_torch.sources import open_capture
    from quadrs_tpu_torch.stream_runner import StreamRunner, WaterfallRunner

    card0 = torch.device("cuda", 0)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "mesh.sr21M.cs8")
        cs.write_capture(path, cs.MESH_SAMPLES)
        files = cs.write_bank(tmp, cs.MESH_BANK, cs.BANK_SAMPLES)
        model = PipelineModel(cs.bench_cfg(FileFormat.COMPLEX_INT8))
        runs = {}
        for name, mesh in (("single", None), ("4x1", make_mesh(4, 1, devices=[card0] * 4))):
            runs[f"stream {name}"] = StreamRunner(open_capture(path), model, cs.DEVICE, chunk_samples=cs.CHUNK, mesh=mesh)
        for stride in (1024, 256):
            bank = WaterfallModel(WaterfallConfig(n_streams=cs.MESH_BANK, fft_width=1024, stride=stride))
            for name, mesh in (("single", None), ("2x2", make_mesh(2, 2, devices=[card0] * 4))):
                runs[f"bank -stride {stride} {name}"] = WaterfallRunner(
                    [open_capture(f) for f in files], bank, cs.DEVICE, chunk_windows=cs.BANK_CHUNK, mesh=mesh)
        def sink(w0, out):
            pass

        for name, runner in runs.items():
            runner.run(sink)  # warm-up: rings, tables, kernels
            walls = []
            for _ in range(3):
                t0 = time.perf_counter()
                runner.run(sink)
                walls.append((time.perf_counter() - t0) * 1e3)
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                runner.run(sink)
                wall = (time.perf_counter() - t0) * 1e3
            busy = device_busy(prof)[0]
            split_wall, split = host_split(lambda: runner.run(sink))
            host = cProfile.Profile()
            host.runcall(runner.run, sink)
            top = pstats.Stats(host).sort_stats("tottime")
            funcs = sorted(top.stats.items(), key=lambda kv: -kv[1][2])[:6]
            print(f"{name}: warm walls {', '.join(f'{w:.2f}' for w in walls)} ms; profiled {wall:.2f} ms, device busy "
                  f"{busy:.2f} ms ({100 * busy / wall:.1f}%) ({card})")
            print(f"  host split ({split_wall:.2f} ms): " + ", ".join(f"{k} {v:.2f}" for k, v in split.items()) + " ms")
            for (file, line, fn), (_, calls, tottime, *_rest) in funcs:
                print(f"  {tottime * 1e3:9.2f} ms  {calls:6d}x  {os.path.basename(file)}:{line} {fn}")


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_stream: CUDA is not available", file=sys.stderr)
        return 1
    if sys.argv[1:] == ["mesh"]:
        profile_mesh(cs.card_line())
        return 0
    from torch.profiler import ProfilerActivity, profile

    from quadrs_tpu_torch.formats import FileFormat
    from quadrs_tpu_torch.models.receiver import PipelineModel
    from quadrs_tpu_torch.sources import open_capture
    from quadrs_tpu_torch.stream_runner import StreamRunner

    card = cs.card_line()
    cfg = cs.bench_cfg(FileFormat.COMPLEX_INT8)
    print(f"card {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "profile.sr21M.cs8")
        cs.write_capture(path, cs.CAPTURE_SAMPLES)
        with open(os.path.join(tmp, "norms.f32"), "wb") as out:

            def sink(w0, rows):
                out.write(np.ascontiguousarray(rows))

            runner = StreamRunner(open_capture(path), PipelineModel(cfg), cs.DEVICE, chunk_samples=cs.CHUNK)
            chunks = cs.n_chunks(runner.source.length, cfg)
            runner.run(sink)  # warm-up
            for rep in range(2):
                st = runner.run(sink)
                print(f"warm run {rep}: {st.samples_in} samples, {st.seconds * 1e3:.2f} ms, {st.msps:.1f} Msps ({card})")
            for fuse in (False, True):
                sequential_breakdown(runner, sink, fuse)  # warm-up of this route
                t = sequential_breakdown(runner, sink, fuse)
                total = sum(t.values())
                print(f"sequential breakdown, fuse_stft={fuse}, {chunks} chunks, total {total * 1e3:.2f} ms: "
                      + ", ".join(f"{k} {v * 1e3:.2f} ms ({100 * v / total:.1f}%)" for k, v in t.items())
                      + f" ({card})")
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                st = runner.run(sink)
                wall = (time.perf_counter() - t0) * 1e3
            busy, kinds, both = device_busy(prof)
            print(f"profiled warm run: wall {wall:.2f} ms, {st.msps:.1f} Msps, device busy {busy:.2f} ms, "
                  f"idle share {100 * (1 - busy / wall):.1f}%, copies and kernels at once {both:.2f} ms ({card})")
            for k, (ms, n) in sorted(kinds.items(), key=lambda kv: -kv[1][0]):
                print(f"  {ms:9.3f} ms  {n:4d}x  {k}")
            profile_pipe(card, path, cfg, sink)
        profile_chain(card, path)
    profile_bank(card)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
