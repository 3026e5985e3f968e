"""Where the time of quadrs_tpu_torch's ``stream`` path goes, on one CUDA card.

Run from the root of a checkout: ``python3 profile_stream.py``.  It writes
the same 2^26-sample cs8 capture as ``chip_smoke.py`` (21 Msps, D 32,
400 taps, W 64, 4M-sample chunks) to a temp directory, then:

1. times two warm ``StreamRunner.run`` passes with a file sink, the
   CLI's route (kernel 1 + ``stft_norms``), after one pass that builds
   the kernels, plans cuFFT and fills the page cache;
2. for each route of ``step_stream_fused`` (``fuse_stft`` False, the
   CLI's, and True, kernel 2) runs the runner's chunks one stage at a time,
   with a device sync between stages, and prints each stage's share:
   staging (file read + deinterleave), H2D, device, D2H, sink;
3. profiles one more warm ``StreamRunner.run`` with ``torch.profiler``
   and prints the wall time, the device's busy time (the union of its
   kernel and copy intervals) and idle share, and the busy time by kind.

Stage 2 runs without the runner's background staging, so its total is
longer than a run's wall time; it says what each stage costs, not how they
overlap.  Stage 3 says how they overlap.
"""

from __future__ import annotations

import os
import sys
import tempfile
import time

import numpy as np
import torch

import chip_smoke as cs


def sequential_breakdown(runner, sink, fuse_stft: bool) -> dict[str, float]:
    """Seconds per stage over the runner's chunks, one stage at a time."""
    model, dev = runner.model, runner.device
    t = dict(staging=0.0, h2d=0.0, device=0.0, d2h=0.0, sink=0.0)
    chunks = runner._chunks()
    while True:
        a = time.perf_counter()
        item = next(chunks, None)
        b = time.perf_counter()
        t["staging"] += b - a
        if item is None:
            return t
        off, planes, valid = item
        raw = torch.from_numpy(planes).to(dev)
        bases = torch.from_numpy(model.stream_bases(off, planes.shape[1])).to(dev)
        torch.cuda.synchronize(dev)
        c = time.perf_counter()
        nv = None if valid == planes.shape[1] else valid
        y = model.step_stream_fused(raw, bases, nv, fuse_stft=fuse_stft)
        torch.cuda.synchronize(dev)
        d = time.perf_counter()
        rows = y.cpu().numpy()
        e = time.perf_counter()
        sink(0, rows)
        t["h2d"] += c - b
        t["device"] += d - c
        t["d2h"] += e - d
        t["sink"] += time.perf_counter() - e


def device_busy(prof) -> tuple[float, dict[str, list]]:
    """(union of the device's event intervals in ms, {kind: [ms, count]})."""
    from torch.autograd import DeviceType

    spans, kinds = [], {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA or e.name.startswith("Activity Buffer"):
            continue
        spans.append((e.time_range.start, e.time_range.end))
        k = kinds.setdefault(e.name[:70], [0.0, 0])
        k[0] += (e.time_range.end - e.time_range.start) / 1e3
        k[1] += 1
    busy, end = 0.0, float("-inf")
    for lo, hi in sorted(spans):
        if hi > end:
            busy += hi - max(lo, end)
            end = hi
    return busy / 1e3, kinds


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_stream: CUDA is not available", file=sys.stderr)
        return 1
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
                out.write(np.ascontiguousarray(rows).tobytes())

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
            busy, kinds = device_busy(prof)
            print(f"profiled warm run: wall {wall:.2f} ms, {st.msps:.1f} Msps, device busy {busy:.2f} ms, "
                  f"idle share {100 * (1 - busy / wall):.1f}% ({card})")
            for k, (ms, n) in sorted(kinds.items(), key=lambda kv: -kv[1][0]):
                print(f"  {ms:9.3f} ms  {n:4d}x  {k}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
