"""Open-loop live traffic: a generator process (:mod:`.live_gen`) writes a
seeded, looped cs8 capture into a pipe in blocks at the source's rate, and
the program reads it as ``stream -stdin yes -sr R -format F -shift ...
-chunk C`` does (``serve.run_stream``): a ``PipeSource`` over the pipe, a
``StreamRunner`` over a ``PipelineModel``, ``run(emit)``.  ``emit`` stamps
each chunk's output, takes each window's argmax and max as the command's
peak tracker does, and keeps every chunk's norms for the check.

A chunk's latency runs from the due time of the block that holds the last
sample the chunk reads (its FIR lookahead included; the end of the stream
for the last chunk) to its output reaching ``emit``.  Its net latency, the
part the program controls, runs from the later of that due time and the
start of the generator's write of that block: a generator that was late
is left out, a write that blocked on a pipe the program left full is not.
The stream is a whole number of chunks; a chunk whose output never reaches
``emit`` counts as failed.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading

import numpy as np
import torch

from sdrbench import capture as synth
from sdrbench.reference import chain as ref
from sdrbench.traffic.live_gen import ENV as GEN_ENV

PIPE_BYTES = 1 << 20
BLOCK_WINDOWS = 4096  # windows the reference computes at once


def whole_windows(cfg: dict, chunk: int) -> int:
    """A ``-chunk`` in samples, rounded down to whole STFT windows of the
    decimated stream, as the ``stream`` command documents its chunks."""
    lp = next(s for s in cfg["chain"] if s["stage"] == "lowpass")
    win = int(lp["decimate"]) * int(cfg["sink"]["width"])
    return max(win, int(chunk) // win * win)


def stream_reference(cfg: dict, cap: ref.Capture, windows: np.ndarray, prec: str = "f64") -> np.ndarray:
    """The reference's ``stream`` rows ``windows``, in blocks."""
    out = []
    idx = torch.as_tensor(windows, dtype=torch.int64, device=cap.data.device)
    for lo in range(0, len(windows), BLOCK_WINDOWS):
        out.append(ref.stream_norms(cfg, cap, idx[lo : lo + BLOCK_WINDOWS], prec).cpu().numpy())
    return np.concatenate(out) if out else np.zeros((0, cfg["sink"]["width"]))


def _config(run):
    from quadrs_tpu_torch.formats import FileFormat
    from quadrs_tpu_torch.models.receiver import PipelineConfig

    cfg = run.config
    st = {s["stage"]: s for s in cfg["chain"]}
    if set(st) != {"shift", "lowpass"}:
        raise ValueError("the live stream runs shift and lowpass only")
    return PipelineConfig(
        sample_rate=int(cfg["sample_rate"]),
        shift_freq=int(st["shift"]["freq"]),
        lp_freq=int(st["lowpass"]["freq"]),
        decimate=int(st["lowpass"]["decimate"]),
        taps=2 * int(st["lowpass"]["power"]),
        fft_width=int(cfg["sink"]["width"]),
        fmt=FileFormat(cfg["format"]),
    )


def _runner(run, fileobj):
    from quadrs_tpu_torch.models.receiver import PipelineModel
    from quadrs_tpu_torch.sources import PipeSource
    from quadrs_tpu_torch.stream_runner import StreamRunner

    pcfg = _config(run)
    src = PipeSource(fileobj, pcfg.fmt, pcfg.sample_rate)
    return StreamRunner(src, PipelineModel(pcfg), run.device, chunk_samples=int(run.traffic["chunk"]), mesh=None)


def _pipe() -> tuple[int, int]:
    r, w = os.pipe()
    try:
        import fcntl

        fcntl.fcntl(w, fcntl.F_SETPIPE_SZ, PIPE_BYTES)
    except OSError:
        pass  # the system's cap on pipe sizes: the default works
    return r, w


def setup(run) -> None:
    cfg, tr = run.config, run.traffic
    rate = int(cfg["sample_rate"])
    chunk = whole_windows(cfg, tr["chunk"])
    n_chunks = max(2, round(run.seconds * rate / chunk))
    data = synth.synthesize(cfg["signal"], cfg["sample_rate"], int(tr["loop_samples"]), run.seed, run.device)
    path = os.path.join(run.tmp, f"loop.{cfg['format']}")
    synth.write(data, path)
    pair = 2  # bytes a cs8 sample
    warm = data[: pair * (int(tr["warm_chunks"]) * chunk + chunk // 2)].cpu().numpy().tobytes()
    del data
    run.inputs_made()
    run.state.update(path=path, rate=rate, chunk=chunk, n_chunks=n_chunks, total=n_chunks * chunk)

    # warm-up: the same path over a few chunks from a pipe fed by a thread
    r, w = _pipe()
    feeder = threading.Thread(target=_feed, args=(w, warm), daemon=True)
    feeder.start()
    with os.fdopen(r, "rb") as f:
        _runner(run, f).run(lambda w0, norms: None)
    feeder.join(30)

    r, w = _pipe()
    block = rate * int(tr["block_ms"]) // 1000
    started = os.path.join(run.tmp, "started.npy")
    gen = subprocess.Popen(
        [sys.executable, "-m", "sdrbench.traffic.live_gen", "--fd", str(w), "--capture", path, "--rate", str(rate),
         "--samples", str(run.state["total"]), "--block", str(block), "--pair", str(pair), "--started", started],
        pass_fds=(w,), stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True, env={**os.environ, **GEN_ENV},
    )
    os.close(w)
    run.processes.append(gen)
    if gen.stdout.readline().strip() != "ready":
        raise RuntimeError("the live generator did not start")
    run.state.update(gen=gen, started=started, block=block)
    run.state["fileobj"] = os.fdopen(r, "rb")
    run.state["runner"] = _runner(run, run.state["fileobj"])
    if run.device.type == "cuda":
        torch.cuda.synchronize()


def _feed(fd: int, payload: bytes) -> None:
    with os.fdopen(fd, "wb") as f:
        f.write(payload)


def last_block(run, k: int) -> int:
    """The block that holds the last sample chunk ``k`` reads."""
    s = run.state
    lp = next(x for x in run.config["chain"] if x["stage"] == "lowpass")
    taps, d = 2 * int(lp["power"]), int(lp["decimate"])
    # the chunk's last output reads ceil(taps/2) + taps - 1 past its own
    # decimation point, (k + 1) chunk - d
    last = min((k + 1) * s["chunk"] - d + (taps - taps // 2) + taps, s["total"]) - 1
    return last // s["block"]


def due(run, k: int) -> float:
    """Chunk ``k``'s due time: that of the block holding the last sample
    it reads."""
    s = run.state
    return s["t0"] + min((last_block(run, k) + 1) * s["block"], s["total"]) / s["rate"]


def latencies(run, stamps: dict[int, float], started) -> tuple[list[float], list[float]]:
    """Each emitted chunk's latency (from its due time) and net latency
    (from the later of its due time and ``started``, the start of the
    generator's write of its last block), in chunk order."""
    lat, net = [], []
    for k in sorted(stamps):
        t = due(run, k)
        lat.append(stamps[k] - t)
        net.append(stamps[k] - max(t, float(started[last_block(run, k)])))
    return lat, net


def window(run) -> None:
    s = run.state
    per_chunk = s["chunk"] // (next(x for x in run.config["chain"] if x["stage"] == "lowpass")["decimate"]
                              * run.config["sink"]["width"])
    stamps: dict[int, float] = {}
    shapes: dict[int, tuple] = {}
    kept: dict[int, np.ndarray] = {}
    best = [-1, -1, float("-inf")]  # the peak tracker: window, bin, magnitude

    def emit(w0: int, norms: np.ndarray) -> None:
        t = run.clock()
        k = w0 // per_chunk
        stamps[k] = t
        shapes[k] = (w0 % per_chunk, norms.shape)
        idx, val = np.argmax(norms, axis=-1), np.max(norms, axis=-1)
        if len(val):
            i = int(np.argmax(val))
            if float(val[i]) > best[2]:
                best[:] = [w0 + i, int(idx[i]), float(val[i])]
        kept[k] = np.array(norms, copy=True)

    run.begin()
    s["t0"] = run.clock() + 0.02
    run.t_start = s["t0"]
    gen = s["gen"]
    gen.stdin.write(f"{s['t0']!r}\n")
    gen.stdin.flush()
    s["runner"].run(emit)
    run.end()
    report = gen.stdout.readline()
    gen.wait(30)
    run.latencies, run.net_latencies = latencies(run, stamps, np.load(s["started"]))
    if run.latencies:
        ms = 1e3 * np.asarray(run.latencies)
        run.notes.append("latency ms over the window, mean/p50/p90/p95: {:.3f}/{:.3f}/{:.3f}/{:.3f}".format(
            ms.mean(), *np.percentile(ms, [50, 90, 95])))
        run.notes.append("latency ms by third of the window, p50/p95: " + " ".join(
            f"{np.percentile(t, 50):.3f}/{np.percentile(t, 95):.3f}" for t in np.array_split(ms, 3) if len(t)))
    if run.net_latencies:
        run.notes.append("net latency ms p50/p95: {:.3f}/{:.3f}".format(
            *np.percentile(1e3 * np.asarray(run.net_latencies), [50, 95])))
    run.attempted = s["n_chunks"]
    run.failed = s["n_chunks"] - len(stamps)
    run.kind = "live"
    run.chunks = len(stamps)
    s.update(kept=kept, shapes=shapes, per_chunk=per_chunk, peak=best)
    try:
        g = json.loads(report)
        run.notes.append(
            "generator: {blocks} blocks, late max {late_max_ms:.3f} ms p95 {late_p95_ms:.3f} ms, "
            "write blocked max {blocked_max_ms:.3f} ms p95 {blocked_p95_ms:.3f} ms, sleep overran p95 "
            "{sleep_over_p95_ms:.3f} ms, its CPU busy {cpu_share:.3f} of the time".format(**g)
        )
    except (ValueError, KeyError):
        run.notes.append(f"generator: no report ({report!r})")


def release(run) -> None:
    s = run.state
    s.pop("runner", None)
    f = s.pop("fileobj", None)
    if f is not None:
        f.close()


def check(run) -> list[tuple[str, float, float]]:
    raw = torch.from_numpy(np.fromfile(run.state["path"], dtype=np.uint8)).to(run.device)
    return compare(run, ref.Capture(raw, length=run.state["total"], loop=True))


def compare(run, cap: ref.Capture) -> list[tuple[str, float, float]]:
    """Every chunk the sink received, against the float64 reference."""
    s, cfg, lim = run.state, run.config, run.limits
    per = s["per_chunk"]
    bad = run.failed + sum(1 for k, (r, shape) in s["shapes"].items() if r or shape != (per, cfg["sink"]["width"]))
    ks = sorted(s["kept"])
    windows = np.concatenate([np.arange(k * per, (k + 1) * per) for k in ks]) if ks else np.zeros(0, np.int64)
    want = stream_reference(cfg, cap, windows)
    got = np.concatenate([s["kept"][k] for k in ks]) if ks else np.zeros((0, cfg["sink"]["width"]))
    if got.shape != want.shape or not len(want):
        err = float("inf")
    else:
        scale = float(np.median(want.max(axis=1)))
        err = float(np.max(np.abs(got - want))) / scale
    return [("chunks_missing", float(bad), lim["chunks_missing"]), ("norm_err", err, lim["norm_err"])]


