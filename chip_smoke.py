"""Smoke run of quadrs_tpu_torch's main path on one CUDA card.

Run from the root of a checkout: ``python3 chip_smoke.py``.  It imports
no JAX.  It exits non-zero, printing no result, when CUDA is
unavailable or the package is missing; any failed phase raises and ends
the run.  Phases:

1. the card: ``nvidia-smi``'s name and power limit, torch and CUDA versions;
2. the build of the CUDA kernels from ``quadrs_tpu_torch/csrc``;
3. each kernel against its plain PyTorch version on the same CUDA
   tensors, for every format and the envelope's corner cases, held to
   ``5e-5 * scale`` (the JAX package's kernel-versus-chain bound);
4. the main path: ``stream`` over a 2^26-sample synthetic cs8 capture at
   21 Msps through the CLI, with and without ``-search`` (kernel 1), and
   the model's fused-STFT route over the same staged chunks (kernel 2),
   with launch counts, outputs and peaks checked;
5. CUDA-event times of the kernels and the plain version at the stream
   chain's shape (one 4M-sample cs8 chunk, D 32, 400 taps, W 64).

The line before the last holds the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

TOL = 5e-5  # max |kernel - plain| over max |plain|
SAMPLE_RATE = 21_000_000
CHUNK = 4_000_000  # the CLI's default -chunk 4M
SEED = 0
CAPTURE_SAMPLES = 1 << 26  # 128 MiB of cs8: 3.2 s of air at 21 Msps
DEVICE = torch.device("cuda")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def bench_cfg(fe_fmt, decimate=32, taps=400, width=64):
    from quadrs_tpu_torch.models.receiver import PipelineConfig

    return PipelineConfig(
        sample_rate=SAMPLE_RATE, shift_freq=280_000, lp_freq=200_000,
        decimate=decimate, taps=taps, fft_width=width, fmt=fe_fmt,
    )


def chunk_len(cfg) -> int:
    """Raw samples of one full chunk, lookahead included, as StreamRunner stages it."""
    win = cfg.decimate * cfg.fft_width
    return CHUNK // win * win + cfg.taps + (cfg.taps - cfg.taps // 2)


def frontend_inputs(model, n: int, offset: int, n_valid: int | None, seed: int):
    """(planes, bases, n_out, n_ok) for one chunk of ``n`` raw samples, on the card."""
    from quadrs_tpu_torch.formats import synth_planes

    cfg = model.cfg
    raw = torch.from_numpy(synth_planes(cfg.fmt, n, seed)).to(DEVICE)
    bases = torch.from_numpy(model.stream_bases(offset, n)).to(DEVICE)
    prefix = cfg.taps - cfg.taps // 2
    n_out = (n - cfg.taps) // cfg.decimate // cfg.fft_width * cfg.fft_width
    planes = raw[:, prefix:]
    n_ok = planes.shape[1] if n_valid is None else n_valid - prefix
    return planes, bases, n_out, n_ok


def compare(name: str, got: torch.Tensor, want: torch.Tensor, failures: list[str] | None = None) -> float:
    """Max |got - want|, held to ``TOL * max |want|``.  A failure raises,
    or with ``failures`` is recorded there for the caller to raise."""
    torch.cuda.synchronize()
    if got.shape != want.shape or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: shape {tuple(got.shape)} vs {tuple(want.shape)} or non-finite values")
    err = float((got - want).abs().max())
    scale = max(float(want.abs().max()), 1e-6)
    ok = err <= TOL * scale
    print(f"  {name}: max_abs_err {err:.3e}, scale {scale:.4g}, err/scale {err / scale:.3e} {'ok' if ok else 'FAIL'}")
    if not ok:
        if failures is None:
            raise AssertionError(f"{name}: outputs disagree")
        failures.append(name)
    return err


def phase_kernels() -> dict[str, float]:
    """Phase 3: every kernel against its plain version; returns each
    kernel's worst absolute error."""
    from quadrs_tpu_torch.formats import FileFormat
    from quadrs_tpu_torch.models.receiver import PipelineModel
    from quadrs_tpu_torch.ops import frontend as fe

    worst = {"frontend_fir": 0.0, "frontend_fir_stft": 0.0}
    failures: list[str] = []
    n_bench = chunk_len(bench_cfg(FileFormat.COMPLEX_INT8))
    # (label, decimate, taps, raw samples, absolute offset, n_valid)
    cases = [
        ("bench D32 400 taps 4M", 32, 400, n_bench, 0, None),
        ("D3 40 taps", 3, 40, 1 << 21, 0, None),
        ("D64 400 taps", 64, 400, n_bench, 0, None),
        ("D64 8192 taps (m_sub 128)", 64, 8192, n_bench, 0, None),
        ("long filter D32 4000 taps (m_sub 125)", 32, 4000, n_bench, 0, None),
        ("ragged tail n_valid", 32, 400, n_bench, 0, n_bench - n_bench // 31),
        ("offset 999999937", 32, 400, n_bench, 999_999_937, None),
    ]
    for fmt in FileFormat:
        for label, d, taps, n, off, nv in cases:
            model = PipelineModel(bench_cfg(fmt, d, taps)).to(DEVICE)
            planes, bases, n_out, n_ok = frontend_inputs(model, n, off, nv, seed=d + taps)
            spec, tables = model.frontend_spec, model.frontend_tables()
            got = fe.fused_frontend_t(planes, bases, spec, n_out, n_valid=n_ok, tables=tables)
            want = fe.fused_frontend_t_reference(planes, bases, spec, n_out, n_ok, tables)
            err = compare(f"frontend_fir {fmt.value} {label}", got, want, failures)
            worst["frontend_fir"] = max(worst["frontend_fir"], err)
    stft_cases = [(FileFormat.COMPLEX_INT8, w, None) for w in (8, 32, 64, 128)]
    stft_cases.append((FileFormat.COMPLEX_UINT8, 64, n_bench - n_bench // 31))
    for fmt, w, nv in stft_cases:
        model = PipelineModel(bench_cfg(fmt, width=w)).to(DEVICE)
        planes, bases, n_out, n_ok = frontend_inputs(model, n_bench, 0, nv, seed=w)
        spec, tables = model.frontend_spec, model.frontend_tables()
        got = fe.fused_frontend_t(planes, bases, spec, n_out, n_valid=n_ok, stft_width=w, tables=tables)
        want = fe.fused_frontend_t_reference(planes, bases, spec, n_out, n_ok, tables, stft_width=w)
        label = f"frontend_fir_stft {fmt.value} W{w}" + (" ragged tail" if nv else "")
        worst["frontend_fir_stft"] = max(worst["frontend_fir_stft"], compare(label, got, want, failures))
    if failures:
        raise AssertionError(f"kernels disagree with their plain versions: {failures}")
    return worst


def write_capture(path: str, n: int) -> None:
    """A cs8 capture at 21 Msps: uniform noise from ``default_rng(SEED)``
    plus a tone at -230 kHz, which ``-shift 280k`` brings to +50 kHz."""
    rng = np.random.default_rng(SEED)
    block = 1 << 22
    with open(path, "wb") as f:
        for lo in range(0, n, block):
            m = np.arange(lo, min(n, lo + block), dtype=np.int64)
            ph = 2 * np.pi * ((m * -230_000) % SAMPLE_RATE) / SAMPLE_RATE
            noise = rng.integers(-40, 41, (2, len(m)))
            iq = np.stack([60 * np.cos(ph), 60 * np.sin(ph)]) + noise
            f.write(np.clip(np.rint(iq), -127, 127).astype(np.int8).T.tobytes())


def n_chunks(length: int, cfg) -> int:
    """The chunk count of StreamRunner._chunks for this capture."""
    win = cfg.decimate * cfg.fft_width
    chunk = max(win, CHUNK // win * win)
    off, count = 0, 0
    while off < length - cfg.taps:
        n = min(chunk, (length - off) // win * win)
        if n <= 0:
            break
        count, off = count + 1, off + n
    return count


def run_cli(argv: list[str]) -> str:
    from quadrs_tpu_torch.cli import main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    out = buf.getvalue()
    print("  $ python -m quadrs_tpu_torch " + " ".join(argv))
    print("    " + out.strip().replace("\n", "\n    "))
    if rc != 0:
        raise AssertionError(f"stream exited {rc}")
    return out


def phase_main_path(card: str) -> dict[str, int]:
    """Phase 4: the CLI's stream path over a 2^26-sample capture; returns
    each kernel's launches over the phase."""
    from quadrs_tpu_torch.formats import FileFormat
    from quadrs_tpu_torch.models.receiver import PipelineModel
    from quadrs_tpu_torch.ops import frontend as fe
    from quadrs_tpu_torch.ops.stft import stft_norms
    from quadrs_tpu_torch.sources import open_capture
    from quadrs_tpu_torch.stream_runner import StreamRunner

    os.environ.pop("QUADRS_PLATFORM", None)  # the CLI's default device: cuda
    n = CAPTURE_SAMPLES
    cfg = bench_cfg(FileFormat.COMPLEX_INT8)
    chunks = n_chunks(n, cfg)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "smoke.sr21M.cs8")
        write_capture(path, n)
        prefix = os.path.join(tmp, "out")
        k1, k2 = fe.frontend_fir, fe.frontend_fir_stft
        k1.launches = k2.launches = 0  # counts of the main path only, from here

        out = run_cli(["stream", "-shift", "280k", "-chunk", str(CHUNK), "-out", prefix, path])
        print(f"    ({card})")
        if (k1.launches, k2.launches) != (chunks, 0):
            raise AssertionError(f"stream launched frontend_fir {k1.launches}x, stft {k2.launches}x; {chunks} chunks")
        norms = np.fromfile(f"{prefix}.norms.f32", dtype=np.float32).reshape(-1, cfg.fft_width)
        if not (np.isfinite(norms).all() and "stream peak window=" in out):
            raise AssertionError("stream wrote non-finite norms or no peak line")

        before = k1.launches
        run_cli(["stream", "-shift", "280k", "-chunk", str(CHUNK), "-search", "yes", "-out", prefix, path])
        print(f"    ({card})")
        if k1.launches - before != chunks or k2.launches:
            raise AssertionError(f"stream -search launched frontend_fir {k1.launches - before}x for {chunks} chunks")
        peaks = np.loadtxt(f"{prefix}.peaks.csv", delimiter=",", skiprows=1, ndmin=2)
        if peaks.shape[0] != norms.shape[0]:
            raise AssertionError(f"{peaks.shape[0]} peak rows for {norms.shape[0]} windows")
        bad = int(np.sum(peaks[:, 1].astype(np.int64) != np.argmax(norms, axis=1)))
        print(f"  -search peak bins vs argmax of the -out norms: {bad} of {len(peaks)} differ")
        if bad:
            raise AssertionError("peak bins disagree with the norms")

        # the first chunk's norms against the plain version on the card
        model = PipelineModel(cfg).to(DEVICE)
        src = open_capture(path)
        la = cfg.taps + (cfg.taps - cfg.taps // 2)
        n0 = min(CHUNK // (cfg.decimate * cfg.fft_width) * cfg.decimate * cfg.fft_width, n) + la
        raw = torch.from_numpy(src.stage(0, n0)).to(DEVICE)
        bases = torch.from_numpy(model.stream_bases(0, n0)).to(DEVICE)
        n_out = (n0 - cfg.taps) // cfg.decimate // cfg.fft_width * cfg.fft_width
        y = fe.fused_frontend_t_reference(
            raw[:, cfg.taps - cfg.taps // 2 :], bases, model.frontend_spec, n_out,
            n0 - (cfg.taps - cfg.taps // 2), model.frontend_tables(),
        )
        plain = stft_norms(torch.complex(y[0], y[1]).reshape(-1, cfg.fft_width))
        compare("first chunk norms (stream -out vs plain)", torch.from_numpy(norms[: plain.shape[0]]).to(DEVICE), plain)

        # the model's fused-STFT route (kernel 2) over the runner's staged chunks
        before = k1.launches
        rows = []
        for off, planes, valid in StreamRunner(src, model, DEVICE, chunk_samples=CHUNK)._chunks():
            raw = torch.from_numpy(planes).to(DEVICE)
            bases = torch.from_numpy(model.stream_bases(off, planes.shape[1])).to(DEVICE)
            nv = None if valid == planes.shape[1] else valid
            rows.append(model.step_stream_fused(raw, bases, nv, fuse_stft=True))
        print(f"  step_stream_fused(fuse_stft=True) over {len(rows)} staged chunks")
        if (k1.launches - before, k2.launches) != (0, chunks):
            raise AssertionError(f"fused route launched frontend_fir_stft {k2.launches}x for {chunks} chunks")
        compare("fused-STFT route vs stream -out norms", torch.cat(rows), torch.from_numpy(norms).to(DEVICE))
    return {"frontend_fir": k1.launches, "frontend_fir_stft": k2.launches}


def time_ms(fn, iters: int = 20) -> float:
    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_timing(card: str) -> dict[str, float]:
    """Phase 5: CUDA-event times at the stream chain's shape, each variant
    timed twice in mirrored order."""
    from quadrs_tpu_torch.formats import FileFormat
    from quadrs_tpu_torch.models.receiver import PipelineModel
    from quadrs_tpu_torch.ops import frontend as fe
    from quadrs_tpu_torch.ops.stft import stft_norms

    cfg = bench_cfg(FileFormat.COMPLEX_INT8)
    model = PipelineModel(cfg).to(DEVICE)
    n = chunk_len(cfg)
    planes, bases, n_out, n_ok = frontend_inputs(model, n, 0, None, seed=1)
    spec, tables, w = model.frontend_spec, model.frontend_tables(), cfg.fft_width

    def unfused_norms(y):
        return stft_norms(torch.complex(y[0], y[1]).reshape(-1, w))

    variants = {
        "kernel1": lambda: fe.frontend_fir(planes, bases, tables, spec, n_out, n_ok),
        "kernel1+stft_norms": lambda: unfused_norms(fe.frontend_fir(planes, bases, tables, spec, n_out, n_ok)),
        "kernel2": lambda: fe.frontend_fir_stft(planes, bases, tables, spec, n_out, n_ok, w),
        "plain": lambda: fe.fused_frontend_t_reference(planes, bases, spec, n_out, n_ok, tables),
        "plain+stft_norms": lambda: unfused_norms(fe.fused_frontend_t_reference(planes, bases, spec, n_out, n_ok, tables)),
        "plain_stft_epilogue": lambda: fe.fused_frontend_t_reference(planes, bases, spec, n_out, n_ok, tables, w),
    }
    order = list(variants) + list(reversed(variants))
    runs: dict[str, list[float]] = {k: [] for k in variants}
    for k in order:
        runs[k].append(time_ms(variants[k]))
    ms = {k: sum(v) / len(v) for k, v in runs.items()}
    samples = n - (cfg.taps + cfg.taps - cfg.taps // 2)
    print(f"  timing: one cs8 chunk of {samples} samples, D 32, 400 taps, W 64 ({card})")
    for k, v in runs.items():
        print(f"    {k:22s} {ms[k]:.4f} ms  (runs {', '.join(f'{x:.4f}' for x in v)})  "
              f"{samples / ms[k] / 1e3:.1f} Msps")
    return ms


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this smoke run needs one CUDA card", file=sys.stderr)
        return 1
    from quadrs_tpu_torch.ops import _cuda

    card = card_line()
    print(f"phase 1: card {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    t0 = time.perf_counter()
    lib = _cuda.library()
    print(f"phase 2: built {lib.path.name} in {time.perf_counter() - t0:.1f}s (nvcc {lib.build_seconds:.1f}s)")
    for line in lib.build_log.splitlines():
        if "Used" in line:
            print("    " + line.strip())
    print("phase 3: kernels against their plain versions")
    worst = phase_kernels()
    print("phase 4: the main path")
    launches = phase_main_path(card)
    print("phase 5: timing")
    ms = phase_timing(card)

    src = "quadrs_tpu_torch/csrc/frontend.cu"
    kernels = [
        {"name": "frontend_fir", "route": "cuda", "source": src,
         "replaces": "quadrs_tpu/ops/frontend_pallas.py:409", "launches": launches["frontend_fir"],
         "max_abs_err": worst["frontend_fir"], "ms": ms["kernel1"], "plain_ms": ms["plain"]},
        {"name": "frontend_fir_stft", "route": "cuda", "source": src,
         "replaces": "quadrs_tpu/ops/frontend_pallas.py:513", "launches": launches["frontend_fir_stft"],
         "max_abs_err": worst["frontend_fir_stft"], "ms": ms["kernel2"],
         "plain_ms": ms["plain_stft_epilogue"]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
