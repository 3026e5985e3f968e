"""Smoke run of quadrs_tpu_torch's main path on one CUDA card.

Run from the root of a checkout: ``python3 chip_smoke.py``.  It imports
no JAX.  It exits non-zero, printing no result, when CUDA is
unavailable or the package is missing; any failed phase raises and ends
the run.  Phases:

1. the card: ``nvidia-smi``'s name and power limit, torch and CUDA versions;
2. the build of the CUDA kernels from ``quadrs_tpu_torch/csrc``;
3. each kernel against its plain PyTorch version on the same CUDA
   tensors: the frontend kernels for every format and the envelope's
   corner cases, held to ``5e-5 * scale`` (the JAX package's
   kernel-versus-chain bound); the three waterfall kernels for every
   format, widths 256 to 8192, strides tiled, overlapped, not a
   128-multiple and skipping, both windowings, held to the JAX package's
   waterfall tolerances;
4. the main paths through the CLI, launch counts and outputs checked:
   ``stream`` over a 2^26-sample synthetic cs8 capture at 21 Msps, with
   and without ``-search`` and with ``-scan`` (kernel 1), and the model's
   fused-STFT route over the same staged chunks (kernel 2); then the
   waterfall bank (BASELINE config 5) over 64 cs8 captures of 2^21
   samples: ``waterfall`` at 1024 points, ``waterfall -stride 256
   -search``, ``scan -stride 256``; then each waterfall kernel against
   its plain version on every chunk the runner stages at strides 1024
   and 256 (the ragged last chunks included), and the CLI's peaks and
   survey against the plain version's stride-256 norms;
5. CUDA-event times of the kernels and their plain versions at the main
   paths' shapes: one 4M-sample cs8 chunk of the stream chain (D 32, 400
   taps, W 64), and one bank chunk (64 streams x 2000 windows x 1024
   points) at strides 1024 and 256, each waterfall kernel first held
   against its plain version on those inputs.

The line before the last holds the kernels' JSON record, their errors
taken at the main paths' shapes; the last line is ``{"ok": true,
"device": {...}}``.
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
BANK_STREAMS = 64  # BASELINE config 5: 64 parallel cs8 streams, 1024 points
BANK_SAMPLES = 1 << 21  # per capture: 64 x 4 MiB of cs8
BANK_CHUNK = 2000  # the CLI's default -chunk 2k windows
WF_RTOL = 2e-5  # the JAX package's waterfall kernel tolerance
WF_WIDTHS = (256, 384, 1024, 2048, 4096, 8192)  # phase 3: 2048 and up as one window per block
WF_WINDOWS = 301  # phase 3: no multiple of any window tile (8, 5, 2 or 1 windows)


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


def compare(name: str, got: torch.Tensor, want: torch.Tensor, failures: list[str] | None = None) -> tuple[float, float]:
    """(max |got - want|, that over max |want|), held to ``TOL * max
    |want|``.  A failure raises, or with ``failures`` is recorded there
    for the caller to raise."""
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
    return err, err / scale


def phase_kernels() -> dict[str, tuple[float, float]]:
    """Phase 3: every kernel against its plain version; returns each
    kernel's (absolute, relative) error at the stream path's shape (cs8,
    D 32, 400 taps, a 4M-sample chunk; W 64 for kernel 2)."""
    from quadrs_tpu_torch.formats import FileFormat
    from quadrs_tpu_torch.models.receiver import PipelineModel
    from quadrs_tpu_torch.ops import frontend as fe

    at_main = {}
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
            if fmt is FileFormat.COMPLEX_INT8 and label.startswith("bench"):
                at_main["frontend_fir"] = err
    stft_cases = [(FileFormat.COMPLEX_INT8, w, None) for w in (8, 32, 64, 128)]
    stft_cases.append((FileFormat.COMPLEX_UINT8, 64, n_bench - n_bench // 31))
    for fmt, w, nv in stft_cases:
        model = PipelineModel(bench_cfg(fmt, width=w)).to(DEVICE)
        planes, bases, n_out, n_ok = frontend_inputs(model, n_bench, 0, nv, seed=w)
        spec, tables = model.frontend_spec, model.frontend_tables()
        got = fe.fused_frontend_t(planes, bases, spec, n_out, n_valid=n_ok, stft_width=w, tables=tables)
        want = fe.fused_frontend_t_reference(planes, bases, spec, n_out, n_ok, tables, stft_width=w)
        label = f"frontend_fir_stft {fmt.value} W{w}" + (" ragged tail" if nv else "")
        err = compare(label, got, want, failures)
        if fmt is FileFormat.COMPLEX_INT8 and w == 64:
            at_main["frontend_fir_stft"] = err
    if failures:
        raise AssertionError(f"kernels disagree with their plain versions: {failures}")
    return at_main


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
    """Phase 4, the stream: the CLI's stream path over a 2^26-sample
    capture; returns each kernel's launches over the phase."""
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

        before = k1.launches
        thr = float(np.median(norms))
        out = run_cli(["stream", "-shift", "280k", "-chunk", str(CHUNK), "-scan", "yes", "-threshold", repr(thr),
                       "-out", prefix, path])
        print(f"    ({card})")
        if k1.launches - before != chunks or k2.launches:
            raise AssertionError(f"stream -scan launched frontend_fir {k1.launches - before}x for {chunks} chunks")
        table = np.loadtxt(f"{prefix}.scan.csv", delimiter=",", skiprows=1, ndmin=2)
        want_sum = norms.astype(np.float64).sum(axis=0)
        got_sum = table[:, 2] * norms.shape[0]
        tol = TOL * float(norms.max())
        near = np.abs(norms - np.float32(thr)) <= tol
        above_err = np.abs(table[:, 4] - (norms > np.float32(thr)).sum(axis=0)) - near.sum(axis=0)
        print(f"  -scan sums vs the -out norms: max |diff| {np.abs(got_sum - want_sum).max():.4g} "
              f"(bound {norms.shape[0] * tol:.4g}); counts off by more than the near-threshold norms: "
              f"{int((above_err > 0).sum())} bins")
        if (f"stream scan: {norms.shape[0]} windows of {cfg.fft_width} bins" not in out
                or np.abs(got_sum - want_sum).max() > norms.shape[0] * tol
                or np.abs(table[:, 3] - norms.max(axis=0)).max() > tol or (above_err > 0).any()):
            raise AssertionError("stream -scan disagrees with the stream -out norms")

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


def synth_on_device(fmt, shape, seed: int) -> torch.Tensor:
    """Seeded random native-dtype planes, made on the card."""
    from quadrs_tpu_torch.formats import FileFormat

    g = torch.Generator(device=DEVICE).manual_seed(seed)
    if fmt is FileFormat.COMPLEX_FLOAT32:
        return 0.3 * torch.randn(shape, generator=g, device=DEVICE)
    lo, hi = {FileFormat.COMPLEX_INT8: (-127, 128), FileFormat.COMPLEX_UINT8: (0, 256),
              FileFormat.COMPLEX_INT16: (-32768, 32768)}[fmt]
    return torch.randint(lo, hi, shape, generator=g, device=DEVICE).to(fmt.torch_dtype)


def wf_close(got: torch.Tensor, want: torch.Tensor) -> bool:
    """Finite, the same shape, and within ``rtol=2e-5, atol=2e-5·max``."""
    if got.shape != want.shape or not bool(torch.isfinite(got).all()):
        return False
    return not bool(((got - want).abs() > WF_RTOL * want.abs() + WF_RTOL * float(want.max())).any())


def check_waterfall(label, spec, planes, nw, stride, tables, failures, thr=None) -> dict[str, tuple[float, float]]:
    """The three waterfall kernels against their plain versions on one
    input, at the JAX package's waterfall tolerances: norms
    ``rtol=2e-5, atol=2e-5·max``; peak bins exact except near-ties,
    magnitudes ``rtol=2e-5``; scan sums ``nw·2e-5·max``, maxima
    ``2e-5·max``, counts exact except for norms within ``2e-5·max`` of
    the threshold (by default the median norm).  Returns each kernel's
    (absolute error, that over the max norm; for scan the larger of the
    sum error per window and the max error)."""
    from quadrs_tpu_torch.ops import waterfall as wf

    want = wf.fused_waterfall_reference(planes, spec, nw, stride=stride)
    peak = float(want.max())
    thr = float(want.median()) if thr is None else thr
    got = wf.waterfall_norms(planes, tables, spec, nw, stride)
    idx, val = wf.waterfall_search(planes, tables, spec, nw, stride)
    ssum, smax, cnt = wf.waterfall_scan(planes, tables, spec, nw, stride, thr)
    torch.cuda.synchronize()
    bad = [] if wf_close(got, want) else ["norms"]
    d = (got - want).abs()
    top = want.amax(-1)
    picked = want.gather(-1, idx.long()[..., None])[..., 0]
    exact = idx == want.argmax(-1)
    if not bool((exact | ((picked - top).abs() <= WF_RTOL * top)).all()) or bool(
            ((val - top).abs() > WF_RTOL * top).any()):
        bad.append("search")
    sum_err = float((ssum.double() - want.double().sum(1)).abs().max())
    max_err = float((smax - want.amax(1)).abs().max())
    lo = (want > thr + WF_RTOL * peak).sum(1)
    hi = (want > thr - WF_RTOL * peak).sum(1)
    if sum_err > nw * WF_RTOL * peak or max_err > WF_RTOL * peak or not bool(((cnt >= lo) & (cnt <= hi)).all()):
        bad.append("scan")
    norms_err, peak_err = float(d.max()), float((val - top).abs().max())
    errs = {"waterfall_norms": (norms_err, norms_err / peak), "waterfall_search": (peak_err, peak_err / peak),
            "waterfall_scan": (max(sum_err, max_err), max(sum_err / nw, max_err) / peak)}
    print(f"  {label}: norms {norms_err / peak:.2e}, peaks {peak_err / peak:.2e} "
          f"({int((~exact).sum())} near-tie bins differ), scan sums {sum_err / (nw * peak):.2e}·nw, "
          f"max {max_err / peak:.2e} (of max {peak:.4g}) {'FAIL ' + ','.join(bad) if bad else 'ok'}")
    if bad:
        failures.append(label)
    return errs


def fold(worst: dict[str, tuple[float, float]], errs: dict[str, tuple[float, float]]) -> None:
    """Keep each kernel's worst (absolute, relative) error."""
    for k, (a, r) in errs.items():
        a0, r0 = worst.get(k, (0.0, 0.0))
        worst[k] = (max(a0, a), max(r0, r))


def phase_waterfall_kernels() -> None:
    """Phase 3, the bank: every waterfall kernel against its plain version
    for every format, widths 256 to 8192, strides tiled, width/4, 96 and
    width+300, both windowings, over 301 windows (no multiple of any
    window tile)."""
    from quadrs_tpu_torch.formats import FileFormat
    from quadrs_tpu_torch.ops import waterfall as wf

    failures: list[str] = []
    nw = WF_WINDOWS
    for width in WF_WIDTHS:
        streams = BANK_STREAMS if width <= 1024 else BANK_STREAMS * 1024 // width * 2
        for stride in (width, width // 4, 96, width + 300):
            for k, fmt in enumerate(FileFormat):
                planes = synth_on_device(fmt, (streams, 2, (nw - 1) * stride + width + 5), seed=width + stride + k)
                for windowing in ("rectangular", "blackman-harris"):
                    spec = wf.WaterfallSpec(fmt, width, windowing)
                    tables = wf.waterfall_tables(spec, device=DEVICE)
                    label = f"{fmt.value} W{width} stride {stride} {windowing} {streams}x{nw}"
                    check_waterfall(label, spec, planes, nw, stride, tables, failures)
    if failures:
        raise AssertionError(f"waterfall kernels disagree with their plain versions: {failures}")


def write_bank(tmp: str, n_streams: int, n: int) -> list[str]:
    """``n_streams`` cs8 captures at 21 Msps of ``n`` samples each: noise
    from ``default_rng(SEED)`` plus one tone per stream, its frequency
    stepping 150 kHz per stream."""
    rng = np.random.default_rng(SEED)
    m = np.arange(n, dtype=np.int64)
    paths = []
    for s in range(n_streams):
        ph = 2 * np.pi * ((m * ((s - n_streams // 2) * 150_000 + 12_345)) % SAMPLE_RATE) / SAMPLE_RATE
        iq = np.stack([50 * np.cos(ph), 50 * np.sin(ph)]) + rng.integers(-40, 41, (2, n))
        path = os.path.join(tmp, f"bank{s:02d}.sr21M.cs8")
        with open(path, "wb") as f:
            f.write(np.clip(np.rint(iq), -127, 127).astype(np.int8).T.tobytes())
        paths.append(path)
    return paths


def phase_bank_path(card: str) -> tuple[dict[str, int], dict[str, tuple[float, float]]]:
    """Phase 4, the bank: ``waterfall``, ``waterfall -search`` and ``scan``
    through the CLI over 64 captures of 2^21 cs8 samples; each kernel's
    launches must equal the chunk count (2000-window chunks).  Then each
    kernel against its plain version on every chunk the runner stages.
    Returns each kernel's launches in its run, and its worst (absolute,
    relative) error over those chunks."""
    from quadrs_tpu_torch.formats import FileFormat
    from quadrs_tpu_torch.models.waterfall import WaterfallConfig, WaterfallModel
    from quadrs_tpu_torch.ops import waterfall as wf
    from quadrs_tpu_torch.sources import open_capture
    from quadrs_tpu_torch.stream_runner import WaterfallRunner

    os.environ.pop("QUADRS_PLATFORM", None)  # the CLI's default device: cuda
    kernels = {"waterfall_norms": wf.waterfall_norms, "waterfall_search": wf.waterfall_search,
               "waterfall_scan": wf.waterfall_scan}
    launches = {}
    width, thr = 1024, 20.0  # thr: noise norms here are Rayleigh with sigma ~6

    def counted(name: str, chunks: int, argv: list[str]) -> str:
        for k in kernels.values():
            k.launches = 0  # counts of this main-path run only, from here
        out = run_cli(argv)
        got = {k: v.launches for k, v in kernels.items()}
        print(f"    launches {got} ({card})")
        if got != {k: chunks if k == name else 0 for k in kernels}:
            raise AssertionError(f"{argv[0]} launched {got}; {chunks} chunks of {name}")
        launches[name] = got[name]
        return out

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        files = write_bank(tmp, BANK_STREAMS, BANK_SAMPLES)
        print(f"  wrote {BANK_STREAMS} cs8 captures of {BANK_SAMPLES} samples in {time.perf_counter() - t0:.1f}s")
        prefix = os.path.join(tmp, "out")
        tiled = (BANK_SAMPLES - width) // width + 1
        over = (BANK_SAMPLES - width) // 256 + 1
        chunks_tiled, chunks_over = -(-tiled // BANK_CHUNK), -(-over // BANK_CHUNK)

        out = counted("waterfall_norms", chunks_tiled, ["waterfall", "-width", str(width), "-chunk", str(BANK_CHUNK),
                                                        "-out", prefix, *files])
        if out.count("waterfall peak stream=") != BANK_STREAMS:
            raise AssertionError("waterfall printed no peak line per stream")
        spec = wf.WaterfallSpec(FileFormat.COMPLEX_INT8, width)
        for s in (0, BANK_STREAMS - 1):
            rows = np.fromfile(f"{prefix}.s{s}.norms.f32", dtype=np.float32).reshape(-1, width)
            planes = torch.from_numpy(open_capture(files[s]).stage(0, BANK_SAMPLES)).to(DEVICE)[None]
            plain = wf.fused_waterfall_reference(planes, spec, tiled)[0]
            ok = wf_close(torch.from_numpy(rows).to(DEVICE), plain)
            print(f"  waterfall -out stream {s} vs plain ({rows.shape[0]} windows): {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"waterfall -out stream {s} disagrees with the plain version")

        counted("waterfall_search", chunks_over,
                ["waterfall", "-width", str(width), "-stride", "256", "-chunk", str(BANK_CHUNK), "-search", "yes",
                 "-out", prefix, *files])
        counted("waterfall_scan", chunks_over,
                ["scan", "-width", str(width), "-stride", "256", "-chunk", str(BANK_CHUNK), "-threshold", repr(thr),
                 "-top", "3",
                 "-out", prefix, *files])

        # every kernel against its plain version on the runner's staged
        # chunks at both strides, the ragged last chunks included; then the
        # CLI's -search peaks and scan stats against the plain version's
        # norms at stride 256 (these launches are not the main path's)
        tables = wf.waterfall_tables(spec, device=DEVICE)
        failures: list[str] = []
        at_main: dict[str, tuple[float, float]] = {}
        arg, top, tie = [], [], []
        nsum = torch.zeros((BANK_STREAMS, width), dtype=torch.float64, device=DEVICE)
        nmax = torch.zeros((BANK_STREAMS, width), device=DEVICE)
        lo = torch.zeros((BANK_STREAMS, width), dtype=torch.int64, device=DEVICE)
        hi = torch.zeros_like(lo)
        peak = 0.0
        for stride in (width, 256):
            cfg = WaterfallConfig(n_streams=BANK_STREAMS, fft_width=width, stride=stride, fmt=FileFormat.COMPLEX_INT8)
            runner = WaterfallRunner([open_capture(f) for f in files], WaterfallModel(cfg), DEVICE,
                                     chunk_windows=BANK_CHUNK)
            for w0, n_w, _, staged in runner._staged_chunks(0):
                planes = torch.from_numpy(staged).to(DEVICE)
                label = f"staged chunk stride {stride} windows {w0}+{n_w} ({BANK_STREAMS}x{n_w}x{width})"
                fold(at_main, check_waterfall(label, spec, planes, n_w, stride, tables, failures, thr=thr))
                if stride != 256:
                    continue
                norms = wf.fused_waterfall_reference(planes, spec, n_w, stride=stride)
                arg.append(norms.argmax(-1))
                top2 = norms.topk(2, dim=-1).values
                top.append(top2[..., 0])
                tie.append(top2[..., 0] - top2[..., 1])
                nsum += norms.double().sum(1)
                nmax = torch.maximum(nmax, norms.amax(1))
                band = WF_RTOL * float(norms.max())
                peak = max(peak, float(norms.max()))
                lo += (norms > thr + band).sum(1)
                hi += (norms > thr - band).sum(1)
        if failures:
            raise AssertionError(f"waterfall kernels disagree with their plain versions: {failures}")
        arg, top, tie = torch.cat(arg, 1).cpu().numpy(), torch.cat(top, 1).cpu().numpy(), torch.cat(tie, 1).cpu().numpy()
        csv = np.loadtxt(f"{prefix}.peaks.csv", delimiter=",", skiprows=1, dtype=np.float64)
        if csv.shape != (BANK_STREAMS * over, 4):
            raise AssertionError(f"{csv.shape[0]} peak rows for {BANK_STREAMS} x {over} windows")
        at = (csv[:, 0].astype(np.int64), csv[:, 1].astype(np.int64))  # rows come chunk by chunk
        bins = np.full((BANK_STREAMS, over), -1, np.int64)
        mags = np.zeros((BANK_STREAMS, over))
        bins[at], mags[at] = csv[:, 2], csv[:, 3]
        differ = bins != arg
        print(f"  -search peak bins vs argmax of the plain version's norms at stride 256: {int(differ.sum())} of "
              f"{bins.size} differ, all near-ties: {bool((tie[differ] <= WF_RTOL * top[differ]).all())}; "
              f"max |mag diff| {np.abs(mags - top).max():.4g} (bound {WF_RTOL * top.max():.4g})")
        if (tie[differ] > WF_RTOL * top[differ]).any() or np.abs(mags - top).max() > WF_RTOL * top.max():
            raise AssertionError("waterfall -search peaks disagree with the plain version's norms")
        sums = np.stack([np.loadtxt(f"{prefix}.s{s}.scan.csv", delimiter=",", skiprows=1) for s in range(BANK_STREAMS)])
        got_sum = sums[..., 2] * over
        sum_err = np.abs(got_sum - nsum.cpu().numpy()).max()
        max_err = np.abs(sums[..., 3] - nmax.cpu().numpy()).max()
        above = sums[..., 4]
        count_ok = bool(((above >= lo.cpu().numpy()) & (above <= hi.cpu().numpy())).all())
        print(f"  scan vs the plain version's f64 sums: max |sum diff| {sum_err:.4g} "
              f"(bound {over * WF_RTOL * peak:.4g}), max |max diff| {max_err:.4g} (bound {WF_RTOL * peak:.4g}), "
              f"counts within the threshold band: {count_ok}")
        if sum_err > over * WF_RTOL * peak or max_err > WF_RTOL * peak or not count_ok:
            raise AssertionError("scan disagrees with the plain version's norms")
    return launches, at_main


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


def phase_waterfall_timing(card: str, at_main: dict[str, tuple[float, float]]) -> dict[str, float]:
    """Phase 5, the bank: CUDA-event times of each waterfall kernel and
    its plain version at one full chunk, 64 streams x 2000 windows x 1024
    points of cs8, at strides 1024 and 256, in mirrored order; each
    kernel is first held against its plain version on those inputs
    (folded into ``at_main``)."""
    from quadrs_tpu_torch.formats import FileFormat
    from quadrs_tpu_torch.ops import waterfall as wf

    spec = wf.WaterfallSpec(FileFormat.COMPLEX_INT8, 1024)
    tables = wf.waterfall_tables(spec, device=DEVICE)
    nw, thr = BANK_CHUNK, 20.0
    ms = {}
    for stride in (1024, 256):
        planes = synth_on_device(FileFormat.COMPLEX_INT8, (BANK_STREAMS, 2, (nw - 1) * stride + 1024), seed=stride)
        failures: list[str] = []
        label = f"random cs8 stride {stride} ({BANK_STREAMS}x{nw}x1024)"
        fold(at_main, check_waterfall(label, spec, planes, nw, stride, tables, failures, thr=thr))
        if failures:
            raise AssertionError(f"waterfall kernels disagree with their plain versions: {failures}")
        variants = {
            "norms": lambda: wf.waterfall_norms(planes, tables, spec, nw, stride),
            "plain_norms": lambda: wf.fused_waterfall_reference(planes, spec, nw, stride=stride),
            "search": lambda: wf.waterfall_search(planes, tables, spec, nw, stride),
            "plain_search": lambda: wf.fused_waterfall_search_reference(planes, spec, nw, stride=stride),
            "scan": lambda: wf.waterfall_scan(planes, tables, spec, nw, stride, thr),
            "plain_scan": lambda: wf.fused_waterfall_scan_reference(planes, spec, nw, thr, stride=stride),
        }
        runs: dict[str, list[float]] = {k: [] for k in variants}
        for k in list(variants) + list(reversed(variants)):
            runs[k].append(time_ms(variants[k], iters=10))
        samples = BANK_STREAMS * ((nw - 1) * stride + 1024)
        print(f"  timing: {BANK_STREAMS} streams x {nw} windows x 1024 points, stride {stride}, cs8 ({card})")
        for k, v in runs.items():
            ms[f"{k}@{stride}"] = sum(v) / len(v)
            print(f"    {k:14s} {ms[f'{k}@{stride}']:.4f} ms  (runs {', '.join(f'{x:.4f}' for x in v)})  "
                  f"{samples / ms[f'{k}@{stride}'] / 1e3:.1f} Msps of input")
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
    at_main = phase_kernels()
    phase_waterfall_kernels()
    print("phase 4: the main paths")
    launches = phase_main_path(card)
    bank_launches, bank_err = phase_bank_path(card)
    launches.update(bank_launches)
    at_main.update(bank_err)
    print("phase 5: timing")
    ms = phase_timing(card)
    wf_ms = phase_waterfall_timing(card, at_main)

    # errors at the main paths' shapes: max_abs_err, and err_over_max
    # (that over the max of the plain output; for scan, the sum error
    # per window or the max error, whichever is larger)
    src = "quadrs_tpu_torch/csrc/frontend.cu"
    kernels = [
        {"name": "frontend_fir", "route": "cuda", "source": src,
         "replaces": "quadrs_tpu/ops/frontend_pallas.py:409", "launches": launches["frontend_fir"],
         "ms": ms["kernel1"], "plain_ms": ms["plain"]},
        {"name": "frontend_fir_stft", "route": "cuda", "source": src,
         "replaces": "quadrs_tpu/ops/frontend_pallas.py:513", "launches": launches["frontend_fir_stft"],
         "ms": ms["kernel2"], "plain_ms": ms["plain_stft_epilogue"]},
    ]
    # each waterfall kernel at the stride of its main-path run
    for name, line, key in (("waterfall_norms", 149, "norms@1024"), ("waterfall_search", 219, "search@256"),
                            ("waterfall_scan", 787, "scan@256")):
        kernels.append({"name": name, "route": "cuda", "source": "quadrs_tpu_torch/csrc/waterfall.cu",
                        "replaces": f"quadrs_tpu/ops/waterfall_pallas.py:{line}", "launches": launches[name],
                        "ms": wf_ms[key], "plain_ms": wf_ms["plain_" + key]})
    for k in kernels:
        k["max_abs_err"], k["err_over_max"] = at_main[k["name"]]
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
