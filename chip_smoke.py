"""Smoke run of quadrs_tpu_torch's main paths on one CUDA card.

Run from the root of a checkout: ``python3 chip_smoke.py``.  It imports
no JAX.  It exits non-zero, printing no result, when CUDA is
unavailable or the package is missing; any failed phase raises and ends
the run.  Phases:

1. the card: ``nvidia-smi``'s name and power limit, torch and CUDA versions;
2. the build of the CUDA kernels from ``quadrs_tpu_torch/csrc``;
3. each kernel against its plain PyTorch version on the same CUDA
   tensors: the frontend kernels for every format and the envelope's
   corner cases, held to ``5e-5 * scale`` (the JAX package's
   kernel-versus-chain bound); the v1 frontend kernel for every format,
   D 1 to 64, 40 and 400 taps, partial tiles, short planes, an offset
   near 1e9 and one 4M-sample cs8 chunk, to the same bound; the three
   waterfall kernels for every format, widths 256 to 8192, strides tiled,
   overlapped, not a 128-multiple and skipping, both windowings, then
   hop 1 and N-1, sliced and odd-strided views and width 640, held to the
   JAX package's waterfall tolerances;
4. the main paths through the CLI, launch counts and outputs checked:
   ``stream`` over a 2^26-sample synthetic cs8 capture at 21 Msps, with
   and without ``-search`` and with ``-scan`` (kernel 1), and the model's
   fused-STFT route over the same staged chunks (kernel 2); the reference
   chain over the same capture (``from ... shift ... lowpass ...`` into
   ``sparkfft``, ``bucket``, ``write``, a 4000-tap ``write``, and
   ``stream -decimate 100`` outside the fused envelope), torch ops with no
   kernel, each held against the same argv on the CPU over a 2^22-sample
   prefix; then the waterfall bank (BASELINE config 5) over 64 cs8
   captures of 2^21 samples: ``waterfall`` at 1024 points, ``waterfall
   -stride 256 -search``, ``scan -stride 256``; then each waterfall kernel
   against its plain version on every chunk the runner stages at strides
   1024 and 256 (the ragged last chunks included), and the CLI's peaks and
   survey against the plain version's stride-256 norms;
5. CUDA-event times of the kernels, their plain versions and their
   yardsticks at the main paths' shapes: one 4M-sample cs8 chunk of the
   stream chain (D 32, 400 taps, W 64) for the frontend kernels and the
   v1 kernel (yardstick: cuDNN's ``conv1d`` over the mixed planes, TF32
   off), each ``fir_decimate`` impl at the chain's batch shapes, and one
   bank chunk (64 streams x 2000 windows x 1024 points) at strides 1024
   and 256 (yardstick: ``torch.fft.fft`` over the decoded frames), each
   waterfall kernel first held against its plain version on those inputs.
   A yardstick does part of its kernel's work; its inputs are made outside
   the timed region, and the port never calls it.

The line before the last but one holds the kernels' JSON record: their
errors taken at the main paths' shapes (the v1 kernel, which no path
runs, at the stream chain's chunk), launches over the main paths, times,
``bound_ms`` (the larger of the bytes in and out once over 3.35 TB/s and
the f32 operations over 67 TFLOP/s) with ``bound_by``, and
``library_ms``.  Then the card's name and power limit; the last line is
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
BANK_STREAMS = 64  # BASELINE config 5: 64 parallel cs8 streams, 1024 points
BANK_SAMPLES = 1 << 21  # per capture: 64 x 4 MiB of cs8
BANK_CHUNK = 2000  # the CLI's default -chunk 2k windows
WF_RTOL = 2e-5  # the JAX package's waterfall kernel tolerance
WF_WIDTHS = (256, 384, 640, 1024, 2048, 4096, 8192)  # phase 3: 2048 and up as one window per block
WF_WINDOWS = 301  # phase 3: no multiple of any window tile (8, 5, 3, 2 or 1 windows)
# phase 3, the staged loads' edge cases: (width, stride, windowing, view of
# the planes): hop 1 and hop N-1; a base pointer off every 16-byte boundary
# (a view 3 samples into its rows); rows of odd length (stream and plane
# strides no multiple of 16 bytes); width 640 (b = 5); 8192 at stride 1
WF_EDGE_CASES = [
    (256, 1, "rectangular", "contiguous"), (1024, 1, "blackman-harris", "sliced"),
    (1024, 1023, "rectangular", "sliced"), (1024, 256, "blackman-harris", "padded"),
    (640, 200, "blackman-harris", "padded"), (640, 640, "rectangular", "sliced"),
    (384, 384, "blackman-harris", "padded"), (8192, 1, "rectangular", "sliced"),
]
PREFIX_SAMPLES = 1 << 22  # phase 4: the prefix capture the CPU runs of the chain read
BANDED_OUT = 125_000 - 77  # phase 3: v1 outputs per case, the last 2048-output tile partial
# phase 5: the chain's FIR batches, (label, windows, decimate, taps, outputs
# per window): sparkfft -width 64 over the stream chain (the executor's
# 2^20-output budget), write's 0x1000-sample pulls, the same at 4000 taps
FIR_SHAPES = [("sparkfft batch", 16384, 32, 400, 64), ("write batch", 256, 32, 400, 0x1000),
              ("write batch, 4000 taps", 256, 32, 4000, 0x1000)]


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


def banded_inputs(fmt, d: int, taps: int, n_in: int, start: int, seed: int, n_out: int | None = None):
    """(spec, planes, bases, n_out) of the v1 kernel for ``n_in`` raw
    samples whose first sits at absolute ``start``, on the card; the
    planes advanced past the group delay as its callers do.  ``n_out``
    defaults to the outputs the samples cover."""
    from quadrs_tpu_torch.formats import synth_planes
    from quadrs_tpu_torch.ops import frontend as fe
    from quadrs_tpu_torch.ops.fir import lowpass_taps

    spec = fe.FrontendSpec(fmt, SAMPLE_RATE, 280_000, d, lowpass_taps(200_000 / SAMPLE_RATE, taps).tobytes())
    prefix = taps - taps // 2
    n_out = (n_in - taps) // d if n_out is None else n_out
    planes = torch.from_numpy(synth_planes(fmt, n_in, seed)).to(DEVICE)[:, prefix:]
    bases = torch.from_numpy(fe.tile_bases(spec, start + prefix, -(-n_out // 2048))).to(DEVICE)
    return spec, planes, bases, n_out


def phase_banded_kernel() -> tuple[float, float]:
    """Phase 3, the v1 kernel (``frontend_banded``) against its plain
    version: every format, D 1 to 64, 40 and 400 taps, the last
    2048-output tile partial; raw planes shorter than the tiles need (40
    taps) and an absolute offset near 1e9 (400 taps); two long filters;
    and one 4M-sample cs8 chunk at D 32, 400 taps (the stream chain's
    configuration).  Returns the error at that chunk."""
    from quadrs_tpu_torch.formats import FileFormat
    from quadrs_tpu_torch.ops import frontend as fe

    failures: list[str] = []
    n_main = chunk_len(bench_cfg(FileFormat.COMPLEX_INT8))
    spec, planes, bases, n_out = banded_inputs(FileFormat.COMPLEX_INT8, 32, 400, n_main, 0, SEED)
    at_main = compare("frontend_banded cs8 D32 400 taps, one 4M-sample chunk",
                      fe.fused_frontend(planes, bases, spec, n_out), fe.fused_frontend_reference(planes, bases, spec, n_out),
                      failures)
    cases = [(fmt, d, taps) for fmt in FileFormat for d in (1, 4, 8, 32, 64) for taps in (40, 400)]
    cases += [(FileFormat.COMPLEX_UINT8, 32, 4000), (FileFormat.COMPLEX_INT16, 64, 8192)]
    for fmt, d, taps in cases:
        full = BANDED_OUT * d + taps
        n_in, start, label = full, 0, ""
        if taps == 40:
            n_in, label = int(full * 0.7), ", short planes"
        elif taps == 400:
            start, label = 999_999_937, ", offset 999999937"
        spec, planes, bases, _ = banded_inputs(fmt, d, taps, n_in, start, d + taps, BANDED_OUT)
        got = fe.fused_frontend(planes, bases, spec, BANDED_OUT)
        want = fe.fused_frontend_reference(planes, bases, spec, BANDED_OUT)
        compare(f"frontend_banded {fmt.value} D{d} {taps} taps{label}", got, want, failures)
    if failures:
        raise AssertionError(f"the v1 kernel disagrees with its plain version: {failures}")
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


def run_cli(argv: list[str], expect_rc: int = 0, err_has: str = "") -> str:
    """Run the port's CLI in this process; print the command and its
    output (the first and last lines of a long one); raise unless it exits
    ``expect_rc`` with ``err_has`` in its standard error."""
    from quadrs_tpu_torch.cli import main

    buf, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(err):
        rc = main(argv)
    out = buf.getvalue()
    lines = out.strip().splitlines()
    if len(lines) > 12:
        lines = lines[:5] + [f"... ({len(lines)} lines)"] + lines[-3:]
    print("  $ python -m quadrs_tpu_torch " + " ".join(argv))
    lines = [line if len(line) <= 160 else f"{line[:150]} ... ({len(line)} chars)" for line in lines]
    print("    " + "\n    ".join(lines + err.getvalue().strip().splitlines()))
    if rc != expect_rc or err_has not in err.getvalue():
        raise AssertionError(f"{argv[0]} exited {rc}: {err.getvalue().strip()}")
    return out


def phase_main_path(card: str, path: str, tmp: str) -> dict[str, int]:
    """Phase 4, the stream: the CLI's stream path over the 2^26-sample
    capture at ``path``; returns each kernel's launches over the phase."""
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


SPARK_BOUNDS = np.concatenate([[0.08, 1.0], np.float32(0.08) + (np.float32(1.0) - np.float32(0.08)) / np.float32(7.0)
                               * np.arange(1, 7, dtype=np.float32)]).astype(np.float32)


def all_launches() -> dict[str, int]:
    from quadrs_tpu_torch.ops import frontend as fe
    from quadrs_tpu_torch.ops import waterfall as wf

    return {k.__name__: k.launches for k in (fe.frontend_fir, fe.frontend_fir_stft, fe.frontend_banded,
                                             wf.waterfall_norms, wf.waterfall_search, wf.waterfall_scan)}


def phase_chain_path(card: str, cap: str, tmp: str) -> dict[str, float]:
    """Phase 4, the reference chain: the port's CLI over the 2^26-sample
    capture on the card (sparkfft, bucket, write, the 4000-tap write that
    takes os_poly, and stream outside the fused envelope), each checked
    against the same argv on the CPU over a 2^22-sample prefix capture.
    The chain is torch ops: no kernel of the port may launch.  Returns
    each run's wall seconds."""
    from quadrs_tpu_torch.ops.stft import stft_norms
    from quadrs_tpu_torch.runtime import Executor
    from quadrs_tpu_torch.sources import open_capture
    from quadrs_tpu_torch.stream import LowPass, Shift

    pre = os.path.join(tmp, "prefix.sr21M.cs8")
    with open(cap, "rb") as f, open(pre, "wb") as g:
        g.write(f.read(PREFIX_SAMPLES * 2))
    if torch.backends.cuda.matmul.allow_tf32 is not False:
        raise AssertionError("TF32 matmuls are on: the chain's products would keep ~3 digits")
    lp200 = ["shift", "280k", "lowpass", "-power", "200", "-decimate", "32", "200k"]
    lp2000 = ["shift", "280k", "lowpass", "-power", "2000", "-decimate", "32", "200k"]
    walls: dict[str, float] = {}

    def both(name: str, argv, expect_rc=0, err=("", "")):
        """``argv(capture, tag)`` on the card over the capture, then on the
        CPU over the prefix; returns both stdouts."""
        os.environ.pop("QUADRS_PLATFORM", None)  # the CLI's default device: cuda
        before = all_launches()
        t0 = time.perf_counter()
        out = run_cli(argv(cap, "gpu"), expect_rc, err[0])
        walls[name] = time.perf_counter() - t0
        launched = {k: v - before[k] for k, v in all_launches().items() if v != before[k]}
        print(f"    {name}: {walls[name]:.3f}s, {CAPTURE_SAMPLES / walls[name] / 1e6:.1f} Msps ({card}); "
              f"kernel launches: {launched or 'none'}")
        if launched:
            raise AssertionError(f"{name} launched {launched}: the chain runs as torch ops")
        os.environ["QUADRS_PLATFORM"] = "cpu"
        try:
            cpu_out = run_cli(argv(pre, "cpu"), expect_rc, err[1])
        finally:
            os.environ.pop("QUADRS_PLATFORM", None)
        return out, cpu_out

    def chain_stream(path, taps_power=200):
        return LowPass(Shift(open_capture(path), 280_000), 200_000, 32, 2 * taps_power)

    # sparkfft: rows equal except glyphs whose plain norm is within f32 noise of a level
    out, cpu_out = both("sparkfft", lambda path, tag: ["from", path, *lp200, "sparkfft", "-width", "64", "-stride", "16"])
    rows, cpu_rows = out.splitlines()[1:], cpu_out.splitlines()[1:]
    length = 1 + (CAPTURE_SAMPLES - 400) // 32
    if len(rows) != len(range(0, length - 64, 16)) or not cpu_rows:
        raise AssertionError(f"sparkfft printed {len(rows)} rows for a {length}-sample stream")
    bad = [r for r in range(len(cpu_rows)) if rows[r] != cpu_rows[r]]
    near = 0
    if bad:
        norms = Executor(chain_stream(pre), 64, "cpu", post=stft_norms).run(np.asarray(bad, dtype=np.int64) * 16)[0]
        for i, r in enumerate(bad):
            for k, (a, b) in enumerate(zip(rows[r][1:-1], cpu_rows[r][1:-1])):
                if a != b:
                    margin = float(np.abs(SPARK_BOUNDS - norms[i, k]).min() / max(float(norms[i, k]), 1e-12))
                    if margin > TOL:
                        raise AssertionError(f"sparkfft row {r} bin {k}: {a!r} vs {b!r}, {margin:.2e} from a level")
                    near += 1
    print(f"  sparkfft: {len(cpu_rows)} rows of the prefix compared, {len(bad)} differ, {near} glyphs within "
          f"{TOL} of a level")

    # bucket: digits equal except near-ties of the plain half sums
    out, cpu_out = both("bucket", lambda path, tag: ["from", path, *lp200, "bucket", "-by", "freq", "2"])
    digits, cpu_digits = out.strip(), cpu_out.strip()
    if len(digits) != (length - 128) // 128 or set(digits) - {"0", "1"}:
        raise AssertionError(f"bucket printed {len(digits)} digits for a {length}-sample stream")
    bad = [i for i in range(len(cpu_digits)) if digits[i] != cpu_digits[i]]
    if bad:
        def halves(x):
            n = stft_norms(x, shift=False)
            return n[:, :64].sum(1), n[:, 64:].sum(1)

        first, second = Executor(chain_stream(pre), 128, "cpu", post=halves).run(np.asarray(bad, dtype=np.int64) * 128)[0]
        if (np.abs(first - second) > TOL * np.maximum(first, second)).any():
            raise AssertionError("bucket digits differ away from a near-tie")
    print(f"  bucket: {len(cpu_digits)} digits of the prefix compared, {len(bad)} differ (near-ties)")

    # write: the decimated file stream ends on the reference's zero-length read
    for name, lp, size in (("write", lp200, 400), ("write (4000 taps, os_poly)", lp2000, 4000)):
        full_len, pre_len = (1 + (n - size) // 32 for n in (CAPTURE_SAMPLES, PREFIX_SAMPLES))
        both(name, lambda path, tag: ["from", path, *lp, "write", os.path.join(tmp, f"{tag}{size}")], 1,
             (f"short read at offset {full_len - 1} of {full_len}", f"short read at offset {pre_len - 1} of {pre_len}"))
        got = np.fromfile(os.path.join(tmp, f"gpu{size}.sr656250.cf32"), np.complex64)
        want = np.fromfile(os.path.join(tmp, f"cpu{size}.sr656250.cf32"), np.complex64)
        same = (PREFIX_SAMPLES - size) // (0x1000 * 32) * 0x1000  # the prefix's full 0x1000-sample pulls
        if got.shape != (full_len - 1,) or not np.isfinite(got).all():
            raise AssertionError(f"{name} wrote {got.shape} samples of a {full_len}-sample stream")
        err = float(np.abs(got[:same] - want[:same]).max())
        scale = float(np.abs(want[:same]).max())
        print(f"  {name}: {got.shape[0]} samples written; the prefix's first {same}: max |diff| {err:.3e}, "
              f"scale {scale:.4g}, err/scale {err / scale:.3e}")
        if err > 1e-5 * scale:
            raise AssertionError(f"{name} disagrees with the CPU run")

    # stream outside the fused envelope: the chain route
    both("stream -decimate 100", lambda path, tag: ["stream", "-shift", "280k", "-decimate", "100", "-chunk",
                                                   str(CHUNK), "-out", os.path.join(tmp, tag), path])
    got = np.fromfile(os.path.join(tmp, "gpu.norms.f32"), np.float32).reshape(-1, 64)
    want = np.fromfile(os.path.join(tmp, "cpu.norms.f32"), np.float32).reshape(-1, 64)
    first = CHUNK // (100 * 64)  # windows of the first chunk, the same samples in both captures
    if got.shape[0] != CAPTURE_SAMPLES // 6400 or not np.isfinite(got).all():
        raise AssertionError(f"stream -decimate 100 wrote {got.shape[0]} windows")
    compare("stream -decimate 100, first chunk (card vs CPU)", torch.from_numpy(got[:first]), torch.from_numpy(want[:first]))
    return walls


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
    for every format, widths 256 to 8192 (640 among them), strides tiled,
    width/4, 96 and width+300, both windowings, over 301 windows (no
    multiple of any window tile); then :data:`WF_EDGE_CASES` for every
    format."""
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
    for width, stride, windowing, view in WF_EDGE_CASES:
        streams = 64 if width <= 1024 else 8
        n = (nw - 1) * stride + width + 5
        extra = {"contiguous": 0, "sliced": 3, "padded": 5 + (n + 5) % 2 + 1}[view]
        for k, fmt in enumerate(FileFormat):
            raw = synth_on_device(fmt, (streams, 2, n + extra), seed=width + stride + k)
            planes = raw[:, :, 3:] if view == "sliced" else raw[:, :, :n]
            spec = wf.WaterfallSpec(fmt, width, windowing)
            tables = wf.waterfall_tables(spec, device=DEVICE)
            label = (f"{fmt.value} W{width} stride {stride} {windowing} {view} (strides {planes.stride()}, "
                     f"offset {planes.storage_offset()}) {streams}x{nw}")
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


HBM_BYTES_PER_S = 3.35e12  # one H100 SXM: peak HBM3 rate
F32_FLOPS = 67e12  # f32 outside the tensor cores


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    """(the least ms the card could take: bytes over the HBM rate or
    operations over the f32 peak, the larger; which of the two it is)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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

    # the yardstick: one cuDNN call, the decimating FIR over the decoded,
    # already-mixed planes (part of the kernels' work), in full f32
    torch.backends.cudnn.allow_tf32 = False
    from quadrs_tpu_torch.formats import decode_plane
    from quadrs_tpu_torch.ops.fir import lowpass_taps

    n_in = n_out * cfg.decimate + cfg.taps - 1
    z = torch.complex(decode_plane(planes[0, :n_in], cfg.fmt), decode_plane(planes[1, :n_in], cfg.fmt))
    ph = torch.arange(n_in, dtype=torch.float64, device=DEVICE) * (-2 * np.pi * cfg.shift_freq / cfg.sample_rate)
    z = z * torch.polar(torch.ones_like(ph), ph).to(torch.complex64)
    x = torch.stack([z.real, z.imag])[:, None].contiguous()  # (2, 1, n_in) mixed planes
    h = torch.from_numpy(lowpass_taps(cfg.lp_freq / cfg.sample_rate, cfg.taps)[::-1].copy()).view(1, 1, -1).to(DEVICE)

    variants = {
        "kernel1": lambda: fe.frontend_fir(planes, bases, tables, spec, n_out, n_ok),
        "kernel1+stft_norms": lambda: unfused_norms(fe.frontend_fir(planes, bases, tables, spec, n_out, n_ok)),
        "kernel2": lambda: fe.frontend_fir_stft(planes, bases, tables, spec, n_out, n_ok, w),
        "plain": lambda: fe.fused_frontend_t_reference(planes, bases, spec, n_out, n_ok, tables),
        "plain+stft_norms": lambda: unfused_norms(fe.fused_frontend_t_reference(planes, bases, spec, n_out, n_ok, tables)),
        "plain_stft_epilogue": lambda: fe.fused_frontend_t_reference(planes, bases, spec, n_out, n_ok, tables, w),
        "library_conv1d": lambda: torch.nn.functional.conv1d(x, h, stride=cfg.decimate),
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
    # the bounds: bytes in (planes, bases) and out once; f32 operations
    # of the FIR (4 per tap and output) and the mix (6 per sample), plus
    # the STFT's 5 W log2 W per window for kernel 2
    fir_flops = 4 * n_out * cfg.taps + 6 * samples
    in_bytes = planes.numel() * planes.element_size() + bases.numel() * bases.element_size()
    ms["bound kernel1"] = bound(in_bytes + 8 * n_out, fir_flops)
    ms["bound kernel2"] = bound(in_bytes + 4 * n_out, fir_flops + n_out * 5 * int(np.log2(w)))
    return ms


def phase_chain_timing(card: str) -> dict[str, float]:
    """Phase 5, the v1 kernel and the chain's FIR: CUDA-event times of
    ``frontend_banded`` and its plain version at one 4M-sample cs8 chunk
    (D 32, 400 taps), in mirrored order; then of each ``fir_decimate``
    impl at the chain's batch shapes (the ``auto`` thresholds and frame
    sizes are the JAX package's, measured on a TPU v5e)."""
    from quadrs_tpu_torch.formats import FileFormat
    from quadrs_tpu_torch.ops import frontend as fe
    from quadrs_tpu_torch.ops.fir import IMPLS, auto_impl, fir_decimate, lowpass_taps

    n = chunk_len(bench_cfg(FileFormat.COMPLEX_INT8))
    spec, planes, bases, n_out = banded_inputs(FileFormat.COMPLEX_INT8, 32, 400, n, 0, SEED)
    tables = fe.banded_tables(spec, device=DEVICE)
    variants = {
        "banded": lambda: fe.frontend_banded(planes, bases, tables, spec, n_out),
        "plain_banded": lambda: fe.fused_frontend_reference(planes, bases, spec, n_out),
    }
    runs: dict[str, list[float]] = {k: [] for k in variants}
    for k in list(variants) + list(reversed(variants)):
        runs[k].append(time_ms(variants[k]))
    ms = {k: sum(v) / len(v) for k, v in runs.items()}
    print(f"  timing: the v1 kernel at one cs8 chunk of {n} samples, D 32, 400 taps ({card})")
    for k, v in runs.items():
        print(f"    {k:14s} {ms[k]:.4f} ms  (runs {', '.join(f'{x:.4f}' for x in v)})  {n / ms[k] / 1e3:.1f} Msps")

    g = torch.Generator(device=DEVICE).manual_seed(SEED)
    for label, b, d, taps, n_out in FIR_SHAPES:
        n_in = n_out * d + taps
        x = torch.complex(torch.randn((b, n_in), generator=g, device=DEVICE),
                          torch.randn((b, n_in), generator=g, device=DEVICE))
        h = lowpass_taps(200_000 / SAMPLE_RATE, taps)
        ref = fir_decimate(x, h, d, n_out, impl="polyphase")
        line = []
        for impl in IMPLS:
            if impl == "direct" and taps > 1000:
                line.append(f"{impl} not measured (its frames would take {b * n_out * taps * 8 / 2**30:.0f} GiB)")
                continue
            err = float((fir_decimate(x, h, d, n_out, impl=impl) - ref).abs().max())
            t = time_ms(lambda: fir_decimate(x, h, d, n_out, impl=impl), iters=5)
            ms[f"fir {impl} @ {label}"] = t
            line.append(f"{impl} {t:.3f} ms ({b * n_in / t / 1e3:.0f} Msps in, |diff| vs polyphase {err:.1e})")
        print(f"  fir_decimate at the {label}: {b} x {n_in} -> {n_out}, D {d}, {taps} taps, auto takes "
              f"{auto_impl(taps, d, b * n_out)} ({card})")
        for item in line:
            print(f"    {item}")
        del x, ref
    return ms


def phase_waterfall_timing(card: str, at_main: dict[str, tuple[float, float]]) -> dict[str, float]:
    """Phase 5, the bank: CUDA-event times of each waterfall kernel and
    its plain version at one full chunk, 64 streams x 2000 windows x 1024
    points of cs8, at strides 1024 and 256, in mirrored order; each
    kernel is first held against its plain version on those inputs
    (folded into ``at_main``)."""
    from quadrs_tpu_torch.formats import FileFormat, decode_plane
    from quadrs_tpu_torch.ops import waterfall as wf
    from quadrs_tpu_torch.ops.fir import overlapped_frames

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
        # the yardstick: one cuFFT call over the decoded (S*nw, 1024)
        # complex64 frames, made outside the timed region (part of the work)
        z = torch.complex(decode_plane(planes[:, 0], spec.fmt), decode_plane(planes[:, 1], spec.fmt))
        frames = overlapped_frames(z, stride, 1024, nw).reshape(-1, 1024).contiguous()
        variants = {
            "library_fft": lambda: torch.fft.fft(frames),
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
        del frames, z
        # the bounds: the samples the windows cover read once (2 bytes each)
        # and the outputs written once; 5 N log2 N f32 operations per window
        span = (nw - 1) * stride + 1024 if stride < 1024 else nw * 1024
        flops = BANK_STREAMS * nw * 5 * 1024 * 10
        for k, out_bytes in (("norms", 4 * nw * 1024), ("search", 8 * nw), ("scan", 12 * 1024)):
            ms[f"bound {k}@{stride}"] = bound(BANK_STREAMS * (2 * span + out_bytes), flops)
    return ms


def ptxas_usage(log: str) -> list[tuple[str, str]]:
    """(kernel, ptxas's registers / shared memory / spills) from the build
    log: every frontend kernel, and the waterfall body's cs8
    instantiations (the other formats differ in the decode only)."""
    import re

    out: dict[str, list[str]] = {}
    name = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            wf = re.search(r"waterfall_kernelI(\w)Li(\d)ELi(\d+)E", m.group(1))
            other = re.search(r"\d+([a-z_]+_kernel)(?:I(\w+?)E)?E", m.group(1))
            if wf:
                t, mode, ln = wf.groups()
                name = None if t != "a" else (f"waterfall_kernel<int8, {('norms', 'search', 'scan')[int(mode)]}, "
                                              f"{'width 2^' + ln if ln != '0' else 'any width'}>")
            else:
                name = f"{other.group(1)}<{other.group(2) or ''}>" if other else m.group(1)[-48:]
        elif name and ("Used" in line or "spill" in line):
            out.setdefault(name, []).append(line.split(":", 1)[-1].strip() if "Used" in line else line.strip())
    return [(k, "; ".join(v)) for k, v in out.items()]


def sass_mix(lib_path) -> list[str]:
    """The instruction mix of the cs8 waterfall body at 1024 points, one
    line per mode, from ``cuobjdump -sass`` of the built library: static
    instructions in all, FP (FADD, FMUL, FFMA, MUFU), shared-memory
    (LDS, STS), global (LDG, STG) and barriers.  Empty without cuobjdump."""
    import collections
    import re
    from torch.utils.cpp_extension import CUDA_HOME

    tool = os.path.join(CUDA_HOME or "/usr/local/cuda", "bin", "cuobjdump")
    if not os.path.exists(tool):
        return []
    sass = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True, text=True, timeout=300).stdout
    lines = []
    for body in re.split(r"\n\s*Function : ", sass)[1:]:
        m = re.search(r"waterfall_kernelIaLi(\d)ELi10E", body.split("\n", 1)[0])
        if not m:
            continue
        ops = collections.Counter(o.split(".")[0] for o in re.findall(
            r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]+)", body))
        group = {k: sum(ops[o] for o in v) for k, v in (
            ("FP", ("FADD", "FMUL", "FFMA", "MUFU")), ("shared", ("LDS", "STS")), ("global", ("LDG", "STG")),
            ("barriers", ("BAR",)))}
        lines.append(f"waterfall_kernel<int8, {('norms', 'search', 'scan')[int(m.group(1))]}, width 2^10>: "
                     f"{sum(ops.values())} instructions, " + ", ".join(f"{k} {v}" for k, v in group.items()))
    return lines


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
    for name, used in ptxas_usage(lib.build_log):
        print(f"    {name}: {used}")
    for line in sass_mix(lib.path):
        print(f"    {line} (cuobjdump -sass)")
    print("phase 3: kernels against their plain versions")
    at_main = phase_kernels()
    at_main["frontend_banded"] = phase_banded_kernel()
    phase_waterfall_kernels()
    print("phase 4: the main paths")
    from quadrs_tpu_torch.ops import frontend as fe

    fe.frontend_banded.launches = 0  # counts of the main paths only, from here
    with tempfile.TemporaryDirectory() as tmp:
        cap = os.path.join(tmp, "smoke.sr21M.cs8")
        write_capture(cap, CAPTURE_SAMPLES)
        launches = phase_main_path(card, cap, tmp)
        phase_chain_path(card, cap, tmp)
    bank_launches, bank_err = phase_bank_path(card)
    launches.update(bank_launches)
    # no path of the JAX package runs the v1 function, so no main path of
    # the port may: it is held to its plain version in phases 3 and 5
    launches["frontend_banded"] = fe.frontend_banded.launches
    print(f"  frontend_banded: {launches['frontend_banded']} launches over the main paths")
    if launches["frontend_banded"]:
        raise AssertionError("a main path launched frontend_banded")
    at_main.update(bank_err)
    print("phase 5: timing")
    ms = phase_timing(card)
    ms.update(phase_chain_timing(card))
    wf_ms = phase_waterfall_timing(card, at_main)

    # errors at the main paths' shapes: max_abs_err, and err_over_max
    # (that over the max of the plain output; for scan, the sum error
    # per window or the max error, whichever is larger)
    # library_ms: one PyTorch call that does part of each kernel's work
    # (no single call computes these functions): conv1d over the mixed
    # planes for the frontend kernels, torch.fft.fft over the decoded
    # frames for the waterfall kernels.  The v1 kernel's bound and
    # yardstick are kernel 1's: the same chunk and FIR (its trig not counted)
    src = "quadrs_tpu_torch/csrc/frontend.cu"
    conv = {"library_ms": ms["library_conv1d"], "library": "conv1d over the mixed planes (covers part of the work)"}
    kernels = [
        {"name": "frontend_fir", "route": "cuda", "source": src,
         "replaces": "quadrs_tpu/ops/frontend_pallas.py:409", "launches": launches["frontend_fir"],
         "ms": ms["kernel1"], "plain_ms": ms["plain"], "bound": ms["bound kernel1"], **conv},
        {"name": "frontend_fir_stft", "route": "cuda", "source": src,
         "replaces": "quadrs_tpu/ops/frontend_pallas.py:513", "launches": launches["frontend_fir_stft"],
         "ms": ms["kernel2"], "plain_ms": ms["plain_stft_epilogue"], "bound": ms["bound kernel2"], **conv},
        {"name": "frontend_banded", "route": "cuda", "source": src,
         "replaces": "quadrs_tpu/ops/frontend_pallas.py:146", "launches": launches["frontend_banded"], "path": None,
         "ms": ms["banded"], "plain_ms": ms["plain_banded"], "bound": ms["bound kernel1"], **conv},
    ]
    # each waterfall kernel at the stride of its main-path run
    for name, line, key, stride in (("waterfall_norms", 149, "norms", 1024), ("waterfall_search", 219, "search", 256),
                                    ("waterfall_scan", 787, "scan", 256)):
        kernels.append({"name": name, "route": "cuda", "source": "quadrs_tpu_torch/csrc/waterfall.cu",
                        "replaces": f"quadrs_tpu/ops/waterfall_pallas.py:{line}", "launches": launches[name],
                        "ms": wf_ms[f"{key}@{stride}"], "plain_ms": wf_ms[f"plain_{key}@{stride}"],
                        "bound": wf_ms[f"bound {key}@{stride}"], "library_ms": wf_ms[f"library_fft@{stride}"],
                        "library": "torch.fft.fft over the decoded frames (covers part of the work)"})
    for k in kernels:
        k["max_abs_err"], k["err_over_max"] = at_main[k["name"]]
        k["bound_ms"], k["bound_by"] = k.pop("bound")
        k["roofline_share"] = k["bound_ms"] / k["ms"]
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
