"""The bench's entries: one measured JSON line each.

The counterpart of the root ``bench_suite.py`` of the JAX package, entry
for entry, at the same shapes and lengths, through the port's own
modules.  :mod:`quadrs_tpu_torch.bench` runs them, the headline first,
and prints each line as soon as it is measured:

* ``bench_cs16_sustained``: cs16 decode -> shift -> lowpass(dec 64) -> STFT
* ``bench_long_fir``: the power=2000 (4000-tap) chain over cf32
* ``bench_waterfall``: 64 cs8 streams, 1024-point STFT (``waterfall_norms``)
* ``bench_waterfall_strided``: the same bank at 4x window overlap, with
  its search and the 4096-point and stride-96 shapes
* ``bench_waterfall_search``: the bank reduced to peak bins, and the
  band survey (``waterfall_search``, ``waterfall_scan``)
* ``bench_channelizer``, ``bench_resample``, ``bench_find``: the
  polyphase bank, the 147/160 resampler, pattern search
* ``bench_fm``, ``bench_am``, ``bench_ssb``, ``bench_fsk``, ``bench_ook``,
  ``bench_psk``: the receivers' streaming dispatches and their tails
* ``bench_disk_staging``, ``bench_disk_sustained``,
  ``bench_long_fir_sustained``, ``bench_staging_workers``: the 1G-sample
  cs8 capture through the loader, the page-locked rings and
  :class:`~quadrs_tpu_torch.stream_runner.StreamRunner`

A compute entry times its step with CUDA events
(:func:`~quadrs_tpu_torch.utils.timing.measure_msps`); an entry whose work
includes the host reads the host clock after a synchronize
(:func:`~quadrs_tpu_torch.utils.timing.wall_clock`).  Each keeps its JAX
counterpart's field names, but for the TPU's: ``pct_f32_peak`` names the
H100's f32 rate where the JAX line had ``pct_f32_matmul_peak`` (the v5e's
MXU), and ``bench_find`` has no MXU FFT columns.  The JAX steps' gain
cycles and accumulators, which kept jit from caching or skipping work,
are left out: eager PyTorch enqueues every call.

An entry whose route reaches a ported kernel records the kernels it
launched while it was timed (``launches``), fails on the card when none
did, and holds one step against the kernel's plain version, outside the
timed window.  A roofline share above 100% fails the entry: the flop or
byte model would be wrong.
"""

from __future__ import annotations

import math
import os
import threading
from dataclasses import dataclass

import numpy as np
import torch

from quadrs_tpu_torch.formats import FileFormat
from quadrs_tpu_torch.models import demod
from quadrs_tpu_torch.models.receiver import PipelineConfig, PipelineModel
from quadrs_tpu_torch.models.waterfall import WaterfallConfig, WaterfallModel
from quadrs_tpu_torch.ops import frontend as fe
from quadrs_tpu_torch.ops import waterfall as wf
from quadrs_tpu_torch.ops.channelizer import channelize_block
from quadrs_tpu_torch.ops.correlate import make_xcorr_post
from quadrs_tpu_torch.ops.fir import fir_decimate, lowpass_taps
from quadrs_tpu_torch.ops.resample import resample_block, resample_tables
from quadrs_tpu_torch.ops.stft import stft_norms
from quadrs_tpu_torch.sinks import FIND_DISPATCH_BUDGET, FIND_TOPK
from quadrs_tpu_torch.sources import PipeSource, SampleSource
from quadrs_tpu_torch.staging import UploadRing
from quadrs_tpu_torch.stream_runner import StreamRunner
from quadrs_tpu_torch.utils.timing import measure_msps, wall_clock

# -- roofline constants: one H100 SXM (the data sheet, dense, 700 W) -------
H100_F32_TFLOPS = 67.0  # f32 outside the tensor cores
H100_HBM_GBPS = 3350.0

FRONTEND_TOL = 5e-5  # of the plain output's max: the frontend kernels' bound (chip_smoke.py)
WATERFALL_RTOL = 2e-5  # the JAX package's waterfall kernel tolerance
UNIT = "Msamples/sec/card"

# the stream chain's configurations: BASELINE's (bench.py:31-43 of the JAX
# package), the cs16 stretch config, and the power=2000 chain over cf32
# and over the cs8 capture
HEADLINE_CFG = PipelineConfig(sample_rate=21_000_000, shift_freq=280_000, lp_freq=200_000, decimate=32, taps=400,
                              fft_width=64, fmt=FileFormat.COMPLEX_INT8)
CS16_CFG = PipelineConfig(sample_rate=61_440_000, shift_freq=1_000_000, lp_freq=480_000, decimate=64, taps=512,
                          fft_width=64, fmt=FileFormat.COMPLEX_INT16)
LONG_FIR_CFG = PipelineConfig(sample_rate=21_000_000, shift_freq=280_000, lp_freq=50_000, decimate=32,
                              taps=4000,  # lowpass -power 2000
                              fft_width=64, fmt=FileFormat.COMPLEX_FLOAT32)
LONG_FIR_CS8_CFG = PipelineConfig(sample_rate=21_000_000, shift_freq=280_000, lp_freq=50_000, decimate=32,
                                  taps=4000, fft_width=64, fmt=FileFormat.COMPLEX_INT8)

# the entries whose route reaches a ported kernel
KERNEL_ENTRIES = (
    "headline",
    "bench_cs16_sustained",
    "bench_long_fir",
    "bench_waterfall",
    "bench_waterfall_strided",
    "bench_waterfall_search",
    "bench_disk_sustained",
    "bench_long_fir_sustained",
)


@dataclass(frozen=True)
class Scale:
    """How large a run is.

    ``full``: the JAX bench's accelerator shapes, lengths and timing
    windows.  ``quick``: the same shapes and lengths, 0.25 s windows, one
    rep, and the 1G-sample captures cut to 2^28 samples.  ``smoke``: the
    same shapes at lengths below the JAX package's CPU sizes, 0.02 s
    windows (the CPU tests).  ``workdir``: where the synthetic captures
    are written, and kept for the next run."""
    mode: str
    device: torch.device
    workdir: str

    def size(self, card: int, smoke: int) -> int:
        return smoke if self.mode == "smoke" else card

    def secs(self, full: float) -> float:
        return {"full": full, "quick": 0.25, "smoke": 0.02}[self.mode]

    @property
    def capture_samples(self) -> int:
        return {"full": 1 << 30, "quick": 1 << 28, "smoke": 1 << 18}[self.mode]

    def measure(self, step, samples: int, secs: float, min_iters: int = 2, reps: int = 2,
                stats_out: dict | None = None) -> float:
        return measure_msps(step, samples, self.secs(secs), min_iters=min_iters,
                            reps=reps if self.mode == "full" else 1, stats_out=stats_out, device=self.device)


# -- flop and byte models (the JAX bench's) -------------------------------


def chain_flops_per_sample(taps: int, decimate: int, fft_width: int, mixed: bool = True) -> float:
    """Algorithmic (direct-form-equivalent) FLOPs per *input* sample of
    the shift -> FIR(decimate) -> STFT chain: complex NCO mix 6; real-tap
    complex FIR 4·taps per output at rate 1/D; complex FFT by the
    standard 5·W·log2(W) convention plus 4·W for the norms.  This counts
    useful work, independent of implementation."""
    f = 6.0 if mixed else 0.0
    f += 4.0 * taps / decimate
    f += (5.0 * math.log2(fft_width) + 4.0) / decimate
    return f


def stft_flops_per_sample(fft_width: int, stride: int) -> float:
    """Waterfall bank: FFT + norms per input sample at window stride."""
    return (5.0 * fft_width * math.log2(fft_width) + 4.0 * fft_width) / stride


def roofline(msps: float, flops_ps: float, bytes_ps: float,
             peak_tflops: float = H100_F32_TFLOPS, peak_gbps: float = H100_HBM_GBPS) -> dict:
    """A measured rate's roofline position: algorithmic GFLOP/s and its
    share of the f32 peak, minimal memory traffic GB/s (native input read
    once, f32 output written once) and its share of the HBM peak.  A share
    above 100% raises: the model undercounts what the card can do."""
    g = msps * 1e6 * flops_ps / 1e9
    bw = msps * 1e6 * bytes_ps / 1e9
    out = {
        "gflops": g,
        "pct_f32_peak": 100.0 * g / (peak_tflops * 1e3),
        "hbm_gbps": bw,
        "pct_hbm_peak": 100.0 * bw / peak_gbps,
    }
    over = [k for k in ("pct_f32_peak", "pct_hbm_peak") if out[k] > 100.0]
    if over:
        raise ValueError(f"{', '.join(over)} above 100% at {msps:.1f} Msps: the flop or byte model is wrong")
    return out


def _combined(chain_msps: float, tail_msps: float, decimate: int) -> float:
    """End-to-end input rate of chain + tail stages run back to back:
    the tail consumes channel-rate samples (1/decimate of the input)."""
    return 1.0 / (1.0 / chain_msps + 1.0 / (decimate * tail_msps))


# -- kernel use and output checks ------------------------------------------


_KERNELS = (fe.frontend_fir, fe.frontend_fir_stft, wf.waterfall_norms, wf.waterfall_search, wf.waterfall_scan)


def launch_counts() -> dict[str, int]:
    """Each ported kernel's launch counter."""
    return {k.__name__: k.launches for k in _KERNELS}


def record_launches(entry: dict, before: dict[str, int], sc: Scale, want: tuple[str, ...]) -> None:
    """Put the launches since ``before`` into ``entry``; on the card,
    raise unless every kernel of ``want`` was launched."""
    after = launch_counts()
    entry["launches"] = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    missing = [k for k in want if not entry["launches"].get(k)]
    if sc.device.type == "cuda" and missing:
        raise RuntimeError(f"the route launched no {', '.join(missing)}: it did not reach the ported kernel")


def _held(what: str, got: torch.Tensor, want: torch.Tensor, tol: float) -> float:
    """``max |got - want| / max |want|``; raises past ``tol``, on a shape
    mismatch or on a non-finite value."""
    if got.shape != want.shape or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{what}: shape {tuple(got.shape)} against {tuple(want.shape)}, or non-finite values")
    scale = max(float(want.abs().max()), 1e-6)
    err = float((got - want).abs().max()) / scale
    if err > tol:
        raise AssertionError(f"{what}: error {err:.3e} of scale, over {tol:.0e}")
    return err


def check_frontend(model, raw: torch.Tensor) -> float:
    """One chunk through the model's frontend (the kernel on the card)
    against the kernel's plain version on the same tensors; returns the
    error over the scale.  ``raw``: (2, n) native planes, the ``taps``
    halo included, at absolute offset 0."""
    cfg = model.cfg
    prefix = cfg.taps - cfg.taps // 2
    n_out = (raw.shape[1] - cfg.taps) // cfg.decimate // cfg.fft_width * cfg.fft_width
    bases = torch.from_numpy(model.stream_bases(0, raw.shape[1])).to(raw.device)
    planes, spec, tables = raw[:, prefix:], model.frontend_spec, model.frontend_tables()
    got = fe.fused_frontend_t(planes, bases, spec, n_out, tables=tables)
    want = fe.fused_frontend_t_reference(planes, bases, spec, n_out, planes.shape[1], tables)
    return _held("frontend_fir", got, want, FRONTEND_TOL)


def check_waterfall(model, raw: torch.Tensor, mode: str) -> float:
    """The model's ``norms``, ``search`` or ``scan`` step against the
    plain version's norms, at the JAX package's waterfall tolerances: norms
    ``rtol=2e-5, atol=2e-5·max``; peak bins exact but at near-ties,
    magnitudes ``rtol=2e-5``; scan sums ``windows·2e-5·max``, maxima
    ``2e-5·max``, counts exact but for norms within ``2e-5·max`` of the
    threshold (the median norm).  Returns the error over the max norm."""
    nw, stride, tol = model.n_windows(raw.shape[-1]), model.cfg.stride, WATERFALL_RTOL
    want = wf.fused_waterfall_reference(raw, model.spec, nw, stride=stride, window=model.window)
    peak = float(want.max())
    if mode == "norms":
        got = model.step(raw)
        bad = got.shape != want.shape or not bool(torch.isfinite(got).all()) or bool(
            ((got - want).abs() > tol * want.abs() + tol * peak).any())
        err = float((got - want).abs().max())
    elif mode == "search":
        idx, val = model.search(raw)
        top = want.amax(-1)
        picked = want.gather(-1, idx.long()[..., None])[..., 0]
        tie = (idx == want.argmax(-1)) | ((picked - top).abs() <= tol * top)
        err = float((val - top).abs().max())
        bad = not bool(tie.all()) or bool(((val - top).abs() > tol * top).any())
    else:
        thr = float(want.median())
        ssum, smax, cnt = model.scan(raw, thr)
        sum_err = float((ssum.double() - want.double().sum(1)).abs().max())
        max_err = float((smax - want.amax(1)).abs().max())
        lo, hi = (want > thr + tol * peak).sum(1), (want > thr - tol * peak).sum(1)
        err = max(sum_err / nw, max_err)
        bad = sum_err > nw * tol * peak or max_err > tol * peak or not bool(((cnt >= lo) & (cnt <= hi)).all())
    if bad:
        raise AssertionError(f"waterfall {mode}: the kernel disagrees with its plain version ({err / peak:.3e} of max)")
    return err / peak


def _waterfall_route(model, raw: torch.Tensor, kernel: str) -> str:
    return f"kernel {kernel}" if model._use_kernel(raw) else "plain version (CPU)"


# -- the stream chain --------------------------------------------------------


def make_step(model, chunk: int, raw: torch.Tensor):
    """The stream chain's step over a device-resident chunk under 16
    rotating NCO phases, the counterpart of the JAX bench's
    ``make_acc_step``: inside the fused frontend's envelope, kernel 1 and
    ``stft_norms`` (:meth:`~PipelineModel.step_stream_fused`, unfused STFT,
    the JAX ``step_stream_pallas`` route) under 16 planned base tables;
    outside it, ``step_stream``'s torch ops under 16 first-sample phases.
    Returns ``(step, route, kernels it launches)``."""
    if model.fused_supported():
        bases = [torch.from_numpy(model.stream_bases(k * chunk, chunk + model.cfg.taps)).to(raw.device)
                 for k in range(16)]
        route = "fused frontend (frontend_fir) + stft_norms" if raw.is_cuda else "fused frontend plain version + stft_norms"
        return (lambda i: model.step_stream_fused(raw, bases[i % 16], fuse_stft=False)), route, ("frontend_fir",)
    thetas = model.theta0(np.arange(16, dtype=np.int64) * chunk)
    return (lambda i: model.step_stream(raw, thetas[i % 16])), "chain of torch ops (step_stream)", ()


def chain_entry(sc: Scale, cfg, chunk: int, metric: str, secs: float, min_iters: int = 2, reps: int = 2) -> dict:
    """A stream-chain entry: ``make_step`` over one synthetic chunk."""
    model = PipelineModel(cfg).to(sc.device)
    raw = torch.from_numpy(model.synth_raw(chunk + cfg.taps)).to(sc.device)
    step, route, want = make_step(model, chunk, raw)
    before, tstats = launch_counts(), {}
    msps = sc.measure(step, chunk, secs, min_iters=min_iters, reps=reps, stats_out=tstats)
    entry = {"metric": metric, "value": msps, "unit": UNIT, "vs_baseline": msps / 100.0, **tstats, "route": route}
    record_launches(entry, before, sc, want)
    if want:
        entry["max_err_over_scale"] = check_frontend(model, raw)
    elif not bool(torch.isfinite(step(0)).all()):
        raise AssertionError("the chain's norms hold non-finite values")
    entry.update(roofline(msps, chain_flops_per_sample(cfg.taps, cfg.decimate, cfg.fft_width),
                          cfg.fmt.pair_bytes + 4.0 / cfg.decimate))
    return entry


def bench_cs16_sustained(sc: Scale) -> dict:
    return chain_entry(sc, CS16_CFG, sc.size(1 << 22, 1 << 14), "cs16 on-chip decode + shift + lowpass(dec64) + stft",
                       2.0)


def bench_long_fir(sc: Scale) -> dict:
    return chain_entry(sc, LONG_FIR_CFG, sc.size(1 << 23, 1 << 15), "power=2000 (4000-tap) lowpass chain", 2.0)


# -- the waterfall bank --------------------------------------------------------


def _bank(sc: Scale, fft_width: int, stride: int, per_stream: int):
    """A 64-stream cs8 model and its synthetic planes on the device."""
    model = WaterfallModel(WaterfallConfig(n_streams=64, fft_width=fft_width, stride=stride)).to(sc.device)
    return model, torch.from_numpy(model.synth_raw(per_stream)).to(sc.device), 64 * per_stream


def _bank_roofline(model, msps: float, out_bytes_ps: float) -> dict:
    cfg = model.cfg
    return roofline(msps, stft_flops_per_sample(cfg.fft_width, cfg.stride), cfg.fmt.pair_bytes + out_bytes_ps)


def bench_waterfall(sc: Scale) -> dict:
    model, raw, total = _bank(sc, 1024, 1024, sc.size(1 << 17, 1 << 12))
    # wide tiled coverage: 4096 points at stride 4096, 2^19 samples a stream
    wmodel, wraw, w_total = _bank(sc, 4096, 4096, sc.size(1 << 19, 1 << 13))
    before, tstats = launch_counts(), {}
    msps = sc.measure(lambda i: model.step(raw), total, 2.0, stats_out=tstats)
    wide = sc.measure(lambda i: wmodel.step(wraw), w_total, 2.0)
    entry = {
        "metric": "64x parallel cs8 fused decode + 1024-pt strided STFT",
        "value": msps,
        "unit": UNIT + " (aggregate)",
        "vs_baseline": msps / 100.0,
        "tiled_4096_msps": wide,
        **tstats,
        "route": _waterfall_route(model, raw, "waterfall_norms"),
    }
    record_launches(entry, before, sc, ("waterfall_norms",))
    entry["max_err_over_scale"] = check_waterfall(model, raw, "norms")
    entry.update(_bank_roofline(model, msps, 4.0 * model.cfg.fft_width / model.cfg.stride))
    return entry


def bench_waterfall_strided(sc: Scale) -> dict:
    """The bank at 4x window overlap (1024 points, stride 256), its search,
    the 4096-point shape at stride 1024 (2^17 and 2^15 samples a stream:
    125 and 29 windows) and the search at stride 96."""
    model, raw, total = _bank(sc, 1024, 256, sc.size(1 << 16, 1 << 12))
    wmodel, wraw, w_total = _bank(sc, 4096, 1024, sc.size(1 << 17, 1 << 13))
    _, sraw, s_total = _bank(sc, 4096, 1024, sc.size(1 << 15, 1 << 12))
    amodel, araw, a_total = _bank(sc, 1024, 96, sc.size(1 << 16, 1 << 12))
    before, tstats = launch_counts(), {}
    msps = sc.measure(lambda i: model.step(raw), total, 2.0, stats_out=tstats)
    search = sc.measure(lambda i: model.search(raw), total, 2.0)
    wide = sc.measure(lambda i: wmodel.step(wraw), w_total, 2.0)
    wide_search = sc.measure(lambda i: wmodel.search(wraw), w_total, 2.0)
    small = sc.measure(lambda i: wmodel.step(sraw), s_total, 2.0)
    small_search = sc.measure(lambda i: wmodel.search(sraw), s_total, 2.0)
    subal_search = sc.measure(lambda i: amodel.search(araw), a_total, 2.0)
    entry = {
        "metric": "64x cs8 strided waterfall (1024-pt, stride 256: 4x overlap; input rate)",
        "value": msps,
        "unit": UNIT + " (aggregate input)",
        "vs_baseline": msps / 100.0,
        "search_msps": search,
        "wide_4096_msps": wide,
        "wide_4096_search_msps": wide_search,
        "wide_4096_29win_msps": small,
        "wide_4096_29win_search_msps": small_search,
        "subaligned_stride96_search_msps": subal_search,
        **tstats,
        "route": _waterfall_route(model, raw, "waterfall_norms, waterfall_search"),
    }
    record_launches(entry, before, sc, ("waterfall_norms", "waterfall_search"))
    entry["max_err_over_scale"] = max(check_waterfall(model, raw, "norms"), check_waterfall(model, raw, "search"))
    entry.update(_bank_roofline(model, msps, 4.0 * model.cfg.fft_width / model.cfg.stride))
    return entry


def bench_waterfall_search(sc: Scale) -> dict:
    """The bank reduced to each window's peak bin in the kernel, and the
    band survey: the scan kernel against the norms kernel followed by
    torch's reductions (``scan_xla_reduce_msps``, the JAX name)."""
    model, raw, total = _bank(sc, 1024, 1024, sc.size(1 << 17, 1 << 12))
    thr = 8.0

    def scan_by_reduce(i):
        norms = model.step(raw)
        return norms.sum(1), norms.amax(1), (norms > thr).sum(1)

    before, tstats = launch_counts(), {}
    msps = sc.measure(lambda i: model.search(raw), total, 2.0, stats_out=tstats)
    scan = sc.measure(lambda i: model.scan(raw, thr), total, 2.0)
    scan_reduce = sc.measure(scan_by_reduce, total, 2.0)
    entry = {
        "metric": "64x cs8 waterfall peak search (in-kernel reduction)",
        "value": msps,
        "unit": UNIT + " (aggregate)",
        "vs_baseline": msps / 100.0,
        "scan_msps": scan,
        "scan_xla_reduce_msps": scan_reduce,
        **tstats,
        "route": _waterfall_route(model, raw, "waterfall_search, waterfall_scan"),
    }
    record_launches(entry, before, sc, ("waterfall_search", "waterfall_scan"))
    entry["max_err_over_scale"] = max(check_waterfall(model, raw, "search"), check_waterfall(model, raw, "scan"))
    # search output: one (bin, mag) pair per window, ~0 bytes a sample
    entry.update(_bank_roofline(model, msps, 8.0 / model.cfg.fft_width))
    return entry


# -- torch-op paths: the channelizer, the resampler, pattern search -----------


def _noise(rng, shape, device) -> torch.Tensor:
    """Complex64 unit-variance noise planes on the device."""
    re = rng.standard_normal(shape).astype(np.float32)
    im = rng.standard_normal(shape).astype(np.float32)
    return torch.complex(torch.from_numpy(re), torch.from_numpy(im)).to(device)


def bench_channelizer(sc: Scale) -> dict:
    """The 16-channel polyphase bank in one pass against 16 premixed
    band-pass FIRs, one a channel (``vs_separate``), and the bank at 64,
    256 and 1024 channels with 8 taps a branch."""
    k, taps_n = 16, 128
    n_out = sc.size(1 << 16, 1 << 9)
    chunk = n_out * k
    taps = lowpass_taps(1.0 / (2 * k), taps_n)
    rng = np.random.default_rng(7)
    x = _noise(rng, (1, chunk + taps_n), sc.device)
    premixed = [
        (taps.astype(np.complex128) * np.exp(-2j * np.pi * np.arange(taps_n) * ch / k)).astype(np.complex64)
        for ch in range(k)
    ]

    def separate(i):
        return [fir_decimate(x, premixed[ch], k, n_out, impl="auto") for ch in range(k)]

    tstats: dict = {}
    msps = sc.measure(lambda i: channelize_block(x, taps, k, n_out), chunk, 2.0, stats_out=tstats)
    sep = sc.measure(separate, chunk, 2.0)
    entry = {
        "metric": f"{k}-channel polyphase bank (128-tap prototype; input rate)",
        "value": msps,
        "unit": UNIT,
        "vs_baseline": msps / 100.0,
        "separate_chains_msps": sep,
        "vs_separate": msps / max(sep, 1e-9),
        **tstats,
    }
    # per input sample: branch FIRs = N complex*real MACs (4 flops each)
    # and the dense K-point DFT = K^2 complex MACs per K inputs = 8*K
    entry.update(roofline(msps, 4.0 * taps_n + 8.0 * k, 8.0))
    k_sweep = {}
    for kw in (64, 256, 1024):
        taps_w = lowpass_taps(1.0 / (2 * kw), 8 * kw)
        n_out_w = sc.size(1 << 20, 1 << 13) // kw
        x_w = _noise(rng, (1, n_out_w * kw + 8 * kw), sc.device)
        k_sweep[str(kw)] = sc.measure(lambda i, x_w=x_w, taps_w=taps_w, kw=kw, n=n_out_w: channelize_block(
            x_w, taps_w, kw, n), n_out_w * kw, 1.5)
    entry["k_sweep_msps"] = k_sweep
    entry["k_sweep_taps_per_branch"] = 8
    return entry


def bench_resample(sc: Scale) -> dict:
    """The rational resampler at L/M = 147/160 over a 64-stream bank:
    input rate of the per-phase weight product
    (:func:`~quadrs_tpu_torch.ops.resample.resample_block`)."""
    up, down = 147, 160
    size = 2 * 8 * max(up, down)
    _, _, m, _ = resample_tables(size, up, down)
    b = 64
    n_out = sc.size(1 << 14, 1 << 9)
    nb = -(-n_out // up)
    x = _noise(np.random.default_rng(11), (b, (nb - 1) * down + m), sc.device)
    w_sel = torch.zeros(b, dtype=torch.int32, device=sc.device)
    tstats: dict = {}
    msps = sc.measure(lambda i: resample_block(x, w_sel, size, up, down, n_out), b * nb * down, 2.0,
                      stats_out=tstats)
    entry = {
        "metric": f"64x rational resample {up}/{down} (per-phase weight matmul; input rate)",
        "value": msps,
        "unit": UNIT,
        "vs_baseline": msps / 100.0,
        **tstats,
    }
    # executed dense flops: nb*m*L complex-x-real MACs (4 flops) per ~nb*down inputs
    entry.update(roofline(msps, 4.0 * m * up / down, 8.0 * (1.0 + up / down)))
    return entry


def bench_find(sc: Scale) -> dict:
    """Matched-filter pattern search (``sinks.find_pattern``'s device
    program) for a 1024-sample template: the product dispatch (a fat batch
    of the auto block, 4096, through the candidate extraction), with a
    9-row carrier grid, and the thin (4 windows) and fat dispatches at a
    65536-sample block."""
    dev = sc.device
    l = 1024
    c = sc.size(1 << 16, 1 << 12)
    n_out, b = c - l + 1, 4
    rng = np.random.default_rng(11)
    pat = (rng.standard_normal(l) + 1j * rng.standard_normal(l)).astype(np.complex64)
    x = _noise(rng, (b, c), dev)
    grid = np.arange(-4, 5, dtype=np.float64) * 0.4 / l  # cycles/sample
    left = torch.tensor(-np.inf, dtype=torch.float32, device=dev)

    def fat_rate(cw: int, freqs) -> float:
        n_o = cw - l + 1
        bf = sc.size(max(4, FIND_DISPATCH_BUDGET // n_o), 2)
        xf = _noise(rng, (bf, cw), dev)
        post = make_xcorr_post(pat, cw, freqs, extract=(0.5, FIND_TOPK))
        return sc.measure(lambda i: post(xf, left), bf * n_o, 2.0)

    tstats: dict = {}
    thin = make_xcorr_post(pat, c)
    msps = sc.measure(lambda i: thin(x), b * n_out, 2.0, stats_out=tstats)
    thin_grid = make_xcorr_post(pat, c, grid)
    grid_msps = sc.measure(lambda i: thin_grid(x), b * n_out, 2.0)
    c_auto = max(4 * l, 4096)
    fat_auto = fat_rate(c_auto, None)
    entry = {
        "metric": f"pattern search (l={l}, auto FFT block {c_auto}, product dispatch; input rate)",
        "value": fat_auto,
        "unit": UNIT,
        "vs_baseline": fat_auto / 100.0,
        "freq_grid9_msps": fat_rate(c_auto, grid),
        "thin_c65536_msps": msps,
        "thin_grid9_c65536_msps": grid_msps,
        "fat_c65536_msps": fat_rate(c, None),
        "fat_grid9_c65536_msps": fat_rate(c, grid),
        **tstats,
    }
    # per new input sample: one forward and one inverse FFT of c_auto over
    # its lags, a 6-flop pointwise product, the |.|^2 + prefix + divide epilogue
    entry.update(roofline(fat_auto, (10.0 * c_auto * np.log2(c_auto) + 6.0 * c_auto) / (c_auto - l + 1) + 12.0, 8.0))
    return entry


# -- the receivers --------------------------------------------------------------


def _demod_capture(n: int, workdir: str) -> str:
    """A synthetic cf32 capture for the receivers (noise and an FM-ish
    carrier at -280 kHz, so that ``shift 280k`` centres it), kept in
    ``workdir``: the JAX bench's generator and seed."""
    path = os.path.join(workdir, f"quadrs-demod-{n}.sr21M.cf32")
    if not (os.path.exists(path) and os.path.getsize(path) == n * 8):
        rng = np.random.default_rng(17)
        t = np.arange(n, dtype=np.float64) / 21e6
        ph = 2 * np.pi * (-280e3 * t) + 1.5 * np.sin(2 * np.pi * 1e3 * t)
        x = 0.5 * np.exp(1j * ph)
        x += 0.05 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
        x.astype(np.complex64).tofile(path + ".part")
        os.replace(path + ".part", path)
    return path


def _demod_source(n: int, sc: Scale):

    return SampleSource.from_file(_demod_capture(n, sc.workdir))


def _streaming_chain_step(chan, c: int, lead: int, post, sc: Scale, stride=None, chunk_post=None):
    """The receivers' streaming dispatch (``models.demod._ChannelStep``:
    decode -> table mix -> per-pull-truncated FIR -> post, ``k`` windows
    from one contiguous staged span), its span staged once and computed
    again each step.  Returns ``(step, raw samples a step)``: the raw
    advance, not the overlapped span, as the input-rate convention wants."""
    built = demod._channel_step(chan, c, lead, post, device=sc.device, stride=stride, chunk_post=chunk_post)
    if built is None:
        raise RuntimeError("the bench chain must match the streaming shape")
    _slot, dev, _ = built.stage(0)
    return (lambda i: built.compute(dev)), built.step * built.d


def _audio_both(rx, rate: int, n_a: int, sc: Scale, secs: float) -> tuple[float, float]:
    """The audio tail at the channel rate over a 4-buffer device-resident
    cycle: ``(rate with the audio fetched each step, as the product does;
    rate with the audio left on the device)``."""
    rng = np.random.default_rng(7)
    bufs = [torch.from_numpy((0.5 + 0.1 * k) * rng.standard_normal(n_a).astype(np.float32)).to(sc.device)
            for k in range(4)]
    prod = sc.measure(lambda i: demod.audio_stage(rx, rate, bufs[i % 4], div=1.0 + 0.01 * (i % 16)), n_a, secs)
    dev = sc.measure(lambda i: demod.audio_stage_dev(rx, rate, bufs[i % 4], div=1.0 + 0.01 * (i % 16)), n_a, secs)
    return prod, dev


def _audio_entry(sc: Scale, rx, c: int, windows: int, lead: int, post, n_a: int, metric: str, pad: int,
                 flops_ps: float) -> dict:
    """An analog receiver: its chain's streaming dispatch, then its audio
    tail, combined at their per-input-sample shares."""
    src = _demod_source(windows * c * rx.decimate + pad, sc)
    chan = rx.channel(src)
    step, spp = _streaming_chain_step(chan, c, lead, post(chan.sample_rate), sc)
    tstats: dict = {}
    chain_msps = sc.measure(step, spp, 1.5, stats_out=tstats)
    audio_msps, audio_dev = _audio_both(rx, chan.sample_rate, n_a, sc, 1.5)
    msps = _combined(chain_msps, audio_msps, rx.decimate)
    entry = {
        "metric": metric,
        "value": msps,
        "unit": UNIT,
        "vs_baseline": msps / 100.0,
        "chain_msps": chain_msps,
        "audio_msps_at_channel_rate": audio_msps,
        "audio_device_msps_at_channel_rate": audio_dev,
        "e2e_device_msps": _combined(chain_msps, audio_dev, rx.decimate),
        **tstats,
    }
    entry.update(roofline(msps, flops_ps, 8.0))
    return entry


def bench_fm(sc: Scale) -> dict:
    """FM receiver: shift -> 400-tap FIR (decimate 10) -> quadrature
    discriminator, then the audio tail (15 kHz FIR decimate 10 + rational
    resample 210k -> 48k)."""
    fm = demod.FmDemod(center=280_000, bandwidth=100_000, decimate=10, taps=400, audio_bandwidth=15_000,
                 audio_decimate=10, audio_taps=64, audio_rate=48_000)

    def post(rate):
        scale = float(np.float32(rate / (2.0 * np.pi)))

        def discriminate(x):  # FmDemod.discriminate_dev's post
            d = demod.discriminate(x)
            return torch.atan2(d.imag, d.real) * scale

        return discriminate

    return _audio_entry(
        sc, fm, sc.size(1 << 16, 1 << 11), sc.size(8, 2), 1, post, sc.size(1 << 20, 1 << 13),
        "FM receiver (shift->fir(10)->discriminator->audio tail; input rate)", 8192,
        6.0 + (4.0 * fm.taps + 12.0) / fm.decimate + (2.0 * fm.audio_taps + 20.0) / fm.decimate)


def bench_am(sc: Scale) -> dict:
    """AM receiver: shift -> 400-tap FIR (decimate 20) -> envelope, then
    the audio tail (FIR decimate 20 + resample 52.5k -> 48k)."""
    am = demod.AmDemod(center=280_000, bandwidth=10_000, decimate=20, taps=400, audio_bandwidth=20_000,
                 audio_decimate=20, audio_taps=64, audio_rate=48_000)
    return _audio_entry(
        sc, am, sc.size(1 << 16, 1 << 11), sc.size(4, 2), 0, lambda rate: torch.abs, sc.size(1 << 20, 1 << 13),
        "AM receiver (shift->fir(20)->envelope->audio tail; input rate)", 8192,
        6.0 + (4.0 * am.taps + 4.0 + 2.0 * am.audio_taps + 20.0) / am.decimate)


def bench_ssb(sc: Scale) -> dict:
    """SSB receiver: pre-shift -> 2000-tap FIR (decimate 400) -> re-shift
    -> real, then the resample 52.5k -> 48k."""
    ssb = demod.SsbDemod(center=280_000, bandwidth=3_000, decimate=400, taps=2_000, sideband="usb", audio_rate=48_000)
    return _audio_entry(
        sc, ssb, sc.size(1 << 14, 1 << 10), 1, 0, lambda rate: torch.real, sc.size(1 << 18, 1 << 12),
        "SSB receiver (usb filter method, fir(400)->resample; input rate)", 16384,
        6.0 + (4.0 * ssb.taps + 26.0) / ssb.decimate)


def bench_fsk(sc: Scale) -> dict:
    """FSK receiver: shift -> 400-tap FIR (decimate 32) -> 64-point
    halves-energy discriminator (``sinks.freq_levels``' dispatch)."""
    fsk = demod.FskDemod(center=280_000, bandwidth=200_000, decimate=32, taps=400, fft_width=64)
    w = fsk.fft_width
    src = _demod_source(sc.size(4096, 64) * w * fsk.decimate + 8192, sc)

    def post(x):  # sinks.freq_levels' comparator halves
        norms = stft_norms(x, shift=False)
        return norms[:, : w // 2].sum(dim=1), norms[:, w // 2 :].sum(dim=1)

    step, raw_per = _streaming_chain_step(fsk.channel(src), w, 0, post, sc, stride=w)
    tstats: dict = {}
    msps = sc.measure(step, raw_per, 1.5, stats_out=tstats)
    entry = {
        "metric": "FSK receiver (shift->fir(32)->64-pt bucket discriminator; input rate)",
        "value": msps,
        "unit": UNIT,
        "vs_baseline": msps / 100.0,
        **tstats,
    }
    entry.update(roofline(msps, 6.0 + (4.0 * fsk.taps + 5.0 * math.log2(w) + 6.0) / fsk.decimate, 8.0))
    return entry


def bench_ook(sc: Scale) -> dict:
    """OOK envelope detector: width-4 stride-2 spectral envelope ->
    threshold, 2 new input samples a window, through the chunk-level
    envelope of ``OokDemod.pulses``."""
    ook = demod.OokDemod()
    src = _demod_source(sc.size(1 << 21, 1 << 12) * ook.stride + ook.width + 4096, sc)
    th = float(np.float32(ook.threshold))

    def post(x):
        return (stft_norms(x) >= th).any(dim=1)

    step, raw_per = _streaming_chain_step(src, ook.width, 0, post, sc, stride=ook.stride,
                                          chunk_post=demod._envelope_chunk_post(ook.width, ook.stride, th))
    tstats: dict = {}
    msps = sc.measure(step, raw_per, 1.5, stats_out=tstats)
    entry = {
        "metric": "OOK envelope detector (width 4, stride 2; input rate)",
        "value": msps,
        "unit": UNIT,
        "vs_baseline": msps / 100.0,
        **tstats,
    }
    entry.update(roofline(msps, stft_flops_per_sample(ook.width, ook.stride) + 0.5, 8.0))
    return entry


def bench_psk(sc: Scale) -> dict:
    """PSK receiver (QPSK): the baseband channel's streaming dispatch and
    the two sync programs a burst (order-th-power FFT peak; derotation,
    matched filter and Oerder-Meyr sums) at a 2^20 burst, combined at
    their per-input-sample shares; ``analyze_wall_msps_at_channel_rate``
    is ``analyze``'s wall with its host tables and fetches."""
    dev = sc.device
    psk = demod.PskDemod(center=280_000, bandwidth=200_000, decimate=32, taps=400, symbol_rate=65_625.0, order=4)
    c = sc.size(1 << 16, 1 << 11)
    chan = psk.channel(_demod_source(2 * c * psk.decimate + 8192, sc))
    rate = chan.sample_rate
    step, spp = _streaming_chain_step(chan, c, 0, torch.view_as_real, sc)
    tstats: dict = {}
    chain_msps = sc.measure(step, spp, 1.5, stats_out=tstats)

    npad = sc.size(1 << 20, 1 << 12)
    n = npad - 1000
    rng = np.random.default_rng(5)
    planes = torch.from_numpy(rng.standard_normal((2, npad)).astype(np.float32)).to(dev)
    sps = rate / psk.symbol_rate
    mf_len = max(1, int(round(sps)))
    rot, tim = (torch.from_numpy(a).to(dev) for a in demod.psk_tables(0.37, npad, psk.order, sps))

    def sync(i):
        return demod.psk_peak(planes, n, psk.order), demod.psk_process(planes, rot, tim, n, psk.order, mf_len)

    sync_msps = sc.measure(sync, npad, 1.5)
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(np.complex64)
    psk.analyze(rate, x, device=dev)  # tables planned, programs warm
    reps = 3
    t0 = wall_clock(dev)
    for k in range(reps):
        psk.analyze(rate, x * np.complex64(1.0 + 0.1 * k), device=dev)
    wall = (wall_clock(dev) - t0) / reps
    msps = _combined(chain_msps, sync_msps, psk.decimate)
    entry = {
        "metric": "PSK receiver (QPSK chain + per-burst sync programs; input rate)",
        "value": msps,
        "unit": UNIT,
        "vs_baseline": msps / 100.0,
        "chain_msps": chain_msps,
        "sync_msps_at_channel_rate": sync_msps,
        "analyze_wall_msps_at_channel_rate": n / wall / 1e6,
        **tstats,
    }
    entry.update(roofline(msps, 6.0 + (4.0 * psk.taps + 10.0 * math.log2(npad) + 40.0) / psk.decimate, 8.0))
    return entry


# -- the disk paths ----------------------------------------------------------


def _sustained_capture(n_samples: int, workdir: str) -> str:
    """A synthetic cs8 capture of ``n_samples`` (2 bytes a sample) in
    ``workdir``, kept for the next run: the JAX bench's generator and seed,
    so that both benches read the same bytes."""
    path = os.path.join(workdir, f"quadrs-sustained-{n_samples}.sr21M.cs8")
    want_bytes = n_samples * 2
    if not (os.path.exists(path) and os.path.getsize(path) == want_bytes):
        tmp = path + ".part"
        rng = np.random.default_rng(3)
        with open(tmp, "wb") as fh:
            left = want_bytes
            while left:
                m = min(left, 1 << 27)
                fh.write(rng.integers(-127, 128, m, dtype=np.int8).tobytes())
                left -= m
        os.replace(tmp, path)
    return path


def _sustained_setup(sc: Scale, cfg):

    path = _sustained_capture(sc.capture_samples, sc.workdir)
    return PipelineModel(cfg).to(sc.device), SampleSource.from_file(path), path


def feed_rate(runner, cap: int) -> float:
    """Msamples/s at which the runner's own staging generator (the loader
    or the pipe into page-locked slots, with each chunk's NCO bases) fills
    its ring over the first ``cap`` chunks: everything but the device."""
    ring = UploadRing(runner.device, 4, **runner._slot_buffers())
    staged = runner._staged(ring, 0, lambda cols: None)
    t0, fed = wall_clock(runner.device), 0
    try:
        for i, (k, (_off, cols, _valid), _shapes, _account) in enumerate(staged):
            fed += cols - runner._lookahead
            ring.recycle(k)
            if i + 1 >= cap:
                break
    finally:
        staged.close()
        ring.close()
    return fed / (wall_clock(runner.device) - t0) / 1e6


def _pipe_feed_rate(path: str, model, sc: Scale, chunk: int, cap: int) -> float:
    """:func:`feed_rate` of the live-pipe path (``stream -stdin yes``): the
    capture written into a pipe by a thread, read by a
    :class:`~quadrs_tpu_torch.sources.PipeSource`."""
    r, w = os.pipe()

    def feed():
        try:
            with open(path, "rb") as fh, os.fdopen(w, "wb") as out:
                while b := fh.read(1 << 22):
                    out.write(b)
        except OSError:  # the reader closed the pipe
            pass

    th = threading.Thread(target=feed, daemon=True)
    th.start()
    with os.fdopen(r, "rb") as rf:
        cfg = model.cfg
        rate = feed_rate(StreamRunner(PipeSource(rf, cfg.fmt, cfg.sample_rate), model, sc.device, chunk), cap)
    th.join(timeout=60)
    return rate


class _PreStagedPlanes:
    """Deinterleaved native planes in RAM, staged by a copy: the
    comparator behind the sustained entries' ``overlap_efficiency``, the
    same :class:`StreamRunner` loop with the disk reads and deinterleave
    taken out.  ``e2e / prestaged == 1`` means staging is hidden behind the
    device side of the pipe."""
    is_pipe = False
    native = None

    def __init__(self, planes: np.ndarray, fmt, sample_rate: int):
        self._planes = planes
        self.format = fmt
        self.sample_rate = sample_rate
        self.length = planes.shape[1]

    def stage(self, lo: int, hi: int, out: np.ndarray | None = None) -> np.ndarray:
        lo = max(0, min(lo, self.length))
        hi = max(lo, min(hi, self.length))
        if out is None:
            return self._planes[:, lo:hi]
        out[:, : hi - lo] = self._planes[:, lo:hi]
        return out[:, : hi - lo]


def _overlap_fields(model, src, sc: Scale, chunk: int, cap: int, e2e_msps: float,
                    staging_msps: float | None = None) -> dict:
    """The same run over pre-staged planes, and what it says of the
    overlap: ``serial_msps`` is the rate a pipeline that did not overlap
    staging with the device would reach."""
    la = StreamRunner(src, model, sc.device, chunk_samples=chunk)._lookahead
    pre = _PreStagedPlanes(src.stage(0, cap * chunk + la), model.cfg.fmt, model.cfg.sample_rate)
    stats = StreamRunner(pre, model, sc.device, chunk_samples=chunk).run(max_chunks=cap)
    fields = {
        "prestaged_msps": stats.msps,
        "overlap_efficiency": e2e_msps / stats.msps if stats.msps else None,
    }
    if staging_msps:
        fields["serial_msps"] = 1.0 / (1.0 / stats.msps + 1.0 / staging_msps)
    return fields


def _runner_route(model) -> tuple[str, tuple[str, ...]]:
    """The route :class:`StreamRunner` takes for ``model`` (its ``auto``
    frontend), and the kernels it launches."""
    if model.fused_supported():
        return "StreamRunner, fused frontend (frontend_fir) + stft_norms", ("frontend_fir",)
    return "StreamRunner, chain of torch ops (step_stream)", ()


def _check_first_chunk(model, src, sc: Scale, chunk: int) -> float:
    """The first chunk of the capture through :func:`check_frontend`."""
    raw = torch.from_numpy(np.ascontiguousarray(src.stage(0, chunk + model.cfg.taps))).to(sc.device)
    return check_frontend(model, raw)


def bench_disk_staging(sc: Scale) -> dict:
    """The host's half of the disk -> card loop: the cs8 capture through
    the loader's ring prefetcher into the runner's page-locked slots
    (everything but the device), and through a live pipe."""
    model, src, path = _sustained_setup(sc, HEADLINE_CFG)
    chunk = sc.size(1 << 22, 1 << 16)
    cap = sc.size(64, 8)  # 256M samples at most
    runner = StreamRunner(src, model, sc.device, chunk_samples=chunk)
    # best of 3: the host's cores are shared, and single passes swing
    msps = max(feed_rate(runner, cap) for _ in range(3))
    pipe_msps = max(_pipe_feed_rate(path, model, sc, chunk, cap) for _ in range(3))
    return {
        "metric": "disk->host staging feed rate (C++ ring prefetch into page-locked slots over the cs8 capture)",
        "value": msps,
        "unit": "Msamples/sec",
        "vs_baseline": msps / 100.0,
        "pipe_feed_msps": pipe_msps,
        "samples_total": src.length,
    }


def bench_disk_sustained(sc: Scale) -> dict:
    """End to end from disk: file -> the loader's ring prefetch -> page-
    locked slots -> the copy stream -> kernel 1 and ``stft_norms``, through
    :class:`StreamRunner` over the first 12 chunks (the steady state)."""
    model, src, path = _sustained_setup(sc, HEADLINE_CFG)
    cfg = model.cfg
    chunk = sc.size(1 << 22, 1 << 16)
    # warm the runner's route with a 2-chunk in-memory source of the same shapes
    with open(path, "rb") as fh:
        warm_raw = np.frombuffer(fh.read((2 * chunk + cfg.taps * 4) * 2), dtype=np.uint8)
    StreamRunner(SampleSource(warm_raw, cfg.fmt, cfg.sample_rate), model, sc.device, chunk_samples=chunk).run()
    cap = sc.size(12, 4)
    before = launch_counts()
    wall_clock(sc.device)
    stats = StreamRunner(src, model, sc.device, chunk_samples=chunk).run(max_chunks=cap)
    route, want = _runner_route(model)
    entry = {
        "metric": "sustained disk->card cs8 stream (the 1G-sample file's first chunks)",
        "value": stats.msps,
        "unit": UNIT,
        "vs_baseline": stats.msps / 100.0,
        "route": route,
    }
    entry.update(_overlap_fields(model, src, sc, chunk, cap, stats.msps))
    record_launches(entry, before, sc, want)
    if want:
        entry["max_err_over_scale"] = _check_first_chunk(model, src, sc, chunk)
    entry["samples_total"] = src.length
    return entry


def bench_long_fir_sustained(sc: Scale) -> dict:
    """The power=2000 (4000-tap) chain over the cs8 capture from disk:
    the staging feed rate at this chain's lookahead, and the end-to-end
    rate over the first 8 chunks."""
    model, src, _ = _sustained_setup(sc, LONG_FIR_CS8_CFG)
    chunk = sc.size(1 << 22, 1 << 16)
    runner = StreamRunner(src, model, sc.device, chunk_samples=chunk)
    staging_msps = max(feed_rate(runner, sc.size(64, 2)) for _ in range(3))
    e2e_cap = sc.size(8, 2)
    before = launch_counts()
    wall_clock(sc.device)
    stats = StreamRunner(src, model, sc.device, chunk_samples=chunk).run(max_chunks=e2e_cap)
    route, want = _runner_route(model)
    entry = {
        "metric": "sustained power=2000 chain over the 1G-sample capture (disk->card)",
        "value": stats.msps,
        "unit": UNIT,
        "vs_baseline": stats.msps / 100.0,
        "staging_msps": staging_msps,
        "samples_total": src.length,
        "route": route,
    }
    entry.update(_overlap_fields(model, src, sc, chunk, e2e_cap, stats.msps, staging_msps=staging_msps))
    record_launches(entry, before, sc, want)
    if want:
        entry["max_err_over_scale"] = _check_first_chunk(model, src, sc, chunk)
    return entry


def bench_staging_workers(sc: Scale) -> dict:
    """The loader's prefetcher feed rate (pread + deinterleave + overlap
    re-read, no device work) against its number of reader threads."""
    src = SampleSource.from_file(_sustained_capture(sc.capture_samples, sc.workdir))
    chunk = sc.size(1 << 22, 1 << 16)
    cap = max(2, min(48, src.length // chunk))
    table = {}
    for workers in (1, 2, 4):
        best = 0.0
        for _ in range(2):
            t0, fed = wall_clock(sc.device), 0
            it = src.native.prefetch(chunk, start_off=0, overlap=4000, n_workers=workers)
            try:
                for i, _ in enumerate(it):
                    fed += chunk
                    if i + 1 >= cap:
                        break
            finally:
                it.close()
            best = max(best, fed / (wall_clock(sc.device) - t0) / 1e6)
        table[str(workers)] = best
    peak = max(table.values())
    return {
        "metric": "disk->host prefetcher feed rate vs n_workers",
        "value": peak,
        "unit": "Msamples/sec",
        "vs_baseline": peak / 100.0,
        "workers_msps": table,
        "host_cores": os.cpu_count(),
        "samples_total": src.length,
    }


# the JAX bench_suite._SUITE, in its order
SUITE = {
    "bench_cs16_sustained": bench_cs16_sustained,
    "bench_long_fir": bench_long_fir,
    "bench_waterfall": bench_waterfall,
    "bench_waterfall_strided": bench_waterfall_strided,
    "bench_waterfall_search": bench_waterfall_search,
    "bench_channelizer": bench_channelizer,
    "bench_resample": bench_resample,
    "bench_find": bench_find,
    "bench_fm": bench_fm,
    "bench_am": bench_am,
    "bench_ssb": bench_ssb,
    "bench_fsk": bench_fsk,
    "bench_ook": bench_ook,
    "bench_psk": bench_psk,
    "bench_disk_staging": bench_disk_staging,
    "bench_disk_sustained": bench_disk_sustained,
    "bench_long_fir_sustained": bench_long_fir_sustained,
    "bench_staging_workers": bench_staging_workers,
}
