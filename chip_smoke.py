"""Smoke run of quadrs_tpu_torch's main paths on one CUDA card.

Run from the root of a checkout: ``python3 chip_smoke.py``.  It imports
no JAX.  It exits non-zero, printing no result, when CUDA is
unavailable or the package is missing; any failed phase raises and ends
the run.  Phases:

1. the card: ``nvidia-smi``'s name and power limit, torch and CUDA versions;
2. the build of the CUDA kernels from ``quadrs_tpu_torch/csrc`` (nvcc) and of
   the capture loader from ``quadrs_tpu_torch/native/loader.cc`` (g++);
3. the loader: ``read_planes`` and the prefetched chunks, bit for bit against
   ``SampleSource.stage`` of the same bytes in memory, over the 2^26-sample
   cs8 capture and a cu8 and a cs16 one, at offsets straddling EOF; then each
   kernel against its plain PyTorch version on the same CUDA
   tensors: the frontend kernels for every format and the envelope's
   corner cases, held to ``5e-5 * scale`` (the JAX package's
   kernel-versus-chain bound), then their edges: plane views at every
   offset mod 16, odd filter lengths, ``n_ok`` inside the first block, on
   a block boundary and one below the end, ``n_out`` no multiple of the
   block or of a thread's 8 outputs, D 1, 3, 5, 33 and 64, one subfilter,
   W 2 and 128, and a single unit tap at D 1 (error exactly 0: decode and
   mix are bit-equal to the plain version); the v1 frontend kernel for every format,
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
   survey against the plain version's stride-256 norms, with the count of
   peak bins and threshold counts that differ from the plain version (each
   inside a near-tie or the threshold's noise band, or the phase fails);
   then ``find`` (torch ops and cuFFT, no kernel) over a copy of the
   capture with random cs8 templates planted at known offsets, gains and
   phases (one just left of a dispatch boundary, one flush with the end):
   the single template's 8 offsets with scores above 0.9, a 3-template bank
   over a 9-row grid of carrier offsets (offsets, which and freqs), each
   against the same argv on the CPU over the 2^22-sample prefix,
   ``-write`` slices against the capture's bytes, the bank from ``replay
   -speed 0 | find -stdin yes`` against the file run, and the dispatches
   that the device scan decided (some must be); then the conditioning stages
   over the first capture (``iqbal dcblock agc resample 147/160 write``;
   the FSK chain through ``dcblock -window 256 agc -window 64`` into
   ``sparkfft``), each against its CPU run over the prefix, and
   ``resample_real`` 656,250 to 48,000 against the CPU; a profiled run of
   ``find``, the bank and the stage chain each gives the device's share
   of its wall; then the receivers (torch ops and cuFFT, no kernel: the
   kernels' launch counts must not move), each through the streaming front
   end (``models.demod._ChannelStep``, its dispatches counted) and against
   the same argv on the CPU over a 2^22-sample prefix: ``ook -width 4
   -stride 2 -bit 250`` over 2^24 cs8 samples at 1 Msps of Manchester
   bursts (the payload comes back), ``fsk -shift 280k -lowpass 200k
   -decimate 32 -width 64`` over the stream's capture (symbols equal but at
   near-ties), ``fm -shift -500k -lowpass 100k -decimate 8 -audio-rate
   48000`` over 2^25 cu8 samples at 2.4 Msps of a 1 kHz tone at 75 kHz
   deviation (tone within a bin, rms deviation within 3%; with ``-wav yes``;
   from ``replay -speed 0 | fm -stdin yes``, bit for bit the file run's),
   ``am -shift -500k -audio-rate 48000`` over 2^24 cu8 samples of depth 0.5
   (tone, peak modulation within 3%) and ``ssb -sideband usb`` over 2^24
   cs8 samples at 2 Msps (tone), the audio of the card's run over the
   prefix within 1e-5 of full scale of the CPU's; ``bucket`` above takes the
   same front end; then ``psk -symbol-rate 12500`` (BPSK, and QPSK with
   ``-order 4``) over 2^24 cs8 samples at 2 Msps of a differentially
   encoded payload with a carrier and a timing offset (the payload comes
   back), a burst whose carrier drifts 800 Hz at 1k symbols/s (``-block
   4096`` brings the payload back, ``-block 0`` must not), ``-plot``'s PNG
   decoded with zlib (256 x 256, markers at the order-th roots), each
   against the CPU over the prefix (decisions equal but at counted
   near-ties); ``channelize -channels 64 -power 512`` over a 2^26-sample
   cs8 capture at 21 Msps with tones in channels 5, 17 and 40 (they lead,
   every other channel 30 dB down; ``-select`` files' tones within a bin;
   against the CPU within 2e-6 of scale), the defaults once; ``ui`` (GUI
   defaults, ``-frames 4``) and ``eui`` (``-frames 3``) over the main
   capture, their PNGs against the CPU's over the prefix (pixels equal but
   at counted colour-boundary pixels), ``ui -live yes -rows 2000`` against
   the CPU's rows and ``replay | eui -live yes -stdin yes -rows 2000``
   against the file run's; the kernels' launch counts must not move across
   these; the bank's ``scan`` again with ``-plot yes`` (64 survey PNGs, its
   launches counted with the scan's); then the daemon (``serve``, on a thread
   of this process, its clients on loopback reading while they send; each
   session's launches counted from 0, ``frontend_fir`` or the mode's
   waterfall kernel once a chunk and nothing else): ``-mode stream`` at the
   bench config over the 2^26-sample capture (norms bit-equal to
   ``StreamRunner`` over the file; a profiled session's device share;
   ``-search`` the lines of ``stream -search``), ``-mode waterfall``,
   ``waterfall -search -stride 256`` and ``scan -stride 256`` over one
   capture of the bank (the commands' outputs over the file), ``-mode find``
   with the bank of three templates over the 9-row grid (the lines of
   ``replay | find -stdin``), ``-mode ook|fsk|psk|fm|am|ssb`` over the
   receivers' captures (the commands' lines on the card, or their ``-out``
   audio, byte for byte), ``-parallel 4 -timeout 5`` with eight ``-search``
   sessions over halves of the capture, half of them trickling, against the
   sequential daemon's replies and with a stalled client dropped while they
   run, then the eight sent at once (the aggregate Msps of the eight against
   the sequential eight), and
   ``python -m quadrs_tpu_torch serve -once yes`` in a process of its own;
   then ``-mesh`` (``phase_mesh_path``): the stream at the bench config over
   the capture's first 2^24 samples on meshes 1x1, 2x1 and 4x1 that repeat
   ``cuda:0`` (``run``, ``run_search``, ``run_scan``; walls, Msps and a
   profiled run's device share beside the single-device run's), ``stream
   -mesh 1x1`` through the CLI and from ``replay``'s pipe, the bank (8 of
   the bank's captures, strides 1024 and 256) on a 2x2 mesh, ``find`` and
   ``channelize -channels 64`` on a 2x1 mesh, each against the
   single-device run on the card (stream norms within ``1e-5`` of scale,
   waterfall norms ``2e-5``, peak bins and survey counts equal but at
   counted near-ties, ``find`` offsets equal and scores within ``2e-4``,
   channels within ``2e-6`` of scale), every kernel's launches counted
   from 0 over each run and the current device unchanged after it; with
   two or more cards the stream and the bank also run over distinct
   cards; then the receivers' ``-mesh`` (``phase_receiver_mesh``):
   ``ook``, ``fsk``, ``psk``, ``fm``, ``am`` and ``ssb`` at their
   captures and configurations above through the CLI with ``-mesh 2`` and
   ``-mesh 4`` on meshes that repeat the card, each against the same
   command without ``-mesh`` (bits equal, digits equal but at near-ties,
   audio within ``1e-5`` of full scale, PSK's baseband on a 4-way mesh
   within ``1e-5`` of its scale), each mesh run through the sharded front
   end; the daemon's ``-mesh`` (``phase_daemon_mesh``): ``serve -mesh
   2x1`` at the bench config over the 2^26-sample capture, ``-mode fsk
   -mesh 4``, ``-mode find -mesh 2``, ``-mode waterfall -mesh 2x1`` over
   the bank's first capture, each session against the unmeshed daemon's
   reply, and ``-parallel 2 -mesh 2`` with two ``-search`` sessions at
   once, each reply a direct mesh run's lines, the sessions' launches
   counted from 0; two processes of ``python -m
   quadrs_tpu_torch.parallel.distributed`` on the card over gloo, two
   shards each, at the bench config over the mesh capture, each rank's
   rows against the single-device rows at the same global index
   (``phase_distributed``); one ``profiled()`` stream run with the
   profiler's report (``phase_profiler``); and every entry of the bench
   (``quadrs_tpu_torch.bench``) at its ``quick`` scale: the full bench's
   shapes and lengths, 0.25 s timing windows, one rep, the 1G-sample
   captures cut to 2^28 samples; each line printed as it is measured, and
   the run failed by an entry's error, a kernel entry that launched no
   kernel or one without its output check (``phase_bench``);
5. CUDA-event times of the kernels, their plain versions and their
   yardsticks at the main paths' shapes: one 4M-sample cs8 chunk of the
   stream chain (D 32, 400 taps, W 64) for the frontend kernels and the
   v1 kernel (yardstick: cuDNN's ``conv1d`` over the mixed planes, TF32
   off), each ``fir_decimate`` impl over a sweep of shapes (what the ``auto``
   rule of the card rests on), ``step_stream`` at cs16 op by op against an
   f64 sum, and one
   bank chunk (64 streams x 2000 windows x 1024 points) at strides 1024
   and 256 (yardstick: ``torch.fft.fft`` over the decoded frames), each
   waterfall kernel first held against its plain version on those inputs;
   then ``find``'s device program at ``l`` 1024 and 4096 over a sweep of
   blocks, single template and 9-row grid, split into forward FFT, rows
   (product, inverse FFT, scores), energy and extraction, and the
   resampler's product at the write batch against a weight matrix
   gathered per window; then one streaming dispatch of each receiver at
   its phase-4 shape, split into staging (host clock), decode + mix, FIR
   and post (CUDA events), and the device's share of a profiled ``fm`` and
   ``fsk`` run; one channelizer dispatch at its phase-4 shape split into
   staging, the copy, decode + mask, the branch FIR, the DFT, the phase,
   the way back and the file writes, with its bound; PSK's two device
   programs, its host tables and one ``-block`` peak at the BPSK burst; the
   device's share of a profiled ``psk`` and ``channelize`` run.
   A yardstick does part of its kernel's work; its inputs are made outside
   the timed region, and the port never calls it.  The frontend kernels and
   their yardstick take tens of microseconds, less than a call of their
   Python wrapper costs the host, so each has two times: ``ms``, the
   device's own (:func:`device_ms`: replays of a CUDA graph that captured
   20 calls of the wrapper), and ``call_ms``, 20 calls back to back through
   the wrapper (:func:`time_ms`: the larger of the device's and the host's
   time per call).

The line before the last but one holds the kernels' JSON record: their
errors taken at the main paths' shapes (the v1 kernel, which no path
runs, at the stream chain's chunk), launches over the main paths, times,
``bound_ms`` (the larger of the bytes in and out once over 3.35 TB/s and
the f32 operations over 67 TFLOP/s) with ``bound_by``, ``library_ms``, and
for the frontend rows ``call_ms`` and ``library_call_ms``.  Then the card's name and power limit; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
import shutil
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
              ("write batch, 4000 taps", 256, 32, 4000, 0x1000),
              # the sweep behind the card's auto rule: a stream chunk outside the fused
              # envelope, narrow decimations, the spectral class at batch and chunk shapes
              ("stream chunk, D 100", 1, 100, 400, 40_000), ("stream chunk, D 4", 1, 4, 40, 1_000_000),
              ("batch, D 2", 256, 2, 40, 0x1000), ("batch, D 8 96 taps", 16384, 8, 96, 64),
              ("sparkfft batch, 4000 taps", 16384, 32, 4000, 64), ("stream chunk, D 8 1100 taps", 1, 8, 1100, 500_000),
              ("stream chunk, D 100 8192 taps", 1, 100, 8192, 40_000)]


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
    stft_cases = [(FileFormat.COMPLEX_INT8, w, None) for w in (2, 8, 32, 64, 128)]
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


def phase_frontend_edges() -> None:
    """Phase 3, the frontend kernels' edges, each against the plain version
    on the same tensors: staged loads at every alignment, the mask, ragged
    output counts, decimations that are no multiple of 4, one subfilter,
    the narrowest and widest STFT, and exact decode and mix."""
    from quadrs_tpu_torch.formats import FileFormat, synth_planes
    from quadrs_tpu_torch.ops import frontend as fe
    from quadrs_tpu_torch.ops.fir import lowpass_taps

    failures: list[str] = []

    def check(label, fmt, d, taps, n_out, *, w=None, offset=0, n_ok=None, h=None, exact=False):
        h = lowpass_taps(200_000 / SAMPLE_RATE, taps) if h is None else h
        spec = fe.FrontendSpec(fmt, SAMPLE_RATE, 280_000, d, h.tobytes())
        n = (n_out + spec.m_sub) * d + 16
        raw = torch.from_numpy(synth_planes(fmt, n, seed=d + taps + offset)).to(DEVICE)
        planes = raw[:, offset:]  # a view: its base pointer sits `offset` samples into the rows
        bases = torch.from_numpy(fe.tile_bases_t(spec, 999_999_937, n_out)).to(DEVICE)
        tables = fe.frontend_tables(spec, w, device=DEVICE)
        n_ok = planes.shape[1] + (0 if n_ok is None else n_ok) if (n_ok or -1) < 0 else n_ok
        got = fe.fused_frontend_t(planes, bases, spec, n_out, n_valid=n_ok, stft_width=w, tables=tables)
        want = fe.fused_frontend_t_reference(planes, bases, spec, n_out, n_ok, tables, stft_width=w)
        err, _ = compare(f"{'frontend_fir_stft' if w else 'frontend_fir'} {fmt.value} {label}", got, want, failures)
        if exact and err != 0.0:
            failures.append(f"{fmt.value} {label}: error {err} is not 0")

    for fmt in FileFormat:
        block = fe.launch_plan(fe.FrontendSpec(fmt, SAMPLE_RATE, 280_000, 32, lowpass_taps(0.01, 400).tobytes())).bout
        for offset in range(16):
            check(f"D32 400 taps, view {offset} samples into its rows", fmt, 32, 400, 4096, offset=offset)
        for taps in (399, 401):
            check(f"D32 {taps} taps (odd filter), view {taps - taps // 2} in", fmt, 32, taps, 4096, offset=taps - taps // 2)
        for label, n_ok in (("inside the first block", 1000), ("on a block boundary", 3 * block * 32),
                            ("1 below the end", -1)):
            check(f"D32 400 taps, n_ok {n_ok} {label}", fmt, 32, 400, 4096, n_ok=n_ok)
        check("D32 400 taps, n_out 5003 (no multiple of 8)", fmt, 32, 400, 5003)
        check("D32 400 taps, n_out 8192 + 100", fmt, 32, 400, 8292)
        for d in (1, 3, 5, 33, 64):
            check(f"D{d} {12 * d + 1} taps", fmt, d, 12 * d + 1, 9001)
        check("D32 20 taps (one subfilter)", fmt, 32, 20, 4099)
        for w in (2, 128):
            check(f"D32 400 taps W{w}, view 5 in", fmt, 32, 400, 4096, w=w, offset=5)
        check("D1, a single unit tap", fmt, 1, 1, 70_001, h=np.float32([1.0]), exact=True)
    if failures:
        raise AssertionError(f"frontend kernels disagree with their plain versions: {failures}")


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


def phase_loader(cap: str, tmp: str) -> None:
    """Phase 3, the loader: ``read_planes`` and the prefetched chunks (the
    stream chain's 4M-sample chunks with their lookahead) against
    ``SampleSource.stage`` of the same bytes in memory, bit for bit, over
    the 2^26-sample cs8 capture and a 2^22-sample cu8 and cs16 one, whose
    files end on a partial pair; reads straddle and lie past EOF."""
    from quadrs_tpu_torch.formats import FileFormat
    from quadrs_tpu_torch.sources import SampleSource, open_capture

    rng = np.random.default_rng(SEED)
    files = [(cap, FileFormat.COMPLEX_INT8)]
    for fmt in (FileFormat.COMPLEX_UINT8, FileFormat.COMPLEX_INT16):
        path = os.path.join(tmp, f"loader.sr21M.{fmt.value}")
        with open(path, "wb") as f:
            f.write(rng.integers(0, 256, PREFIX_SAMPLES * fmt.pair_bytes + 1, dtype=np.uint8).tobytes())
        files.append((path, fmt))
    la = 600  # the stream chain's lookahead at 400 taps
    for path, fmt in files:
        src = open_capture(path)
        mem = SampleSource(np.fromfile(path, dtype=np.uint8), fmt, SAMPLE_RATE)
        n = src.length
        if src.native is None or n != mem.length:
            raise AssertionError(f"{path}: not read through the loader, or {n} != {mem.length} samples")
        t0 = time.perf_counter()
        reads = [(0, n), (12_345, CHUNK), (n - 1000, 5000), (n - 1, 1), (n, 100), (n + 17, 3)]
        for off, m in reads:
            got, want = src.native.read_planes(off, m), mem.stage(off, off + m)
            real = want.shape[1]
            if got.shape != (2, m) or got[:, :real].tobytes() != want.tobytes() or got[:, real:].any():
                raise AssertionError(f"{path}: read_planes({off}, {m}) differs from stage")
        chunks = 0
        for start in (0, 999_983):
            for off, planes in src.native.prefetch(CHUNK, start_off=start, overlap=la):
                want = mem.stage(off, off + CHUNK + la)
                if planes.shape != want.shape or planes.tobytes() != want.tobytes():
                    raise AssertionError(f"{path}: prefetched chunk at {off} differs from stage")
                chunks += 1
        print(f"  loader {fmt.value}: {n} samples, {len(reads)} reads (2 straddling EOF, 2 past it) and {chunks} "
              f"prefetched chunks of {CHUNK}+{la} equal stage bit for bit, {time.perf_counter() - t0:.2f}s")


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
    lines = [line.replace("\x1b", "\\e") for line in lines]  # the live rows' ANSI escapes, as text
    print("    " + "\n    ".join(lines + err.getvalue().strip().splitlines()))
    if rc != expect_rc or err_has not in err.getvalue():
        raise AssertionError(f"{argv[0]} exited {rc}: {err.getvalue().strip()}")
    return out


def start_replay(source: str) -> subprocess.Popen:
    """``replay -speed 0 SOURCE`` in another process, its stdout a pipe.
    Started ahead of its consumer, its start-up overlaps other work: it
    writes until the pipe is full, then waits."""
    env = dict(os.environ, QUADRS_PLATFORM="cpu")  # replay moves bytes: no device work
    return subprocess.Popen([sys.executable, "-m", "quadrs_tpu_torch", "replay", "-speed", "0", source],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env)


def piped(argv: list[str], source: str, walls: dict[str, float] | None = None, name: str = "",
          producer: subprocess.Popen | None = None) -> str:
    """The CLI in this process, its stdin the stdout of ``replay -speed 0
    SOURCE`` in another (``producer``, or one started now); with ``walls``,
    ``walls[name]`` is the CLI's wall from the producer's first byte."""
    import types

    producer = producer or start_replay(source)
    stdin = sys.stdin
    sys.stdin = types.SimpleNamespace(buffer=producer.stdout)
    try:
        t0 = time.perf_counter()
        producer.stdout.peek(1)  # the producer is up: its start is not the consumer's time
        waited, t0 = time.perf_counter() - t0, time.perf_counter()
        out = run_cli(argv)
        if walls is not None:
            walls[name] = time.perf_counter() - t0
    finally:
        sys.stdin = stdin
        producer.stdout.close()
        err = producer.stderr.read().decode().strip()
        rc = producer.wait(timeout=120)
    print(f"    producer: {err}; its first byte came {waited:.2f}s after the consumer's start")
    if rc != 0 or not err.startswith("replay: "):
        raise AssertionError(f"replay exited {rc}: {err}")
    return out


def phase_main_path(card: str, path: str, tmp: str) -> tuple[dict[str, int], np.ndarray]:
    """Phase 4, the stream: the CLI's stream path over the 2^26-sample
    capture at ``path``, read through the loader's ring; returns each
    kernel's launches over the phase, and the ``-out`` norms."""
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
    return {"frontend_fir": k1.launches, "frontend_fir_stft": k2.launches}, norms


def phase_live_path(card: str, cap: str, tmp: str, norms: np.ndarray) -> dict[str, int]:
    """Phase 4, the ring and the live paths, on the card: ``stream``'s
    ``-out`` norms (``norms``, read through the loader's ring) against the
    same bytes staged from memory; ``replay -speed 0 | stream -stdin yes
    [-search yes]`` against the file runs; ``stream -trigger`` from the file
    and from the pipe; ``waterfall|scan -stdin yes`` against a one-file bank;
    ``info`` against its CPU run.  Every comparison is bit for bit except
    ``info``'s f32 sums.  Returns each kernel's launches over the phase."""
    import glob

    from quadrs_tpu_torch.formats import FileFormat
    from quadrs_tpu_torch.models.receiver import PipelineModel
    from quadrs_tpu_torch.ops import frontend as fe
    from quadrs_tpu_torch.ops import waterfall as wf
    from quadrs_tpu_torch.sources import SampleSource
    from quadrs_tpu_torch.stream_runner import StreamRunner

    os.environ.pop("QUADRS_PLATFORM", None)  # the CLI's default device: cuda
    cfg = bench_cfg(FileFormat.COMPLEX_INT8)
    chunks = n_chunks(CAPTURE_SAMPLES, cfg)
    kernels = {"frontend_fir": fe.frontend_fir, "frontend_fir_stft": fe.frontend_fir_stft,
               "waterfall_norms": wf.waterfall_norms, "waterfall_search": wf.waterfall_search,
               "waterfall_scan": wf.waterfall_scan}
    total = dict.fromkeys(kernels, 0)

    def counted(what: str, want: dict[str, int], fn):
        """Run ``fn`` with every count at 0 before it; hold the counts after it to ``want``."""
        for k in kernels.values():
            k.launches = 0
        out = fn()
        got = {name: k.launches for name, k in kernels.items() if k.launches}
        print(f"    {what}: launches {got} ({card})")
        if got != want:
            raise AssertionError(f"{what} launched {got}, expected {want}")
        for name, v in got.items():
            total[name] += v
        return out

    def same_file(a: str, b: str, what: str) -> None:
        with open(a, "rb") as f, open(b, "rb") as g:
            if f.read() != g.read():
                raise AssertionError(f"{what}: {a} and {b} differ")

    def untimed(out: str) -> list[str]:
        return [ln.rsplit(" windows, ", 1)[0] if " Msps" in ln else ln for ln in out.splitlines()]

    # the ring against the route it replaces: the same bytes as an in-memory source, staged with numpy
    rows = []
    mem = SampleSource(np.fromfile(cap, dtype=np.uint8), cfg.fmt, SAMPLE_RATE)
    st = counted("stream over the same bytes in memory", {"frontend_fir": chunks},
                 lambda: StreamRunner(mem, PipelineModel(cfg), DEVICE, chunk_samples=CHUNK).run(lambda w0, r: rows.append(r)))
    same = np.array_equal(np.concatenate(rows), norms)
    print(f"  stream -out norms through the ring vs the in-memory route ({st.msps:.1f} Msps): "
          f"{norms.shape[0]} windows, bit-equal: {same}")
    if not same:
        raise AssertionError("the ring's norms differ from the in-memory route's")

    stream = ["stream", "-shift", "280k", "-chunk", str(CHUNK)]
    sdin = ["-stdin", "yes", "-sr", str(SAMPLE_RATE), "-format", "cs8"]
    f_out, p_out = os.path.join(tmp, "out"), os.path.join(tmp, "pipe")
    counted("replay | stream -stdin yes", {"frontend_fir": chunks}, lambda: piped([*stream, *sdin, "-out", p_out], cap))
    same_file(f"{f_out}.norms.f32", f"{p_out}.norms.f32", "stream -stdin")
    counted("replay | stream -stdin yes -search yes", {"frontend_fir": chunks},
            lambda: piped([*stream, *sdin, "-search", "yes", "-out", p_out], cap))
    same_file(f"{f_out}.peaks.csv", f"{p_out}.peaks.csv", "stream -stdin -search")
    print("  replay | stream -stdin: norms and peaks files equal the file runs' byte for byte")

    # the burst recorder: a level that a few dozen windows of noise cross
    peaks = np.loadtxt(f"{f_out}.peaks.csv", delimiter=",", skiprows=1, ndmin=2)[:, 2]
    level = float(np.sort(peaks)[-40])
    trig = [*stream, "-trigger", repr(level), "-pre", "2", "-post", "1"]
    os.makedirs(os.path.join(tmp, "tf"))
    os.makedirs(os.path.join(tmp, "tp"))
    out_f = counted("stream -trigger (file)", {"frontend_fir": chunks},
                    lambda: run_cli([*trig, "-out", os.path.join(tmp, "tf", "rec"), cap]))
    out_p = counted("replay | stream -stdin yes -trigger", {"frontend_fir": chunks},
                    lambda: piped([*trig, *sdin, "-out", os.path.join(tmp, "tp", "rec")], cap))
    names = sorted(os.path.basename(f) for f in glob.glob(os.path.join(tmp, "tf", "rec.b*")))
    if not names or names != sorted(os.path.basename(f) for f in glob.glob(os.path.join(tmp, "tp", "rec.b*"))):
        raise AssertionError(f"burst files differ in name: {len(names)} from the file run")
    with open(cap, "rb") as f:
        for name in names:
            same_file(os.path.join(tmp, "tf", name), os.path.join(tmp, "tp", name), "stream -trigger")
            s0 = int(name.split(".s")[1].split(".")[0])
            with open(os.path.join(tmp, "tf", name), "rb") as g:
                burst = g.read()
            f.seek(2 * s0)
            if f.read(len(burst)) != burst:
                raise AssertionError(f"{name} is no slice of the capture")
    if untimed(out_f.replace(os.path.join(tmp, "tf"), "")) != untimed(out_p.replace(os.path.join(tmp, "tp"), "")):
        raise AssertionError("stream -trigger prints different lines from the pipe")
    print(f"  stream -trigger {level:.6g}: {len(names)} burst files, from the pipe and from the file equal byte for byte, "
          "each a slice of the capture")

    # a one-file bank against the same bytes from the pipe
    bank = os.path.join(tmp, "one.sr21M.cs8")
    with open(cap, "rb") as f, open(bank, "wb") as g:
        g.write(f.read(2 * BANK_SAMPLES))
    nw = (BANK_SAMPLES - 1024) // 1024 + 1
    wfall = ["waterfall", "-width", "1024", "-chunk", str(BANK_CHUNK)]
    scan = ["scan", "-width", "1024", "-stride", "256", "-chunk", str(BANK_CHUNK), "-threshold", "20", "-top", "3", "-overwrite", "yes"]
    n_scan = -(-((BANK_SAMPLES - 1024) // 256 + 1) // BANK_CHUNK)
    w_f = counted("waterfall (one file)", {"waterfall_norms": -(-nw // BANK_CHUNK)}, lambda: run_cli([*wfall, "-out", f_out, bank]))
    w_p = counted("replay | waterfall -stdin yes", {"waterfall_norms": -(-nw // BANK_CHUNK)},
                  lambda: piped([*wfall, *sdin, "-out", p_out], bank))
    same_file(f"{f_out}.s0.norms.f32", f"{p_out}.s0.norms.f32", "waterfall -stdin")
    s_f = counted("scan (one file)", {"waterfall_scan": n_scan}, lambda: run_cli([*scan, "-out", f_out, bank]))
    s_p = counted("replay | scan -stdin yes", {"waterfall_scan": n_scan}, lambda: piped([*scan, *sdin, "-out", p_out], bank))
    same_file(f"{f_out}.s0.scan.csv", f"{p_out}.s0.scan.csv", "scan -stdin")
    for a, b in ((w_f, w_p), (s_f, s_p)):
        if untimed(a.replace(f_out, "")) != untimed(b.replace(p_out, "")):
            raise AssertionError("a bank command prints different lines from the pipe")
    print("  waterfall|scan -stdin yes: norms file, survey table and printed lines equal the one-file bank's")

    # info: the f32 chunk sums on the card against the CPU's
    on_card = counted("info", {}, lambda: run_cli(["info", cap]))
    os.environ["QUADRS_PLATFORM"] = "cpu"
    try:
        on_cpu = run_cli(["info", cap])
    finally:
        os.environ.pop("QUADRS_PLATFORM", None)
    import re

    number = re.compile(r"[-+]?\d+\.?\d*(?:e[-+]?\d+)?")
    for a, b in zip(on_card.splitlines()[:-1], on_cpu.splitlines()[:-1], strict=True):
        if number.sub("#", a) != number.sub("#", b):
            raise AssertionError(f"info prints {a!r} on the card and {b!r} on the CPU")
        for ma, mb in zip(number.finditer(a), number.finditer(b)):
            x, y = float(ma.group()), float(mb.group())
            # equal as printed, or within 1e-4 of the value (a dc offset: of the rms, which is under 1
            # here), or one step of the single decimal of a dB figure
            step = 0.11 if a[ma.end() : ma.end() + 3] == " dB" else 0.0
            if ma.group() != mb.group() and abs(x - y) > max(1e-4 * abs(y) + 2e-7, step):
                raise AssertionError(f"info: {ma.group()} on the card, {mb.group()} on the CPU")
    print("  info: the card's lines equal the CPU's (numbers within 1e-4)")
    return total


SPARK_BOUNDS = np.concatenate([[0.08, 1.0], np.float32(0.08) + (np.float32(1.0) - np.float32(0.08)) / np.float32(7.0)
                               * np.arange(1, 7, dtype=np.float32)]).astype(np.float32)


def glyph_diffs(rows: list[str], cpu_rows: list[str], cpu_stream, width: int, stride: int) -> tuple[int, int]:
    """sparkfft rows printed on the card against the CPU's over the prefix:
    (rows that differ, glyphs that differ).  Each differing glyph's CPU norm
    (``cpu_stream``'s window, on the CPU) must lie within ``TOL`` of its
    value from a level, or this raises."""
    from quadrs_tpu_torch.ops.stft import stft_norms
    from quadrs_tpu_torch.runtime import Executor

    bad = [r for r in range(len(cpu_rows)) if rows[r] != cpu_rows[r]]
    near = 0
    if bad:
        # each differing glyph's distance to the nearest level, relative to its value
        # (tests/test_sparkfft.py::test_ook_quantization_margins) and in f32 spacings there
        norms = Executor(cpu_stream, width, "cpu", post=stft_norms).run(np.asarray(bad, dtype=np.int64) * stride)[0]
        for i, r in enumerate(bad):
            for k, (a, b) in enumerate(zip(rows[r][1:-1], cpu_rows[r][1:-1])):
                if a != b:
                    level = SPARK_BOUNDS[np.abs(SPARK_BOUNDS - norms[i, k]).argmin()]
                    margin = float(abs(level - norms[i, k]) / max(float(norms[i, k]), 1e-12))
                    print(f"    row {r} bin {k}: {a!r} on the card, {b!r} on the CPU; norm {norms[i, k]:.9g} lies "
                          f"{margin:.2e} of its value ({abs(level - norms[i, k]) / np.spacing(level):.1f} f32 spacings) "
                          f"from the level {level:.9g}")
                    if margin > TOL:
                        raise AssertionError(f"sparkfft row {r} bin {k}: {a!r} vs {b!r}, {margin:.2e} from a level")
                    near += 1
    return len(bad), near


def all_launches() -> dict[str, int]:
    from quadrs_tpu_torch.ops import frontend as fe
    from quadrs_tpu_torch.ops import waterfall as wf

    return {k.__name__: k.launches for k in (fe.frontend_fir, fe.frontend_fir_stft, fe.frontend_banded,
                                             wf.waterfall_norms, wf.waterfall_search, wf.waterfall_scan)}


@contextlib.contextmanager
def counting_dispatches(kind: str = "_ChannelStep"):
    """Counts the receivers' streaming dispatches (calls of
    ``models.demod._ChannelStep``, or of ``kind``: ``_MeshChannelStep``, a
    mesh's dispatch) while open: yields a dict whose ``n`` each call adds
    one to."""
    from quadrs_tpu_torch.models import demod

    cls = getattr(demod, kind)
    count = {"n": 0}
    call = cls.__call__

    def counted(step, o):
        count["n"] += 1
        return call(step, o)

    cls.__call__ = counted
    try:
        yield count
    finally:
        cls.__call__ = call


def card_run(name: str, argv: list[str], card: str, walls: dict[str, float], expect_rc=0, err="",
             samples: int = CAPTURE_SAMPLES) -> str:
    """``argv`` through the CLI on the card over a capture of ``samples``;
    records its wall in ``walls[name]`` and raises if it launched a kernel
    of the port (these paths run as torch ops).  Returns its stdout."""
    os.environ.pop("QUADRS_PLATFORM", None)  # the CLI's default device: cuda
    before = all_launches()
    t0 = time.perf_counter()
    out = run_cli(argv, expect_rc, err)
    walls[name] = time.perf_counter() - t0
    launched = {k: v - before[k] for k, v in all_launches().items() if v != before[k]}
    print(f"    {name}: {walls[name]:.3f}s, {samples / walls[name] / 1e6:.1f} Msps ({card}); "
          f"kernel launches: {launched or 'none'}")
    if launched:
        raise AssertionError(f"{name} launched {launched}: the chain runs as torch ops")
    return out


def cpu_run(name: str, argv: list[str], expect_rc=0, err="") -> str:
    """``argv`` through the CLI on the CPU (``QUADRS_PLATFORM=cpu``)."""
    os.environ["QUADRS_PLATFORM"] = "cpu"
    t0 = time.perf_counter()
    try:
        out = run_cli(argv, expect_rc, err)
    finally:
        os.environ.pop("QUADRS_PLATFORM", None)
    print(f"    {name}, the prefix on the CPU: {time.perf_counter() - t0:.3f}s")
    return out


def card_then_cpu(name: str, argv, cap: str, pre: str, card: str, walls: dict[str, float], expect_rc=0,
                  err=("", ""), samples: int = CAPTURE_SAMPLES) -> tuple[str, str]:
    """``argv(capture, tag)`` through the CLI on the card over ``cap`` of
    ``samples`` (:func:`card_run`), then on the CPU over the prefix capture
    ``pre``.  Returns both stdouts."""
    out = card_run(name, argv(cap, "gpu"), card, walls, expect_rc, err[0], samples)
    return out, cpu_run(name, argv(pre, "cpu"), expect_rc, err[1])


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
        return card_then_cpu(name, argv, cap, pre, card, walls, expect_rc, err)

    def chain_stream(path, taps_power=200):
        return LowPass(Shift(open_capture(path), 280_000), 200_000, 32, 2 * taps_power)

    # sparkfft: rows equal except glyphs whose plain norm is within f32 noise of a level
    out, cpu_out = both("sparkfft", lambda path, tag: ["from", path, *lp200, "sparkfft", "-width", "64", "-stride", "16"])
    rows, cpu_rows = out.splitlines()[1:], cpu_out.splitlines()[1:]
    length = 1 + (CAPTURE_SAMPLES - 400) // 32
    if len(rows) != len(range(0, length - 64, 16)) or not cpu_rows:
        raise AssertionError(f"sparkfft printed {len(rows)} rows for a {length}-sample stream")
    bad, near = glyph_diffs(rows, cpu_rows, chain_stream(pre), 64, 16)
    print(f"  sparkfft: {len(cpu_rows)} rows of the prefix compared, {bad} differ, {near} glyphs within "
          f"{TOL} of a level (the chain's f32 tolerance: the documented exception)")
    # the rows are built as one byte buffer a batch: byte-equal to one string a row over the card's own norms
    from quadrs_tpu_torch import sinks

    offs = np.arange(0, 16 * min(16384, len(rows)), 16, dtype=np.int64)
    card_norms = Executor(chain_stream(cap), 64, DEVICE, post=stft_norms).run(offs)[0]
    levels = sinks.glyph_levels(card_norms, sinks.DEFAULT_SPARK_MIN, sinks.DEFAULT_SPARK_MAX)
    per_row = ["│" + "".join(row) + "│" for row in sinks.SPARK_GLYPHS[levels]]
    if rows[: len(offs)] != per_row:
        raise AssertionError("the vectorized glyph rows differ from one string a row")
    print(f"  sparkfft: the first {len(offs)} rows equal one string a row over the card's norms, byte for byte")

    # bucket: digits equal except near-ties of the plain half sums
    with counting_dispatches() as dispatches:  # bucket takes the receivers' streaming route
        out, cpu_out = both("bucket", lambda path, tag: ["from", path, *lp200, "bucket", "-by", "freq", "2"])
    if dispatches["n"] < 2:
        raise AssertionError(f"bucket: {dispatches['n']} streaming dispatches")
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
    print(f"  bucket: {len(cpu_digits)} digits of the prefix compared, {len(bad)} differ (near-ties); "
          f"{dispatches['n']} streaming dispatches over both runs")

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


FIND_LEN = 1024  # phase 4: the single template of the find runs
FIND_BANK = (1024, 700, 512)  # phase 4: the bank's templates
FIND_STEP = 0.4 * SAMPLE_RATE / FIND_LEN  # find's default grid step for the bank (Hz)
FIND_TOL = "32k"  # 4 steps a side: a 9-row grid
FIND_BLOCKS = {1024: (4096, 8192, 16384, 32768, 65536), 4096: (8192, 16384, 32768, 65536)}  # phase 5: c by l


def find_plants(n: int, prefix: int, boundary: int):
    """Where phase 4 plants its templates in an ``n``-sample capture whose
    first ``prefix`` samples the CPU runs read: (the single template's
    ``(offset, gain, phase)``, one at the lag just left of a dispatch
    boundary and one flush with the end; the bank's ``(offset, template,
    grid row, gain, phase)``), three of each kind inside the prefix."""
    single = [(1000, 0.05, 0.3), (prefix // 3 + 1, 2.0, 1.1), (boundary - 1, 0.3, 2.0), (n // 6 + 3, 1.0, 2.9),
              (n // 3 + 7, 0.7, 4.0), (n // 2 - 1, 0.1, 5.2), (3 * n // 4 + 11, 1.5, 0.7), (n - FIND_LEN, 0.5, 3.3)]
    bank = [(prefix // 8, 0, -3, 0.5, 0.2), (prefix // 2 + 5, 1, 2, 1.0, 1.7), (7 * prefix // 8 - 3, 2, 4, 0.2, 2.5),
            (n // 4 + 9, 0, 1, 1.5, 3.9), (5 * n // 8 + 1, 1, -4, 0.1, 5.0), (7 * n // 8 + 13, 2, 0, 0.8, 0.9)]
    return single, bank


def write_find_capture(path: str, tmp: str, signal: str) -> dict:
    """The phase 4 capture of ``find``: a copy of :func:`write_capture`'s
    ``signal`` with random cs8 templates written over it at
    :func:`find_plants`' offsets, each scaled, rotated and (the bank's)
    shifted onto a row of the frequency grid; the templates as cs8 files
    beside it."""
    from quadrs_tpu_torch import sinks

    shutil.copyfile(signal, path)
    rng = np.random.default_rng(SEED + 7)
    names, codes = [], []
    for i, l in enumerate((FIND_LEN, *FIND_BANK)):
        t = rng.integers(-60, 61, (l, 2)).astype(np.int8)  # doubled, still inside int8
        names.append(os.path.join(tmp, f"{'t' if i == 0 else f'b{i - 1}'}.sr21M.cs8"))
        t.tofile(names[-1])
        codes.append(t)
    c = sinks.find_block(FIND_LEN, CAPTURE_SAMPLES)
    boundary = sinks.FIND_DISPATCH_BUDGET // c * (c - FIND_LEN + 1)  # the first dispatch's lags
    single, bank = find_plants(CAPTURE_SAMPLES, PREFIX_SAMPLES, boundary)
    with open(path, "r+b") as f:
        for code, (o, g, ph), hz in [(codes[0], p, 0.0) for p in single] + [
                (codes[1 + k], (o, g, ph), row * FIND_STEP) for o, k, row, g, ph in bank]:
            m = np.arange(len(code))
            z = (code[:, 0] + 1j * code[:, 1]) * g * np.exp(1j * (ph + 2 * np.pi * hz * m / SAMPLE_RATE))
            f.seek(2 * o)
            f.write(np.clip(np.rint(np.stack([z.real, z.imag], -1)), -127, 127).astype(np.int8).tobytes())
    return {"template": names[0], "bank": names[1:], "single": single, "bank_plants": bank, "block": c,
            "boundary": boundary}


def find_rows(out: str) -> tuple[list[tuple[int, float, float, float, int]], str]:
    """A ``find`` run's match lines as ``(offset, score, scale, freq,
    which)`` and its closing line."""
    lines = out.strip().splitlines()
    rows = [ln.split(",") for ln in lines if ln[:1].isdigit()]
    return [(int(r[0]), float(r[1]), float(r[2]), float(r[3]), int(r[4]) if len(r) > 4 else 0) for r in rows], lines[-1]


def same_matches(what: str, got, want, only_below: int | None = None) -> None:
    """Offsets, freqs and which exact; scores and scales within 2e-4 (and
    the print's rounding); with ``only_below``, of the matches at lags
    below it."""
    if only_below is not None:
        got = [r for r in got if r[0] < only_below]
    if [(r[0], r[3], r[4]) for r in got] != [(r[0], r[3], r[4]) for r in want]:
        raise AssertionError(f"{what}: matches {[(r[0], r[3], r[4]) for r in got]} vs {[(r[0], r[3], r[4]) for r in want]}")
    worst = max([max(abs(a[1] - b[1]), abs(a[2] - b[2]) / max(1.0, abs(b[2]))) for a, b in zip(got, want)] or [0.0])
    print(f"  {what}: {len(want)} matches, offsets, freqs and which equal; scores and scales within {worst:.1e}")
    if worst > 2e-4 + 5e-5:
        raise AssertionError(f"{what}: scores or scales {worst:.2e} apart")


def profiled(argv: list[str]) -> tuple[float, float]:
    """(wall s, device busy s) of one more card run of ``argv`` under
    ``torch.profiler`` (busy: the union of the device's event intervals,
    as ``profile_stream.py`` reads it)."""
    from torch.profiler import ProfilerActivity, profile

    from profile_stream import device_busy

    with contextlib.redirect_stdout(io.StringIO()), profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_cli(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return wall, device_busy(prof)[0] / 1e3


def phase_find_path(card: str, tmp: str, signal: str) -> tuple[dict[str, float], str]:
    """Phase 4, ``find`` through the CLI over a 2^26-sample cs8 capture with
    planted templates (over a copy of ``signal``): the single template at
    its 8 offsets (scores above 0.9), the 3-template bank over a 9-row grid
    (offsets, which and freqs), each against the same argv on the CPU over
    the 2^22-sample prefix; ``-write`` slices against the capture's bytes;
    the bank from a pipe (``replay -speed 0 | find -stdin yes``) against the
    file run; the dispatches of each kind (some must take the device scan).
    Returns walls and device shares, and the pipe run's stdout."""
    from quadrs_tpu_torch import sinks

    laps = [("start", time.perf_counter())]  # where the phase's own time goes
    cap, pre = os.path.join(tmp, "find.sr21M.cs8"), os.path.join(tmp, "findpre.sr21M.cs8")
    plan = write_find_capture(cap, tmp, signal)
    with open(cap, "rb") as f, open(pre, "wb") as g:
        g.write(f.read(PREFIX_SAMPLES * 2))
    walls: dict[str, float] = {}
    counts = sinks.find_pattern.dispatches
    bank_args = [a for b in plan["bank"] for a in ("-pattern", b)] + ["-freq-tol", FIND_TOL]
    argv_of = {"find": lambda path: ["from", path, "find", "-pattern", plan["template"]],
               "find bank": lambda path: ["from", path, "find", *bank_args]}
    want_rows = {"find": [(o, 0.0, g, 0.0, 0) for o, g, _ in sorted(plan["single"])],
                 "find bank": [(o, 0.0, g, row * FIND_STEP, k) for o, k, row, g, _ in sorted(plan["bank_plants"])]}
    print(f"  find: block {plan['block']}, the first dispatch's last lag {plan['boundary'] - 1}")
    # the pipe's producer starts here: its start-up (seconds: it imports
    # torch) overlaps the file runs below; it then waits on the full pipe
    laps.append(("capture", time.perf_counter()))
    producer = start_replay(cap)
    try:
        on_card = {}
        for name, want in want_rows.items():
            counts.update(extract=0, overflow=0, full=0)
            got, closing = find_rows(card_run(name, argv_of[name](cap), card, walls))
            on_card[name] = got
            print(f"    {name}: dispatches {dict(counts)} on the card")
            if counts["extract"] == 0:
                raise AssertionError(f"{name}: every dispatch took the full-score path")
            if closing != f"find: {len(want)} matches, pattern {FIND_LEN} samples, {CAPTURE_SAMPLES} scanned":
                raise AssertionError(f"{name}: {closing!r}")
            if [(r[0], r[4]) for r in got] != [(r[0], r[4]) for r in want] or any(
                    abs(a[3] - b[3]) > 0.5 for a, b in zip(got, want)):
                raise AssertionError(f"{name}: found {got}")
            if min(r[1] for r in got) <= 0.9 or any(abs(a[2] - b[2]) > 0.05 * max(b[2], 0.1) for a, b in zip(got, want)):
                raise AssertionError(f"{name}: scores or scales off: {got}")
            print(f"  {name}: the {len(got)} planted offsets (and templates and grid rows) found; scores "
                  f"{min(r[1] for r in got):.4f}-{max(r[1] for r in got):.4f}; scales within 5% of the gains")
        laps.append(("card runs", time.perf_counter()))

        for name in want_rows:
            cpu_rows = find_rows(cpu_run(name, argv_of[name](pre)))[0]
            same_matches(f"{name}, the card against the CPU over the prefix", on_card[name], cpu_rows,
                         PREFIX_SAMPLES - FIND_LEN + 1)
        laps.append(("CPU runs", time.perf_counter()))

        # -write: each slice the capture's bytes
        os.makedirs(os.path.join(tmp, "fw"))
        prefix = os.path.join(tmp, "fw", "m")
        run_cli(["from", cap, "find", "-pattern", plan["template"], "-write", prefix, "-pre", "100", "-post", "100"])
        with open(cap, "rb") as f:
            raw = f.read()
        names = sorted(os.listdir(os.path.join(tmp, "fw")))
        for name in names:
            s0 = int(name.split(".s")[1].split(".")[0])
            with open(os.path.join(tmp, "fw", name), "rb") as g:
                data = g.read()
            if data != raw[2 * s0 : 2 * s0 + len(data)] or len(data) != 2 * (min(s0 + FIND_LEN + 200, CAPTURE_SAMPLES) - s0):
                raise AssertionError(f"find -write: {name} is no slice of the capture")
        if len(names) != len(plan["single"]):
            raise AssertionError(f"find -write wrote {len(names)} files")
        print(f"  find -write: {len(names)} files, each the capture's bytes of its match widened by 100 a side")
        del raw
        laps.append(("-write", time.perf_counter()))
    except BaseException:
        producer.kill()
        producer.wait()
        raise

    # the bank from the pipe: the file run's lines
    counts.update(extract=0, overflow=0, full=0)
    out = piped(["find", *bank_args, "-stdin", "yes", "-sr", str(SAMPLE_RATE), "-format", "cs8"], cap, walls,
                "replay | find bank -stdin", producer)
    got, closing = find_rows(out)
    wall = walls["replay | find bank -stdin"]
    print(f"    replay | find -stdin (bank): {wall:.3f}s from the first byte, {CAPTURE_SAMPLES / wall / 1e6:.1f} Msps; "
          f"dispatches {dict(counts)} ({card})")
    if closing != f"find: {len(on_card['find bank'])} matches, pattern {FIND_LEN} samples, {CAPTURE_SAMPLES} scanned":
        raise AssertionError(f"find -stdin: {closing!r}")
    same_matches("find -stdin (bank) against the file run", got, on_card["find bank"])
    laps.append(("the pipe", time.perf_counter()))

    find_breakdown(card, cap, plan["template"])
    laps.append(("breakdown", time.perf_counter()))
    for name in ("find", "find bank"):
        wall, busy = profiled(argv_of[name](cap))
        walls[f"{name} profiled"], walls[f"{name} busy"] = wall, busy
        print(f"  {name}, a profiled card run: wall {wall:.3f}s, device busy {busy:.3f}s, "
              f"device share {100 * busy / wall:.1f}% ({card})")
    laps.append(("profiled runs", time.perf_counter()))
    print("  find phase, its steps: " + ", ".join(f"{name} {t - laps[i][1]:.1f}s" for i, (name, t) in enumerate(laps[1:])))
    return walls, out


def find_breakdown(card: str, cap: str, template: str) -> dict[str, float]:
    """Where ``find``'s wall goes: its device-scan dispatches over ``cap``
    one stage at a time, as :class:`Executor` runs them (the root span into
    the page-locked slot through the loader, with the host's planning; the
    slot's copy; the device program; its outputs back; the host's side of
    the candidate scan).  The full-score tail is left out."""
    from quadrs_tpu_torch import sinks
    from quadrs_tpu_torch.ops.correlate import PeakScan, make_xcorr_post
    from quadrs_tpu_torch.runtime import Executor, _to_device, window_batches
    from quadrs_tpu_torch.sources import SampleSource, open_capture
    from quadrs_tpu_torch.staging import Download

    src, psrc = open_capture(cap), SampleSource.from_file(template)
    pat = psrc.read_at(0, psrc.length, DEVICE)[0]
    c = sinks.find_block(len(pat), src.length)
    n_out, thr = c - len(pat) + 1, float(np.float32(0.5))
    offsets = np.arange(0, src.length - len(pat) + 1, n_out, dtype=np.int64)
    batch, batches = window_batches(offsets, c, budget=max(c, sinks.FIND_DISPATCH_BUDGET))
    post = make_xcorr_post(pat, c, extract=(thr, sinks.FIND_TOPK))
    ex, scan = Executor(src, c, DEVICE, batch=batch), PeakScan(thr)
    t = dict(staging=0.0, h2d=0.0, device=0.0, d2h=0.0, host=0.0)
    t0 = time.perf_counter()
    for offs in batches:
        if len(offs) != batch or int(offs[-1]) + c > src.length:
            continue
        a = time.perf_counter()
        lo = int(offs[0])
        buf = ex._stage(lo, int(offs[-1]) + c)
        plan = src.plan(offs, c, lo)
        b = time.perf_counter()
        prep = _to_device(plan.prep, DEVICE)
        torch.cuda.synchronize()
        d0 = time.perf_counter()
        left = torch.tensor(scan.carry, dtype=torch.float32, device=DEVICE)
        out = post(src.read_batch({"buf": buf, "device": DEVICE}, prep, c), left)
        torch.cuda.synchronize()
        d1 = time.perf_counter()
        res = Download(out).wait()
        e = time.perf_counter()
        scan.feed_extract(lo, len(offs) * n_out, res)
        t["staging"] += b - a
        t["h2d"] += d0 - b
        t["device"] += d1 - d0
        t["d2h"] += e - d1
        t["host"] += time.perf_counter() - e
    total = time.perf_counter() - t0
    print(f"  find, its device-scan dispatches one stage at a time: {total * 1e3:.2f} ms, "
          + ", ".join(f"{k} {v * 1e3:.2f} ms ({100 * v / total:.1f}%)" for k, v in t.items()) + f" ({card})")
    return t


def phase_stage_path(card: str, cap: str, tmp: str) -> dict[str, float]:
    """Phase 4, the conditioning stages through the CLI over the 2^26-sample
    capture: ``iqbal dcblock agc resample 147/160 write`` and the FSK chain
    through ``dcblock agc`` into ``sparkfft``, each against the same argv on
    the CPU over the 2^22-sample prefix; then ``resample_real`` 656,250 to
    48,000 on the card against the CPU.  No kernel of the port launches."""
    from quadrs_tpu_torch.ops.resample import resample_real
    from quadrs_tpu_torch.sources import open_capture
    from quadrs_tpu_torch.stream import Agc, DcBlock, IqCorrect, LowPass, Resample, Shift

    laps = [("start", time.perf_counter())]  # where the phase's own time goes
    pre = os.path.join(tmp, "stagepre.sr21M.cs8")
    with open(cap, "rb") as f, open(pre, "wb") as g:
        g.write(f.read(PREFIX_SAMPLES * 2))
    walls: dict[str, float] = {}
    chain = ["iqbal", "dcblock", "agc", "resample", "147/160"]
    card_then_cpu("stages write", lambda path, tag: ["from", path, *chain, "write", os.path.join(tmp, f"st{tag}")],
                  cap, pre, card, walls)
    laps.append(("write runs", time.perf_counter()))
    got = np.fromfile(os.path.join(tmp, "stgpu.sr19293750.cf32"), np.complex64)
    want = np.fromfile(os.path.join(tmp, "stcpu.sr19293750.cf32"), np.complex64)
    # the stages read exactly what they need, so every sample the prefix
    # gives equals the capture's at the same index
    err, scale = float(np.abs(got[: len(want)] - want).max()), float(np.abs(want).max())
    print(f"  stages write: {len(got)} samples at 19,293,750 sps; the prefix's {len(want)}: max |diff| {err:.3e}, "
          f"scale {scale:.4g}, err/scale {err / scale:.3e}")
    full_len = Resample(Agc(DcBlock(IqCorrect(open_capture(cap), c=0, device="cpu"), 32_000)), 147, 160).length
    if not np.isfinite(got).all() or len(got) != full_len or err > 1e-5 * scale:
        raise AssertionError("stages write disagrees with the CPU run or its length")
    laps.append(("write check", time.perf_counter()))
    wall, busy = profiled(["from", cap, *chain, "write", "-overwrite", "yes", os.path.join(tmp, "stgpu")])
    walls["stages write profiled"], walls["stages write busy"] = wall, busy
    print(f"  stages write, a profiled card run: wall {wall:.3f}s, device busy {busy:.3f}s, "
          f"device share {100 * busy / wall:.1f}% ({card})")
    laps.append(("profiled run", time.perf_counter()))

    # the FSK chain through dcblock and agc: windows of 256 and 64 (the
    # defaults' 32k + 4k lookback is re-read for each 64-sample pull)
    cond = ["dcblock", "-window", "256", "agc", "-window", "64"]
    fsk = ["shift", "280k", "lowpass", "-power", "200", "-decimate", "32", "200k", *cond]
    out, cpu_out = card_then_cpu("stages sparkfft", lambda path, tag: ["from", path, *fsk, "sparkfft", "-width", "64",
                                                                       "-stride", "16"], cap, pre, card, walls)
    laps.append(("sparkfft runs", time.perf_counter()))
    rows, cpu_rows = out.splitlines()[1:], cpu_out.splitlines()[1:]
    length = 1 + (CAPTURE_SAMPLES - 400) // 32
    if len(rows) != len(range(0, length - 64, 16)) or not cpu_rows:
        raise AssertionError(f"stages sparkfft printed {len(rows)} rows for a {length}-sample stream")
    stream = Agc(DcBlock(LowPass(Shift(open_capture(pre), 280_000), 200_000, 32, 400), 256), window=64)
    bad, near = glyph_diffs(rows, cpu_rows, stream, 64, 16)
    print(f"  stages sparkfft: {len(cpu_rows)} rows of the prefix compared, {bad} differ, {near} glyphs within "
          f"{TOL} of a level")
    laps.append(("sparkfft check", time.perf_counter()))

    # the audio stage: 2^22 samples of a channel at 656,250 sps to 48 kHz
    g = torch.Generator(device=DEVICE).manual_seed(SEED)
    t = torch.arange(1 << 22, device=DEVICE, dtype=torch.float64) / 656_250
    audio = (torch.sin(2 * np.pi * 1000 * t) + 0.1 * torch.randn(t.shape, generator=g, device=DEVICE,
                                                                   dtype=torch.float64)).float()
    rate, y = resample_real(audio, 656_250, 48_000)
    rate_cpu, y_cpu = resample_real(audio.cpu(), 656_250, 48_000)
    err = float((y.cpu() - y_cpu).abs().max())
    scale = float(y_cpu.abs().max())
    ms = time_ms(lambda: resample_real(audio, 656_250, 48_000), iters=5)
    print(f"  resample_real 656,250 -> 48,000 of {audio.numel()} samples: {y.numel()} out, max |diff| card vs CPU "
          f"{err:.3e}, scale {scale:.4g}; {ms:.3f} ms on the card ({card})")
    if (rate, rate_cpu) != (48_000, 48_000) or y.shape != y_cpu.shape or err > 1e-5 * scale:
        raise AssertionError("resample_real disagrees with the CPU")
    walls["resample_real ms"] = ms
    laps.append(("resample_real", time.perf_counter()))
    print("  stage phase, its steps: " + ", ".join(f"{name} {t - laps[i][1]:.1f}s" for i, (name, t) in enumerate(laps[1:])))
    return walls


# phase 4's receiver captures (made with numpy from SEED, at the sizes users
# record): (file name, sample rate, samples)
RX_CAPTURES = {"ook": ("ook.sr1M.cs8", 1_000_000, 1 << 24), "fm": ("fm.sr2400k.cu8", 2_400_000, 1 << 25),
               "am": ("am.sr2400k.cu8", 2_400_000, 1 << 24), "ssb": ("ssb.sr2M.cs8", 2_000_000, 1 << 24)}
OOK_CHIP = 500  # samples a Manchester chip: 250 windows of stride 2 (ook -bit 250)
OOK_PAYLOAD = 32  # payload bits a burst
STATION = 500_000  # the FM and AM stations' offset from the centre (Hz)
TONE = 1000  # the audio tone of FM, AM and SSB (Hz)
RX_ARGV = {
    "ook": ["ook", "-width", "4", "-stride", "2", "-bit", "250"],
    "fsk": ["fsk", "-shift", "280k", "-lowpass", "200k", "-decimate", "32", "-width", "64"],
    "fm": ["fm", "-shift", f"-{STATION}", "-lowpass", "100k", "-decimate", "8", "-audio-rate", "48000"],
    "am": ["am", "-shift", f"-{STATION}", "-audio-rate", "48000"],
    "ssb": ["ssb", "-sideband", "usb"],
}


def write_iq(path: str, n: int, fmt: str, make, rng) -> None:
    """``n`` samples of ``make(absolute indices) -> unit-scale complex`` plus
    noise of 0.01 a component from ``rng``, as cs8 or cu8 (``x * 127.5 +
    127.5``), written block by block."""
    block = 1 << 22
    with open(path, "wb") as f:
        for lo in range(0, n, block):
            m = np.arange(lo, min(n, lo + block), dtype=np.int64)
            x = make(m) + 0.01 * (rng.standard_normal(len(m)) + 1j * rng.standard_normal(len(m)))
            iq = np.stack([x.real, x.imag], axis=-1)
            if fmt == "cs8":
                f.write(np.clip(np.rint(iq * 127), -127, 127).astype(np.int8).tobytes())
            else:
                f.write(np.clip(np.rint(iq * 127.5 + 127.5), 0, 255).astype(np.uint8).tobytes())


def angle_of(freq: int, rate: int, m: np.ndarray) -> np.ndarray:
    """``2 pi freq m / rate``, reduced exactly on the integers."""
    return 2 * np.pi * ((m * freq) % rate) / rate


def write_receiver_capture(name: str, tmp: str) -> tuple[str, str | None]:
    """One of phase 4's receiver captures in ``tmp`` (names and sizes:
    :data:`RX_CAPTURES`), its noise from ``default_rng([SEED, k])``: ``ook``,
    Manchester bursts of a known 32-bit payload (a chip 500 samples of a 100
    kHz carrier at 0.5 or of silence, 200 silent chips between bursts; the
    silence exactly zero, as the default threshold 0.001 is under cs8's
    smallest code); ``fm``, a 1 kHz tone at 75 kHz deviation; ``am``, a 1 kHz
    tone at modulation depth 0.5; both stations at +500 kHz, where ``-shift
    -500k`` brings them to DC (the reference's cu8 decode parks every sample
    near -127, which a station at DC would sit on); ``ssb``, a tone 1 kHz
    above a suppressed carrier at DC.  Returns the path and, for ``ook``,
    the payload as a 0/1 string."""
    file, rate, n = RX_CAPTURES[name]
    path = os.path.join(tmp, file)
    rng = np.random.default_rng([SEED, list(RX_CAPTURES).index(name)])
    if name == "ook":
        payload = rng.integers(0, 2, OOK_PAYLOAD)
        chips = np.repeat(np.stack([payload, 1 - payload], axis=1).reshape(-1), OOK_CHIP).astype(bool)
        env = np.zeros(n, dtype=bool)
        for s0 in range(100 * OOK_CHIP, n - chips.size, chips.size + 200 * OOK_CHIP):
            env[s0 : s0 + chips.size] = chips
        m = np.arange(n, dtype=np.int64)
        iq = 64 * env[:, None] * np.stack([np.cos(angle_of(100_000, rate, m)), np.sin(angle_of(100_000, rate, m))], -1)
        with open(path, "wb") as f:
            f.write(np.rint(iq).astype(np.int8).tobytes())
        return path, "".join(map(str, payload))
    make = {
        "fm": lambda m: 0.9 * np.exp(1j * (angle_of(STATION, rate, m) + 75 * np.sin(angle_of(TONE, rate, m)))),
        "am": lambda m: 0.3 * (1 + 0.5 * np.cos(angle_of(TONE, rate, m))) * np.exp(1j * angle_of(STATION, rate, m)),
        "ssb": lambda m: 0.5 * np.exp(1j * angle_of(TONE, rate, m)),
    }[name]
    write_iq(path, n, "cs8" if file.endswith("cs8") else "cu8", make, rng)
    return path, None


def samples_of(name: str) -> int:
    """Samples of the capture a receiver of phase 4 reads."""
    return RX_CAPTURES[name][2] if name in RX_CAPTURES else CAPTURE_SAMPLES


def prefix_of(path: str, n: int) -> str:
    """The first ``n`` samples of a capture, as a file of the same rate and format."""
    head, name = os.path.split(path)
    pre = os.path.join(head, "pre" + name)
    pair = {"cs8": 2, "cu8": 2, "cs16": 4, "cf32": 8}[name.rsplit(".", 1)[1]]
    with open(path, "rb") as f, open(pre, "wb") as g:
        g.write(f.read(n * pair))
    return pre


def tone_check(name: str, audio: np.ndarray, rate: int) -> float:
    """The audio's strongest frequency (its spectrum's peak, DC aside, over
    the whole audio); raises unless it is the tone, within one bin."""
    spec = np.abs(np.fft.rfft(audio.astype(np.float64) * np.hanning(len(audio))))
    spec[0] = 0.0
    freq = float(np.argmax(spec)) * rate / len(audio)
    print(f"    {name}: the audio's tone {freq:.3f} Hz (bins of {rate / len(audio):.4f} Hz)")
    if abs(freq - TONE) > rate / len(audio):
        raise AssertionError(f"{name}: tone at {freq} Hz, not {TONE}")
    return freq


def away_from_window_ends(n: int, ch_rate: int, out_rate: int = 48_000, chunk: int = 1 << 16) -> np.ndarray:
    """A mask of the ``n`` audio samples more than 100 away from where a
    receiver's channel window ends (every ``chunk`` channel samples) or the
    audio starts: the last outputs of each window see the channel FIR's
    per-read truncation, which on cu8 cuts off the decode's -127 offset
    (ROADMAP C), a click."""
    period = chunk * out_rate / ch_rate  # audio samples a window
    at = np.arange(n) % period
    return np.minimum(at, period - at) > 100


def audio_against_cpu(name: str, got: np.ndarray, want: np.ndarray) -> float:
    """The card's audio of the prefix against the CPU's: within 1e-5 of
    full scale (1)."""
    if got.shape != want.shape or not np.isfinite(got).all():
        raise AssertionError(f"{name}: {got.shape} samples on the card, {want.shape} on the CPU")
    err = float(np.abs(got - want).max())
    print(f"    {name}: the prefix's {len(got)} audio samples, card vs CPU: max |diff| {err:.3e} of full scale 1")
    if err > 1e-5:
        raise AssertionError(f"{name}: audio disagrees with the CPU run")
    return err


def fsk_halves(x: torch.Tensor):
    """``freq_levels``' post at width 64: the two halves' sums of each window's norms."""
    from quadrs_tpu_torch.ops.stft import stft_norms

    norms = stft_norms(x, shift=False)
    return norms[:, :32].sum(1), norms[:, 32:].sum(1)


def fsk_near_ties(bad: list[int], path: str, device) -> bool:
    """Whether each window in ``bad`` of ``fsk``'s phase-4 chain over
    ``path`` is a near-tie: its halves' sums within ``TOL`` of each other,
    on ``device`` through the Executor."""
    from quadrs_tpu_torch.runtime import Executor
    from quadrs_tpu_torch.sources import open_capture
    from quadrs_tpu_torch.stream import LowPass, Shift

    chan = LowPass(Shift(open_capture(path), 280_000), 200_000, 32, 400)
    first, second = Executor(chan, 64, device, post=fsk_halves).run(np.asarray(bad, dtype=np.int64) * 64)[0]
    return bool((np.abs(first - second) <= TOL * np.maximum(first, second)).all())


def phase_receiver_path(card: str, tmp: str, cap: str) -> tuple[dict[str, float], dict[str, str]]:
    """Phase 4, the receivers through the CLI on the card: ``ook`` over a
    2^24-sample cs8 capture at 1 Msps (the payload comes back), ``fsk`` over
    the stream's 2^26-sample capture (the README's flow), ``fm`` over a
    2^25-sample cu8 capture at 2.4 Msps into 48 kHz audio (tone and rms
    deviation), again with ``-wav yes`` and from ``replay -speed 0 | fm
    -stdin yes`` (bit for bit the file run's audio), ``am`` (2^24 cu8; tone
    and peak modulation) and ``ssb -sideband usb`` (2^24 cs8 at 2 Msps;
    tone).  Each against the same argv on the CPU over a 2^22-sample
    prefix: bits equal, symbols equal but at near-ties, audio (of the card's
    run over the prefix too: AM's carrier is the mean over the capture it
    is given) within 1e-5 of full scale.  All take the streaming front end
    and launch no kernel of the port.  Returns walls and the captures."""
    from quadrs_tpu_torch.utils.wav import wav_bytes

    laps = [("start", time.perf_counter())]  # where the step's own time goes
    caps = {"fm": write_receiver_capture("fm", tmp)[0], "fsk": cap}
    # the pipe's producer starts here: its start-up overlaps the other
    # captures and the runs below; it then waits on the full pipe
    producer = start_replay(caps["fm"])
    caps["ook"], caps["payload"] = write_receiver_capture("ook", tmp)
    caps.update({k: write_receiver_capture(k, tmp)[0] for k in ("am", "ssb")})
    pres = {k: prefix_of(caps[k], PREFIX_SAMPLES) for k in RX_ARGV}
    laps.append(("captures", time.perf_counter()))
    walls: dict[str, float] = {}
    before = all_launches()

    def both(name: str, extra=lambda tag: []) -> tuple[str, str]:
        with counting_dispatches() as dispatches:
            out, cpu_out = card_then_cpu(name, lambda path, tag: RX_ARGV[name] + extra(tag) + [path], caps[name],
                                         pres[name], card, walls, samples=samples_of(name))
        if dispatches["n"] < 2:
            raise AssertionError(f"{name}: {dispatches['n']} streaming dispatches")
        return out, cpu_out

    def audio_of(tag: str, rate: int = 48_000) -> np.ndarray:
        return np.fromfile(os.path.join(tmp, f"{tag}.sr{rate}.f32"), dtype="<f4")

    def audio_runs(name: str, rate: int = 48_000) -> np.ndarray:
        """The card's run over the capture and the prefix, the CPU's over the
        prefix; returns the card's audio of the whole capture."""
        both(name, lambda tag: ["-out", os.path.join(tmp, f"{name}{tag}")])
        card_run(f"{name}, the prefix", RX_ARGV[name] + ["-out", os.path.join(tmp, f"{name}pre"), pres[name]], card, {},
                 samples=PREFIX_SAMPLES)
        walls[f"{name} err"] = audio_against_cpu(name, audio_of(f"{name}pre", rate), audio_of(f"{name}cpu", rate))
        return audio_of(f"{name}gpu", rate)

    try:
        out, cpu_out = both("ook")
        bits, cpu_bits = out.splitlines()[0], cpu_out.splitlines()[0]
        print(f"  ook: payload {caps['payload']}; the card decoded {bits!r}, the CPU over the prefix {cpu_bits!r}")
        if caps["payload"] not in bits or bits != cpu_bits:
            raise AssertionError("ook: the payload did not come back")
        laps.append(("ook", time.perf_counter()))

        out, cpu_out = both("fsk")
        syms, cpu_syms = out.splitlines()[0], cpu_out.splitlines()[0]
        length = 1 + (CAPTURE_SAMPLES - 400) // 32
        if len(syms) != (length - 64) // 64 or set(syms) - {"0", "1"} or syms.count("1") < 0.99 * len(syms):
            raise AssertionError(f"fsk: {len(syms)} symbols, {syms.count('1')} ones (the tone lies in the lower half)")
        bad = [i for i in range(len(cpu_syms)) if syms[i] != cpu_syms[i]]
        if bad and not fsk_near_ties(bad, pres["fsk"], "cpu"):
            raise AssertionError("fsk symbols differ away from a near-tie")
        print(f"  fsk: {len(syms)} symbols; the prefix's {len(cpu_syms)} compared, {len(bad)} differ (near-ties)")
        laps.append(("fsk", time.perf_counter()))

        audio = audio_runs("fm")
        tone_check("fm", audio, 48_000)
        body = audio[away_from_window_ends(len(audio), 300_000)].astype(np.float64)
        rms = float(np.sqrt(np.mean(body**2))) * 75_000
        print(f"    fm: rms deviation {rms:.1f} Hz away from the window ends (a 75 kHz sine: {75_000 / np.sqrt(2):.1f}); "
              f"peak {np.abs(body).max() * 75_000:.1f} Hz there, {np.abs(audio).max() * 75_000:.1f} Hz over all")
        if abs(rms / (75_000 / np.sqrt(2)) - 1) > 0.03:
            raise AssertionError("fm: rms deviation off by more than 3%")
        laps.append(("fm", time.perf_counter()))
        card_run("fm -wav yes", RX_ARGV["fm"] + ["-wav", "yes", "-out", os.path.join(tmp, "fmwav"), caps["fm"]], card, walls,
                 samples=samples_of("fm"))
        with open(os.path.join(tmp, "fmwav.wav"), "rb") as f:
            wav = f.read()
        if wav[:56] != wav_bytes(48_000, audio)[:56] or np.abs(np.frombuffer(wav[56:], "<f4") - audio).max() > 1e-6:
            raise AssertionError("fm -wav yes: not the -out run's audio in a WAV")
        print(f"    fm -wav yes: {len(wav)} bytes, the -out run's {len(audio)} samples")
        with counting_dispatches() as dispatches:
            piped(RX_ARGV["fm"] + ["-stdin", "yes", "-sr", "2400000", "-format", "cu8", "-out", os.path.join(tmp, "fmpipe")],
                  caps["fm"], walls, "replay | fm -stdin", producer)
        if dispatches["n"] < 1:
            raise AssertionError("replay | fm -stdin took no streaming dispatch")
        if audio_of("fmpipe").tobytes() != audio.tobytes():
            raise AssertionError("replay | fm -stdin: audio differs from the file run's")
        print(f"    replay | fm -stdin yes: {walls['replay | fm -stdin']:.3f}s from the first byte, "
              f"{dispatches['n']} streaming dispatches; the audio equals the file run's, bit for bit")
        laps.append(("fm -wav, the pipe", time.perf_counter()))

        audio = audio_runs("am")
        tone_check("am", audio, 48_000)
        body = audio[away_from_window_ends(len(audio), 300_000)][100:-100]  # and the resampler's edges
        peak = float(np.abs(body).max())
        print(f"    am: peak modulation {peak:.4f} away from the window ends (depth 0.5); "
              f"{float(np.abs(audio).max()):.4f} over all")
        if abs(peak / 0.5 - 1) > 0.03:
            raise AssertionError("am: peak modulation off by more than 3%")
        laps.append(("am", time.perf_counter()))

        audio = audio_runs("ssb", 250_000)
        tone_check("ssb", audio, 250_000)
        laps.append(("ssb", time.perf_counter()))
    except BaseException:
        producer.kill()
        producer.wait()
        raise
    if all_launches() != before:
        raise AssertionError("the receivers launched a kernel of the port: they run as torch ops")
    print("  receivers, their steps: " + ", ".join(f"{name} {t - laps[i][1]:.1f}s" for i, (name, t) in enumerate(laps[1:])))
    return walls, caps


def phase_receiver_timing(card: str, caps: dict[str, str]) -> None:
    """Phase 5, one streaming dispatch of each receiver at its phase-4
    shape, split into staging (the page-locked slot filled from the
    capture file and its copy: host clock around a synchronize), decode +
    mix (the windows' view, mask and NCO), FIR (and SSB's re-shift) and
    post (the receiver's reduction), each with :func:`time_ms`; then the
    device's share of a profiled ``fm`` and ``fsk`` run."""
    from quadrs_tpu_torch.models import demod
    from quadrs_tpu_torch.sources import open_capture

    scale = float(np.float32(300_000 / (2.0 * np.pi)))

    def fm_post(x):  # FmDemod's discriminator
        d = x[:, 1:] * torch.conj(x[:, :-1])
        return torch.atan2(d.imag, d.real) * scale

    configs = {}  # name: (chain, c, lead, post, stride, chunk_post)
    for name, model, lead, post in (("fm", demod.FmDemod(center=-STATION), 1, fm_post),
                                    ("am", demod.AmDemod(center=-STATION), 0, torch.abs),
                                    ("ssb", demod.SsbDemod(), 0, torch.real)):
        chan = model.channel(open_capture(caps[name]))
        configs[name] = (chan, min(model.chunk, chan.length - lead), lead, post, None, None)
    configs["fsk"] = (demod.FskDemod(center=280_000).channel(open_capture(caps["fsk"])), 64, 0, fsk_halves, 64, None)
    th = float(np.float32(demod.OokDemod().threshold))
    configs["ook"] = (open_capture(caps["ook"]), 4, 0, None, 2, demod._envelope_chunk_post(4, 2, th))
    for name, (chan, c, lead, post, stride, chunk_post) in configs.items():
        step = demod._channel_step(chan, c, lead, post, device=DEVICE, stride=stride, chunk_post=chunk_post)
        walls = []
        for _ in range(7):  # the first two fill (and page-lock) both slots
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            slot, dev, _ = step.stage(0)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
            step._ring.recycle(slot)
        staging = sorted(walls[2:])[2]
        slot, dev, _ = step.stage(0)
        x = step.decode(dev)
        parts = {"decode": lambda: step.decode(dev)}
        if chunk_post is None:
            rows = step.mix(x, dev)
            y = step.filter(rows, dev)
            parts.update({"decode + mix": lambda: step.mix(step.decode(dev), dev), "FIR": lambda: step.filter(rows, dev),
                          "post": lambda: step.post(y)})
        else:
            parts["post (chunk envelope)"] = lambda: step.chunk_post(x[: (step.k - 1) * step.hop + step.n_in], step.k)
        parts["whole"] = lambda: step.compute(dev)
        ms = {k: time_ms(fn, iters=5) for k, fn in parts.items()}
        step._ring.recycle(slot)
        raw = step.k * step.hop
        print(f"  {name} dispatch: {step.k} windows of {step.n_in} raw samples ({step.span} staged); staging {staging:.3f} ms, "
              + ", ".join(f"{k} {v:.3f} ms" for k, v in ms.items())
              + f"; {raw / (staging + ms['whole']) / 1e3:.1f} Msps a dispatch, staging and device in turn ({card})")
    for name in ("fm", "fsk"):
        wall, busy = profiled(RX_ARGV[name] + [caps[name]])
        print(f"  {name}, a profiled card run: wall {wall:.3f}s, device busy {busy:.3f}s, "
              f"device share {100 * busy / wall:.1f}% ({card})")


def phase_find_timing(card: str) -> dict[str, float]:
    """Phase 5, ``find``'s device program (:class:`XCorr`) at ``l`` 1024 and
    4096 over the blocks of :data:`FIND_BLOCKS`, a dispatch of
    ``FIND_DISPATCH_BUDGET`` samples of windows, single template and 9-row
    grid: times of the forward FFT, the rows (product, inverse
    FFT, scores), the energy, the extraction and the whole program, each the
    device's own time (:func:`device_ms`); then the resampler's product at
    the write batch against per-window weights."""
    from quadrs_tpu_torch import sinks
    from quadrs_tpu_torch.ops.correlate import XCorr
    from quadrs_tpu_torch.ops.resample import phase_columns, resample_block, resample_tables

    rng = np.random.default_rng(SEED)
    g = torch.Generator(device=DEVICE).manual_seed(SEED)
    out: dict[str, float] = {}
    left = torch.tensor(float("-inf"), device=DEVICE)
    configs = []
    for l, blocks in FIND_BLOCKS.items():
        p = rng.standard_normal(l) + 1j * rng.standard_normal(l)
        for kind, freqs in (("single", None), ("grid 9", np.arange(-4, 5) * 0.4 / l)):
            for c in blocks:
                b = max(1, sinks.FIND_DISPATCH_BUDGET // c)
                x = torch.complex(torch.randn((b, c), generator=g, device=DEVICE),
                                  torch.randn((b, c), generator=g, device=DEVICE))
                xc = XCorr(p, c, freqs)
                xf, me = xc.forward(x), xc.energy(x)
                sc = xc.scores(xf, me)
                parts = {"forward FFT": lambda xc=xc, x=x: xc.forward(x), "rows": lambda xc=xc, xf=xf, me=me: xc.scores(xf, me),
                         "energy": lambda xc=xc, x=x: xc.energy(x),
                         "extraction": lambda xc=xc, sc=sc: xc.extract(*sc, left, 0.5, 1024),
                         "whole": lambda xc=xc, x=x: xc.extract(*xc.compute(x), left, 0.5, 1024)}
                configs.append((l, kind, c, b * (c - l + 1), parts, {k: [] for k in parts}))
    # the device's own time (graph replays): host timing swung 1.5x between
    # runs, two passes of graph replays agreed within 1%
    for l, kind, c, lags, parts, runs in configs:
        for k, fn in parts.items():
            runs[k].append(device_ms(fn, launches=5, replays=5))
    for l, kind, c, lags, parts, runs in configs:
        t = {k: sum(v) / len(v) for k, v in runs.items()}
        key = f"find l {l} {kind} c {c}"
        out[key] = t["whole"] / lags * 1e6  # ns a lag
        print(f"  {key}: {lags} lags; " + ", ".join(f"{k} {v:.3f} ms" for k, v in t.items())
              + f"; {out[key]:.3f} ns a lag, {lags / t['whole'] / 1e3:.0f} Mlags/s ({card})")
    for l, blocks in FIND_BLOCKS.items():
        for kind in ("single", "grid 9"):
            default = sinks.find_block(l, 1 << 40)
            best = min(blocks, key=lambda c: out[f"find l {l} {kind} c {c}"])
            gain = out[f"find l {l} {kind} c {default}"] / out[f"find l {l} {kind} c {best}"]
            print(f"  find l {l} {kind}: fastest block {best}; the default {default} takes {gain:.2f}x its time a lag "
                  f"(a CUDA default of its own would need 1.2x at l 1024 and 4096) ({card})")
    configs.clear()

    # the resampler at the write batch (256 pulls of 0x1000 outputs, 147/160)
    size, up, down = 2 * 8 * 160, 147, 160
    weights, _, m, _ = resample_tables(size, up, down)
    n_in = (-(-0x1000 // up) - 1) * down + m
    x = torch.complex(torch.randn((256, n_in), generator=g, device=DEVICE), torch.randn((256, n_in), generator=g, device=DEVICE))
    w_sel = torch.from_numpy((np.arange(256) * 0x1000) % up).to(DEVICE)
    w_dev = torch.as_tensor(weights, device=DEVICE)

    def per_window():
        # the JAX package's form: one (m, L) weight matrix gathered a window
        from quadrs_tpu_torch.ops.fir import overlapped_frames

        nb = -(-0x1000 // up)
        frames = overlapped_frames(x, down, m, nb)
        wsel = w_dev[w_sel]
        y = torch.complex(torch.einsum("bfm,bml->bfl", frames.real, wsel), torch.einsum("bfm,bml->bfl", frames.imag, wsel))
        return y.reshape(256, nb * up)[:, :0x1000]

    err = float((resample_block(x, w_sel, size, up, down, 0x1000) - per_window()).abs().max())
    t_cols, t_win = time_ms(lambda: resample_block(x, w_sel, size, up, down, 0x1000)), time_ms(per_window)
    out["resample_block ms"], out["per-window weights ms"] = t_cols, t_win
    print(f"  resample_block at the write batch (256 x {n_in} -> 0x1000, 147/160, {size} taps): {t_cols:.3f} ms "
          f"against {t_win:.3f} ms gathering a weight matrix a window ({256 * m * up * 4 / 2**20:.1f} MiB); "
          f"|diff| {err:.1e}; the columns table is {phase_columns(size, up, down).nbytes / 2**10:.0f} KiB ({card})")
    return out


# --------------------------------------------- psk, channelize and the renderers

PSK_RATE = 2_000_000  # the PSK captures: cs8 at 2 Msps, 2^24 samples (8.4 s of air)
PSK_SAMPLES = 1 << 24
PSK_CASES = {  # name: (order, symbols a second, carrier offset Hz, drift Hz over the burst)
    "bpsk": (2, 12_500, 3_100.0, 0.0),
    "qpsk": (4, 12_500, -2_300.0, 0.0),
    "drift": (2, 1_000, 1_200.0, 800.0),
}
PSK_T0 = 37.3  # where the first symbol ends, in raw samples: a timing offset
PSK_PHASE = 0.7  # the carrier's phase at sample 0 (rad)
PSK_BLOCK = 4096  # -block of the drifting burst: 65 symbols a block
CH_RATE = 21_000_000  # the channelizer's capture: cs8 at 21 Msps, 2^26 samples
CH_K, CH_POWER = 64, 512  # -channels 64 -power 512: 1024 taps, U = 16 branch steps
CH_CHUNK = 256_000  # the CLI's default -chunk 256k outputs a channel
CH_TONES = {5: (0.25, 50_000), 17: (0.2, -70_000), 40: (0.3, 20_000)}  # channel: (amplitude, offset from its centre Hz)
VIZ_MARGIN = 1e-5  # of the largest norm: a pixel whose colour flips within it is a boundary pixel


def psk_argv(name: str) -> list[str]:
    order, rate, _, drift = PSK_CASES[name]
    return ["psk", "-symbol-rate", str(rate), *(["-order", "4"] if order == 4 else []),
            *(["-block", str(PSK_BLOCK)] if drift else [])]


def write_psk_capture(name: str, tmp: str) -> tuple[str, str]:
    """One PSK burst of :data:`PSK_CASES` as a cs8 capture in ``tmp``, from
    ``default_rng([SEED, 10 + k])``: a differentially encoded random payload
    (symbol k holds phase ``2 pi a_k / order``, ``a_k = a_{k-1} + incr_k``,
    QPSK offset by pi/4), rectangular symbols from :data:`PSK_T0` on, a
    carrier offset, a phase and, for ``drift``, a linear drift of the carrier
    across the burst; noise of 0.01 a component.  Returns the path and the
    payload's bits (the increments, Gray-coded for QPSK)."""
    order, rate, f_off, drift = PSK_CASES[name]
    rng = np.random.default_rng([SEED, 10 + list(PSK_CASES).index(name)])
    sps = PSK_RATE / rate
    incr = rng.integers(0, order, int((PSK_SAMPLES - PSK_T0) / sps) + 2)
    a = np.cumsum(incr) % order
    offset = np.pi / 4 if order == 4 else 0.0
    slope = drift / (PSK_SAMPLES / PSK_RATE)  # Hz a second
    path = os.path.join(tmp, f"{name}.sr2M.cs8")

    def make(m):
        k = np.clip(np.floor((m - PSK_T0) / sps).astype(np.int64) + 1, 0, len(a) - 1)
        t = m / PSK_RATE
        cycles = np.mod(f_off * t + 0.5 * slope * t * t, 1.0)
        return 0.8 * np.exp(1j * (2 * np.pi * a[k] / order + offset + PSK_PHASE + 2 * np.pi * cycles))

    write_iq(path, PSK_SAMPLES, "cs8", make, rng)
    gray = {0: "00", 1: "01", 2: "11", 3: "10"}
    return path, "".join(str(v) if order == 2 else gray[int(v)] for v in incr)


def psk_line(out: str) -> tuple[str, dict[str, float]]:
    """A ``psk`` run's bits and its trailer's numbers."""
    lines = out.strip().splitlines()
    nums = dict(re.findall(r"(freq|phase|tau|sps) ([-+0-9.e]+)", lines[1]))
    return lines[0], {k: float(v) for k, v in nums.items()}


def psk_near_ties(name: str, pre: str) -> tuple[np.ndarray, int]:
    """The prefix's decisions (one a differential symbol) whose angle on the
    CPU lies within 1e-5 rad of a slicing boundary, and bits a decision."""
    from quadrs_tpu_torch.models.demod import PskDemod
    from quadrs_tpu_torch.sources import open_capture

    order, rate, _, drift = PSK_CASES[name]
    demod = PskDemod(symbol_rate=rate, order=order, block=PSK_BLOCK if drift else 0)
    _, sym = demod.symbols(open_capture(pre), device="cpu")
    d = sym[1:].astype(np.complex128) * np.conj(sym[:-1].astype(np.complex128))
    step = 2 * np.pi / order
    frac = np.angle(d) / step - 0.5
    return np.abs(frac - np.round(frac)) * step < 1e-5, 2 if order == 4 else 1


def read_png_checked(path: str, shape: tuple[int, int]) -> np.ndarray:
    from quadrs_tpu_torch.utils.png import read_png

    img = read_png(path)  # zlib and the CRCs, no Pillow
    if img.shape != (*shape, 3):
        raise AssertionError(f"{path}: {img.shape}, not {shape}")
    return img


def pixel_flips(what: str, got: np.ndarray, want: np.ndarray, near: np.ndarray) -> int:
    """Card against CPU image: equal but at boundary pixels; prints and
    returns the count that differ."""
    diff = (got != want).any(axis=-1)
    bad = int((diff & ~near).sum())
    print(f"    {what}: {int(diff.sum())} of {diff.size} pixels differ from the CPU's, each within "
          f"{VIZ_MARGIN}·max of a colour boundary (boundary pixels there: {int(near.sum())}); away from one: {bad}")
    if bad:
        raise AssertionError(f"{what}: {bad} pixels differ away from a colour boundary")
    return int(diff.sum())


def live_cell_flips(text: str, cpu_text: str, src, fw: int, stride: int, cols: int, cmap: str, windowing: str) -> int:
    """A live run's rows against the CPU's: lines equal but at cells whose
    pooled norm (the CPU's) is within ``VIZ_MARGIN`` of the row's max of a
    colour boundary; returns the differing cells."""
    from quadrs_tpu_torch.ops.stft import blackman_harris_window, stft_norms
    from quadrs_tpu_torch.viz import live

    cell = re.compile(r"\x1b\[48;2;(\d+);(\d+);(\d+)m ")
    lines, cpu_lines = text.splitlines(), cpu_text.splitlines()
    if len(lines) != len(cpu_lines):
        raise AssertionError(f"live: {len(lines)} lines on the card, {len(cpu_lines)} on the CPU")
    flips, r = 0, -1
    win = torch.from_numpy(blackman_harris_window(fw)) if windowing != "rectangular" else None
    for line, cpu_line in zip(lines, cpu_lines):
        cells = cell.findall(line)
        r += bool(cells)
        if line == cpu_line:
            continue
        if not cells:
            raise AssertionError(f"live: {line!r} != {cpu_line!r}")
        x, _ = src.read_at(r * stride, fw, "cpu")
        norms = stft_norms(torch.from_numpy(x)[None, :], window=win).numpy()
        pooled = live._pool_bins(norms, cols)[0]
        m = VIZ_MARGIN * float(norms.max())
        lo, hi = (cell.findall(live._row_line(pooled + d, cols, cmap)) for d in (-m, m))
        for i, (a, b) in enumerate(zip(cells, cell.findall(cpu_line))):
            if a != b and lo[i] == hi[i]:
                raise AssertionError(f"live row {r} cell {i}: {a} != {b} away from a colour boundary")
            flips += a != b
    return flips


def write_channel_capture(tmp: str) -> str:
    """The channelizer's capture: cs8 at 21 Msps, 2^26 samples, tones of
    :data:`CH_TONES` (each at its channel's centre plus an offset) and noise
    of 0.01 a component from ``default_rng([SEED, 20])``."""
    from quadrs_tpu_torch.serve import channel_center

    rng = np.random.default_rng([SEED, 20])
    path = os.path.join(tmp, "band.sr21M.cs8")

    def make(m):
        return sum(amp * np.exp(1j * angle_of(channel_center(ch, CH_RATE, CH_K) + off, CH_RATE, m))
                   for ch, (amp, off) in CH_TONES.items())

    write_iq(path, CAPTURE_SAMPLES, "cs8", make, rng)
    return path


def phase_psk_path(card: str, tmp: str, walls: dict[str, float]) -> dict[str, str]:
    """Phase 4, ``psk``: BPSK and QPSK at 12.5k symbols a second and a
    drifting BPSK burst at 1k (its carrier drifts 800 Hz: one whole-burst
    estimate leaves +/-400 Hz at the ends, past BPSK's 250 Hz budget; ``-block
    4096`` tracks it), each over 2^24 cs8 samples at 2 Msps: the payload must
    come back exactly (``-block 0`` must fail the drifting one), the
    estimates are printed against the planted values; each against the CPU
    over the 2^22-sample prefix (bits equal but at counted near-ties,
    estimates within their print resolution); ``-plot`` decoded with zlib.
    Returns the captures' paths."""
    caps = {}
    for name, (order, rate, f_off, drift) in PSK_CASES.items():
        t0 = time.perf_counter()
        cap, want = write_psk_capture(name, tmp)
        caps[name] = cap
        pre = prefix_of(cap, PREFIX_SAMPLES)
        print(f"  {name}: {PSK_SAMPLES} cs8 samples at {PSK_RATE} sps, {rate} symbols/s, order {order}, carrier "
              f"{f_off:+.1f} Hz{f', drifting {drift:.0f} Hz' if drift else ''}, timing offset {PSK_T0} samples; "
              f"written in {time.perf_counter() - t0:.1f}s")
        out = card_run(f"psk {name}", psk_argv(name) + [cap], card, walls, samples=PSK_SAMPLES)
        bits, est = psk_line(out)
        per = 2 if order == 4 else 1
        # a substring: the edges lose a few symbols (the first is the
        # differential reference, the filter settles over ~1.3 symbols)
        if bits not in want or len(bits) < len(want) - 8 * per:
            raise AssertionError(f"psk {name}: the payload did not come back ({len(bits)} of {len(want)} bits)")
        sps = PSK_RATE / 32 / rate
        print(f"    payload back: {len(bits)} of {len(want)} bits; freq {est['freq']:+.1f} Hz (planted {f_off:+.1f}"
              f"{f' plus {drift / 2:.0f} of drift on average' if drift else ''}), tau {est['tau']:.2f} of sps {sps:g} "
              f"(planted: symbol edges {PSK_T0} raw samples in, {PSK_T0 / 32:.2f} channel samples, to which tau adds "
              f"the filters' delays), phase {est['phase']:+.3f} rad (planted {PSK_PHASE:+.3f}, to which the estimate "
              f"adds the filter's phase and the order-fold ambiguity)")
        if drift:
            single = card_run("psk drift -block 0", psk_argv(name)[:-2] + [cap], card, walls, samples=PSK_SAMPLES)
            if psk_line(single)[0] in want:
                raise AssertionError("psk -block 0 decoded the drifting burst: the drift test is vacuous")
            print("    -block 0 fails the drifting burst, as it must")
        card_out, cpu_out = card_then_cpu(f"psk {name} prefix", lambda c, tag: psk_argv(name) + [c], pre, pre, card, {},
                                          samples=PREFIX_SAMPLES)
        (cb, ce), (pb, pe) = psk_line(card_out), psk_line(cpu_out)
        ties, per = psk_near_ties(name, pre)
        if len(cb) != len(pb):
            raise AssertionError(f"psk {name}: {len(cb)} bits on the card, {len(pb)} on the CPU")
        g = np.frombuffer(cb.encode(), np.uint8).reshape(-1, per)
        w = np.frombuffer(pb.encode(), np.uint8).reshape(-1, per)
        bad = np.flatnonzero((g != w).any(axis=1))
        print(f"    prefix, card against CPU: {len(bad)} of {len(g)} decisions differ (near-ties within 1e-5 rad on the "
              f"CPU: {int(ties.sum())}); freq {ce['freq']:+.1f} / {pe['freq']:+.1f} Hz, phase {ce['phase']:+.3f} / "
              f"{pe['phase']:+.3f}, tau {ce['tau']:.2f} / {pe['tau']:.2f}")
        if len(bad) and not ties[bad].all():
            raise AssertionError(f"psk {name}: decisions {bad[~ties[bad]][:5]} differ away from a near-tie")
        if abs(ce["freq"] - pe["freq"]) > 0.1 or abs(ce["phase"] - pe["phase"]) > 1e-3 or abs(ce["tau"] - pe["tau"]) > 1e-2:
            raise AssertionError(f"psk {name}: the card's estimates differ from the CPU's")
    # -plot: 256 x 256, markers at the order-th roots (the ideal ring sits at
    # 0.38 of the canvas from its centre whatever the symbols' magnitude)
    from quadrs_tpu_torch.viz.constellation import _MARK_RGB, SIZE

    for name in ("bpsk", "qpsk"):
        png = os.path.join(tmp, f"{name}.png")
        out = card_run(f"psk {name} -plot", psk_argv(name) + ["-plot", png, caps[name]], card, walls, samples=PSK_SAMPLES)
        if f"psk: constellation -> {png}" not in out:
            raise AssertionError("psk -plot did not say where it wrote")
        img = read_png_checked(png, (SIZE, SIZE))
        order = PSK_CASES[name][0]
        half, r = SIZE // 2, 0.38 * SIZE
        marks = [(int(round(half - r * np.sin(a))), int(round(half + r * np.cos(a)))) for a in 2 * np.pi * np.arange(order) / order]
        if any(tuple(img[y, x]) != _MARK_RGB for y, x in marks) or int((img[..., 2] > 0).sum()) < order:
            raise AssertionError(f"psk -plot: no marker at an order-th root, or no symbols: {marks}")
        print(f"    {png}: {SIZE}x{SIZE}, markers at {marks}, {int((img[..., 2] > 0).sum())} symbol pixels")
    return caps


def phase_channelize_path(card: str, tmp: str, walls: dict[str, float]) -> str:
    """Phase 4, ``channelize``: 64 channels of 1024 taps over the 2^26-sample
    cs8 capture at 21 Msps with the tones of :data:`CH_TONES`: each planted
    channel's RMS leads and every other channel is at least 30 dB under the
    weakest of them; ``-select`` of the three with ``-out``: each file's tone
    within one bin of its planted offset; the files against the CPU's over
    the prefix within ``2e-6`` of their scale; the defaults (8 channels, 40
    taps) once.  Returns the capture's path."""
    t0 = time.perf_counter()
    cap = write_channel_capture(tmp)
    pre = prefix_of(cap, PREFIX_SAMPLES)
    print(f"  channelize: wrote {CAPTURE_SAMPLES} cs8 samples at {CH_RATE} sps, tones in channels {sorted(CH_TONES)} "
          f"in {time.perf_counter() - t0:.1f}s")
    argv = ["channelize", "-channels", str(CH_K), "-power", str(CH_POWER)]
    out = card_run("channelize", argv + [cap], card, walls)
    rms = {int(m[0]): float(m[1]) for m in re.findall(r"channel (\d+): center -?\d+ Hz, rms ([0-9.e+-]+)", out)}
    weakest = min(rms[ch] for ch in CH_TONES)
    loudest_other = max(v for ch, v in rms.items() if ch not in CH_TONES)
    down = 20 * np.log10(weakest / loudest_other)
    print(f"    planted channels' rms {[rms[ch] for ch in sorted(CH_TONES)]}; the loudest other {loudest_other:.4g}, "
          f"{down:.1f} dB under the weakest planted one")
    if len(rms) != CH_K or down < 30:
        raise AssertionError(f"channelize: {len(rms)} channels, the others only {down:.1f} dB down")
    sel = ",".join(map(str, sorted(CH_TONES)))
    rate = CH_RATE // CH_K
    files = {}
    for where, c in (("gpu", cap), ("gpu-pre", pre), ("cpu-pre", pre)):
        prefix = os.path.join(tmp, f"ch-{where}")
        run = cpu_run if where == "cpu-pre" else (lambda n, a: card_run(n, a, card, walls, samples=CAPTURE_SAMPLES if where == "gpu" else PREFIX_SAMPLES))
        run(f"channelize -select {where}", argv + ["-select", sel, "-out", prefix, c])
        files[where] = {ch: np.fromfile(f"{prefix}.ch{ch}.sr{rate}.cf32", dtype="<c8") for ch in CH_TONES}
    for ch, (_, off) in CH_TONES.items():
        x = files["gpu"][ch].astype(np.complex128)
        spec = np.abs(np.fft.fft(x * np.hanning(len(x))))
        peak = int(np.argmax(spec))
        freq = (peak if peak < len(x) // 2 else peak - len(x)) * rate / len(x)
        print(f"    channel {ch}: {len(x)} samples, tone at {freq:+.2f} Hz (planted {off:+d}; bins of {rate / len(x):.4f} Hz)")
        if abs(freq - off) > rate / len(x):
            raise AssertionError(f"channel {ch}: tone at {freq} Hz, planted at {off}")
    scale = max(float(np.abs(v).max()) for v in files["cpu-pre"].values())
    err = max(float(np.abs(files["gpu-pre"][ch] - files["cpu-pre"][ch]).max()) for ch in CH_TONES)
    print(f"    prefix, card against CPU: max |diff| {err:.3g} of scale {scale:.4g} (bound 2e-6 of it)")
    if err > 2e-6 * scale or any(files["gpu-pre"][ch].shape != files["cpu-pre"][ch].shape for ch in CH_TONES):
        raise AssertionError("channelize: the card's channels differ from the CPU's")
    out = card_run("channelize defaults", ["channelize", cap], card, walls)
    if "channelize: 8 channels @ 2625000 Hz" not in out:
        raise AssertionError("channelize's defaults: not 8 channels")
    return cap


def phase_viz_path(card: str, cap: str, tmp: str, walls: dict[str, float]) -> None:
    """Phase 4, the renderers over the main capture: ``ui`` at the GUI's
    defaults and ``ui -frames 4`` (through ``from``), ``eui`` and ``eui
    -frames 3``, each image against the CPU's over the prefix (pixels equal
    but at counted boundary pixels); ``ui -live yes -rows 2000`` against the
    CPU's rows; ``replay -speed 0 | eui -live yes -stdin yes -rows 2000``
    against the file run's rows, line for line."""
    from quadrs_tpu_torch import sinks
    from quadrs_tpu_torch.sources import open_capture
    from quadrs_tpu_torch.viz import waterfall as twf

    pre = prefix_of(cap, PREFIX_SAMPLES)
    home = os.getcwd()
    os.chdir(tmp)  # the renderers write ui.png, eui.png ... here
    try:
        for where in ("gpu", "cpu"):
            os.makedirs(where, exist_ok=True)
        imgs = {}
        for name, argv, names in (("ui", lambda c: ["from", c, "ui"], ["ui.png"]),
                                  ("ui -frames 4", lambda c: ["from", c, "ui", "-frames", "4"], [f"ui{k:03d}.png" for k in range(4)]),
                                  ("eui", lambda c: ["eui", c], ["eui.png"]),
                                  ("eui -frames 3", lambda c: ["eui", "-frames", "3", c], [f"eui{k:03d}.png" for k in range(3)])):
            card_run(name, argv(cap), card, walls)
            for where, run in (("gpu", lambda a: card_run(f"{name} prefix", a, card, {}, samples=PREFIX_SAMPLES)),
                               ("cpu", lambda a: cpu_run(f"{name} prefix", a))):
                out = run(argv(pre))
                if [ln for ln in out.splitlines() if ln.startswith("wrote")] != [f"wrote {n}" for n in names]:
                    raise AssertionError(f"{name}: wrote {out}")
                for n in names:
                    os.replace(n, os.path.join(where, n))
            imgs[name] = names
        src = open_capture(pre)
        flipped = 0
        for k in range(5):  # ui.png, then the sweep's ui000.png (fft 8) to ui003.png (fft 64)
            name = "ui.png" if k == 0 else f"ui{k - 1:03d}.png"
            p = twf.UiParams(fft_width=8 << max(k - 1, 0), stride=4)
            norms = twf.ui_norms(src, p, device="cpu")
            m = VIZ_MARGIN * float(norms.max())
            near = (twf.ui_paint(norms - m, p)[0] != twf.ui_paint(norms + m, p)[0]).any(axis=-1)
            got, want = (read_png_checked(os.path.join(w, name), (600, 800)) for w in ("gpu", "cpu"))
            flipped += pixel_flips(f"ui {name}", got, want, near)
        span = 46.3 - 46.0
        for k in range(4):  # eui.png, then the scroll's eui000.png to eui002.png (eui_render_frames' slices)
            name = "eui.png" if k == 0 else f"eui{k - 1:03d}.png"
            start = 46.0 + max(k - 1, 0) * span
            p = twf.EuiParams(start, start + span) if k else twf.EuiParams()
            norms = sinks.take_fft(src, twf.eui_slice(src.length, p), 512, 2048, device="cpu").norms
            m = VIZ_MARGIN * float(norms.max())
            near = twf.blue_map(norms - m) != twf.blue_map(norms + m)
            got, want = (read_png_checked(os.path.join(w, name), (2048, 512)) for w in ("gpu", "cpu"))
            flipped += pixel_flips(f"eui {name}", got, want, near)
        print(f"    the renderers: {flipped} pixels differ from the CPU's over 9 images, all at colour boundaries")
        live = ["ui", "-live", "yes", "-rows", "2000", "-cols", "100"]
        text = card_run("ui -live", ["from", cap, *live], card, walls)
        card_pre = card_run("ui -live prefix", ["from", pre, *live], card, {}, samples=PREFIX_SAMPLES)
        cells = live_cell_flips(card_pre, cpu_run("ui -live prefix", ["from", pre, *live]), src, 8, 4, 100, "hsv", "rectangular")
        if text != card_pre or text.count("\n") != 2002:
            raise AssertionError("ui -live: the capture's first 2000 rows differ from its prefix's")
        print(f"    ui -live: 2000 rows; card against CPU: {cells} cells differ, all at colour boundaries")
    finally:
        os.chdir(home)  # replay runs from the checkout's root
    elive = ["eui", "-live", "yes", "-rows", "2000", "-cols", "100"]
    file_rows = card_run("eui -live", [*elive, cap], card, walls)
    pipe_rows = piped([*elive, "-stdin", "yes", "-sr", "21M", "-format", "cs8"], cap)
    if pipe_rows != file_rows or "live: 2000 rows, fft 512, stride 512" not in file_rows:
        raise AssertionError("eui -live -stdin: the pipe's rows differ from the file's")
    print("    replay | eui -live -stdin: 2000 rows, equal to the file run's line for line")


def phase_channelize_timing(card: str, cap: str, tmp: str) -> None:
    """Phase 5, one channelizer dispatch at phase 4's shape (4 windows of
    256,000 outputs x 64 channels, 1024 taps), split into staging (the
    capture's span into page-locked memory: host clock), the copy, decode +
    mask, the branch FIR, the DFT over K, the centre phase, the way back
    (channels first, into page-locked memory) and the file writes (host
    clock), each stage with :func:`time_ms`; with its bound."""
    from quadrs_tpu_torch.models.channelizer import Channelize, channels_first
    from quadrs_tpu_torch.ops import channelizer as chops
    from quadrs_tpu_torch.runtime import _to_device, root_step_of, window_batches
    from quadrs_tpu_torch.sources import open_capture
    from quadrs_tpu_torch.staging import Download

    src = open_capture(cap)
    chan = Channelize(src, CH_K, size=2 * CH_POWER)
    batch, _ = window_batches(np.arange(0, chan.length, CH_CHUNK), CH_CHUNK, root_step=root_step_of(chan))
    offs = np.arange(batch, dtype=np.int64) * CH_CHUNK
    lo, _ = chan.span(0, CH_CHUNK)
    s_off, s_n = chan.span(int(offs[-1]), CH_CHUNK)
    hi = min(s_off + s_n, src.length)
    host = torch.empty((2, hi - lo), dtype=torch.int8, pin_memory=DEVICE.type == "cuda")
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        src.stage(lo, hi, out=host.numpy())
        walls.append((time.perf_counter() - t0) * 1e3)
    staging = sorted(walls)[2]
    buf = host.to(DEVICE)
    prep = _to_device(chan.plan(offs, CH_CHUNK, lo).prep, DEVICE)
    ctx = {"buf": buf, "device": DEVICE}
    n_in = CH_CHUNK * CH_K + chan.size
    keep = torch.arange(n_in, device=DEVICE)[None, :] < prep["valid_in"][:, None]

    def decode():
        return torch.where(keep, chan.inner.read_batch(ctx, prep["inner"], n_in), 0)

    x = decode()
    b = chops.branch_sums(x, chan.taps, CH_K, CH_CHUNK)
    y = torch.fft.fft(b, dim=-1)
    pr, pi = chops._center_phase(chan.size, CH_K)
    phase = torch.complex(torch.from_numpy(pr), torch.from_numpy(pi)).to(DEVICE)
    out = y * phase
    torch.testing.assert_close(out, chops.channelize_block(x, chan.taps, CH_K, CH_CHUNK), rtol=0, atol=0)
    ms = {
        "copy": time_ms(lambda: host.to(DEVICE, non_blocking=True), iters=5),
        "decode + mask": time_ms(decode, iters=5),
        "branch FIR": time_ms(lambda: chops.branch_sums(x, chan.taps, CH_K, CH_CHUNK), iters=5),
        "DFT": time_ms(lambda: torch.fft.fft(b, dim=-1), iters=5),
        "phase": time_ms(lambda: y * phase, iters=5),
        "back": time_ms(lambda: Download(channels_first(out)).wait(), iters=5),
    }
    rows = Download(channels_first(out)).wait()
    walls = []
    for k in range(3):
        t0 = time.perf_counter()
        for ch in range(CH_K):
            with open(os.path.join(tmp, f"timing.ch{ch}.cf32"), "wb") as fh:
                for row in rows:
                    fh.write(row[ch].tobytes())
        walls.append((time.perf_counter() - t0) * 1e3)
    writes = sorted(walls)[1]
    u = -(-chan.size // CH_K)
    outs = batch * CH_CHUNK  # output rows (each K channels)
    nbytes = 2 * (hi - lo) + outs * CH_K * 8
    flops = outs * (4 * u * CH_K + 5 * CH_K * np.log2(CH_K) + 6 * CH_K)
    b_ms, b_by = bound(nbytes, flops)
    device = sum(v for k, v in ms.items() if k not in ("copy", "back"))
    loop = u * 3 * outs * CH_K * 8  # the U-step loop reads its slice and reads and writes the sum, each step
    print(f"  channelize dispatch: {batch} windows of {CH_CHUNK} outputs x {CH_K} channels ({hi - lo} cs8 samples in); staging "
          f"{staging:.3f} ms (host), " + ", ".join(f"{k} {v:.3f} ms" for k, v in ms.items())
          + f", file writes {writes:.3f} ms (host; {outs * CH_K * 8 / 1e6:.0f} MB); device (decode to phase) {device:.3f} ms, "
          f"bound {b_ms:.4f} ms ({b_by}: {nbytes / 1e6:.0f} MB in and out once, {flops / 1e9:.2f} GFLOP), "
          f"{100 * b_ms / device:.1f}% of it; the branch loop moves {loop / 1e9:.2f} GB ({card})")


def phase_psk_timing(card: str, caps: dict[str, str]) -> None:
    """Phase 5, PSK at the BPSK burst of phase 4: the peak program, the host
    tables, the process program and ``z``'s way back (CUDA events, the
    tables on the host clock), one ``-block`` peak at its shape; then the
    device's share of a profiled ``psk`` and ``channelize`` run."""
    from quadrs_tpu_torch.models import demod
    from quadrs_tpu_torch.sources import open_capture

    order, rate, _, _ = PSK_CASES["bpsk"]
    psk = demod.PskDemod(symbol_rate=rate, order=order)
    ch_rate, x = psk.baseband(open_capture(caps["bpsk"]), device=DEVICE)
    n = len(x)
    planes, npad = demod._padded_planes(x)
    dplanes = torch.from_numpy(planes).to(DEVICE)
    sps = ch_rate / rate
    peak = time_ms(lambda: demod.psk_peak(dplanes, n, order).cpu(), iters=5)
    khat = psk._peak_khat(planes, n, npad, DEVICE)
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        rot, tim = demod.psk_tables(khat, npad, order, sps)
        walls.append((time.perf_counter() - t0) * 1e3)
    rot_d, tim_d = torch.from_numpy(rot).to(DEVICE), torch.from_numpy(tim).to(DEVICE)
    process = time_ms(lambda: demod.psk_process(dplanes, rot_d, tim_d, n, order, int(round(sps))), iters=5)
    z, _ = demod.psk_process(dplanes, rot_d, tim_d, n, order, int(round(sps)))
    back = time_ms(lambda: z.cpu(), iters=5)
    bplanes, bpad = demod._padded_planes(x[:PSK_BLOCK])
    bdev = torch.from_numpy(bplanes).to(DEVICE)
    block = time_ms(lambda: demod.psk_peak(bdev, PSK_BLOCK, order).cpu(), iters=5)
    print(f"  psk, the BPSK burst ({n} baseband samples, npad {npad}): peak program and fetch {peak:.3f} ms, host tables "
          f"{sorted(walls)[2]:.3f} ms, process program {process:.3f} ms, z back {back:.3f} ms; one -block peak "
          f"(npad {bpad}) {block:.3f} ms ({card})")
    for name, argv in (("psk", psk_argv("bpsk") + [caps["bpsk"]]),
                       ("channelize", ["channelize", "-channels", str(CH_K), "-power", str(CH_POWER), caps["band"]])):
        wall, busy = profiled(argv)
        print(f"  {name}, a profiled card run: wall {wall:.3f}s, device busy {busy:.3f}s, "
              f"device share {100 * busy / wall:.1f}% ({card})")


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


def check_waterfall(label, spec, planes, nw, stride, tables, failures, thr=None, tally=None) -> dict[str, tuple[float, float]]:
    """The three waterfall kernels against their plain versions on one
    input, at the JAX package's waterfall tolerances: norms
    ``rtol=2e-5, atol=2e-5·max``; peak bins exact except near-ties,
    magnitudes ``rtol=2e-5``; scan sums ``nw·2e-5·max``, maxima
    ``2e-5·max``, counts exact except for norms within ``2e-5·max`` of
    the threshold (by default the median norm).  Returns each kernel's
    (absolute error, that over the max norm; for scan the larger of the
    sum error per window and the max error).  ``tally`` gathers, over the
    calls that share it, how many peak bins and how many per-bin threshold
    counts differ from the plain version's, and how many were compared
    (each difference has passed the near-tie or noise-band test above)."""
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
    if tally is not None and not bad:
        for key, n in (("peak bins differ", int((~exact).sum())), ("peak bins", exact.numel()),
                       ("threshold counts differ", int((cnt != (want > thr).sum(1)).sum())), ("threshold counts", cnt.numel())):
            tally[key] = tally.get(key, 0) + n
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
        launches[name] = launches.get(name, 0) + got[name]
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
        # scan -plot: a survey PNG a stream, its strip the occupancy of the CSV
        # beside it (its launches count into the kernels line with the run above)
        from quadrs_tpu_torch.utils.png import read_png

        t0 = time.perf_counter()
        counted("waterfall_scan", chunks_over,
                ["scan", "-width", str(width), "-stride", "256", "-chunk", str(BANK_CHUNK), "-threshold", repr(thr),
                 "-top", "3", "-plot", "yes", "-out", prefix + "p", *files])
        plot_s = time.perf_counter() - t0
        for s in range(BANK_STREAMS):
            img = read_png(f"{prefix}p.s{s}.png")
            above = np.loadtxt(f"{prefix}p.s{s}.scan.csv", delimiter=",", skiprows=1)[:, 4]
            strip = np.clip(above / over * 256.0, 0, 255).astype(np.uint8)
            if img.shape != (225, width, 3) or not (img[201:, :, 2] == strip[None, :]).all():
                raise AssertionError(f"scan -plot: {prefix}p.s{s}.png is not stream {s}'s survey")
        print(f"  scan -plot: {BANK_STREAMS} survey PNGs of 225 x {width}, each strip the occupancy of its CSV; "
              f"{plot_s:.2f}s ({card})")

        # every kernel against its plain version on the runner's staged
        # chunks at both strides, the ragged last chunks included; then the
        # CLI's -search peaks and scan stats against the plain version's
        # norms at stride 256 (these launches are not the main path's)
        tables = wf.waterfall_tables(spec, device=DEVICE)
        failures: list[str] = []
        at_main: dict[str, tuple[float, float]] = {}
        tally: dict[str, int] = {}
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
                fold(at_main, check_waterfall(label, spec, planes, n_w, stride, tables, failures, thr=thr, tally=tally))
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
        # the epilogues take sqrt.approx: what it flips against the plain version's IEEE sqrt
        print(f"  kernels vs plain over the staged chunks of both strides: {tally['peak bins differ']} of {tally['peak bins']} "
              f"search peak bins differ (each a near-tie within {WF_RTOL}), {tally['threshold counts differ']} of "
              f"{tally['threshold counts']} scan threshold counts differ (each by norms within {WF_RTOL}·max of the threshold)")
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


DAEMON_STALL = 5.0  # -timeout of the parallel round (s)


class _Tee(io.TextIOBase):
    """Standard output that also keeps what was written (the daemon's log)."""

    def __init__(self, out):
        self.out, self.buf = out, io.StringIO()

    def write(self, s: str) -> int:
        self.buf.write(s)
        return self.out.write(s)

    def flush(self) -> None:
        self.out.flush()


def serve_client(port: int, payload, pieces: int = 1) -> tuple[bytes, float]:
    """One client of the daemon: send ``payload`` (in ``pieces`` pieces 50 ms
    apart), half-close, read to EOF while sending; returns the reply and
    the wall from connect to the last byte."""
    import socket
    import threading

    out: list[bytes] = []
    view = memoryview(payload)
    t0 = time.perf_counter()
    with socket.create_connection(("127.0.0.1", port), timeout=60) as s:
        reader = threading.Thread(target=lambda: out.extend(iter(lambda: s.recv(1 << 20), b"")))
        reader.start()
        step = -(-len(view) // pieces)
        for off in range(0, len(view), step):
            s.sendall(view[off : off + step])
            if pieces > 1:
                time.sleep(0.05)
        s.shutdown(socket.SHUT_WR)
        reader.join(timeout=300)
        if reader.is_alive():
            raise AssertionError("the daemon never closed the connection")
    return b"".join(out), time.perf_counter() - t0


def start_daemon(argv: list[str], max_connections: int, mesh: tuple[int, int] | None = None):
    """``serve ARGV -port 0`` on a thread, on the card, its ``-mesh`` set to
    ``mesh`` after parsing (the parser takes no ``-mesh`` for a receiver's
    mode; ``run_serve`` does); returns (thread, port, errors)."""
    import dataclasses
    import threading

    from quadrs_tpu_torch import args as targs
    from quadrs_tpu_torch.serve import run_serve

    (cmd,) = targs.parse(["serve", "-port", "0", *argv])
    if mesh is not None:
        cmd = dataclasses.replace(cmd, mesh=mesh)
    box, errors, up = [], [], threading.Event()

    def run():
        try:
            run_serve(cmd, DEVICE, ready=lambda p: (box.append(p), up.set()), max_connections=max_connections)
        except BaseException as e:  # raised again by the step
            errors.append(e)
            up.set()

    th = threading.Thread(target=run, daemon=True)
    th.start()
    if not up.wait(600) or errors:
        raise AssertionError(f"serve {' '.join(argv)} did not come up: {errors}")
    return th, box[0], errors


def end_daemon(th, errors) -> None:
    th.join(timeout=120)
    if th.is_alive() or errors:
        raise AssertionError(f"the daemon did not end cleanly: {errors}")


def phase_daemon(card: str, cap: str, tmp: str, caps: dict[str, str], find_stdin: str) -> dict[str, int]:
    """Phase 4, the daemon: ``serve`` (``quadrs_tpu_torch.serve.run_serve``)
    on a thread of this process, on the card, its clients on loopback
    reading while they send.  ``-mode stream`` at the bench config over the
    2^26-sample capture (the norms bit-equal to StreamRunner over the file,
    a profiled session's device share; ``-search`` the lines of ``stream
    -search``); ``-mode waterfall`` (``-search`` at stride 256) and ``scan
    -stride 256`` over one capture of the bank, each the command's output
    over the file; ``-mode find`` with the bank of three templates over the
    9-row grid, the lines of ``replay | find -stdin`` (``find_stdin``); each
    receiver over its phase-4 capture, the command's stdout or its ``-out``
    audio, byte for byte; ``-parallel 4 -timeout 5``: eight ``-search``
    sessions over slices of the capture, half trickling, each reply the
    sequential daemon's, and a stalled client dropped while they run; one
    ``python -m quadrs_tpu_torch serve -once yes`` in a process of its own.
    Each session runs with the counts at 0 and must launch its kernel once
    a chunk (and no other).  Returns the sessions' launches by kernel."""
    import socket
    import threading

    from quadrs_tpu_torch.formats import FileFormat
    from quadrs_tpu_torch.models.receiver import PipelineModel
    from quadrs_tpu_torch.ops import frontend as fe
    from quadrs_tpu_torch.ops import waterfall as wf
    from quadrs_tpu_torch.sources import open_capture
    from quadrs_tpu_torch.stream_runner import StreamRunner

    os.environ.pop("QUADRS_PLATFORM", None)  # the CLI's default device: cuda
    laps = [("start", time.perf_counter())]
    # frontend_banded is not set to 0 here: its count runs over all of phase 4
    kernels = {k.__name__: k for k in (fe.frontend_fir, fe.frontend_fir_stft, wf.waterfall_norms, wf.waterfall_search,
                                       wf.waterfall_scan)}
    total = dict.fromkeys(kernels, 0)
    cfg = bench_cfg(FileFormat.COMPLEX_INT8)
    bench = ["-shift", "280k", "-lowpass", "200k", "-power", "200", "-decimate", "32", "-width", "64",
             "-chunk", str(CHUNK), "-sr", str(SAMPLE_RATE), "-format", "cs8"]
    tee = _Tee(sys.stdout)

    def session(name: str, port: int, payload, want: dict[str, int], samples: int) -> bytes:
        """One session with every count at 0 before it; the counts after it must be ``want``."""
        for k in kernels.values():
            k.launches = 0
        banded = fe.frontend_banded.launches
        reply, wall = serve_client(port, payload)
        got = {n: k.launches for n, k in kernels.items() if k.launches}
        if fe.frontend_banded.launches != banded:
            got["frontend_banded"] = fe.frontend_banded.launches - banded
        print(f"    session {name}: {wall:.3f}s, {samples / wall / 1e6:.1f} Msps, {len(reply)} bytes back; "
              f"launches {got or 'none'} ({card})")
        if got != want:
            raise AssertionError(f"session {name} launched {got}, expected {want}")
        for n, v in got.items():
            total[n] += v
        return reply

    def lines(reply: bytes, trailer: str) -> list[str]:
        """The reply's lines but its last, which must start with ``trailer``."""
        text = reply.decode().strip().splitlines()
        if not text or not text[-1].startswith(trailer):
            raise AssertionError(f"reply ends {text[-1:]!r}, not {trailer!r}")
        return text[:-1]

    stdout, sys.stdout = sys.stdout, tee
    try:
        with open(cap, "rb") as f:
            data = f.read()
        chunks = n_chunks(CAPTURE_SAMPLES, cfg)
        # -mode stream: the norms against StreamRunner over the file, then a profiled session
        th, port, errors = start_daemon(bench, 2)
        rows = []
        StreamRunner(open_capture(cap), PipelineModel(cfg), DEVICE, chunk_samples=CHUNK).run(lambda w0, n: rows.append(n))
        want = np.concatenate(rows).tobytes()
        reply = session("stream (norms)", port, data, {"frontend_fir": chunks}, CAPTURE_SAMPLES)
        if reply != want:
            raise AssertionError("serve -mode stream: the norms differ from StreamRunner's over the file")
        print(f"  serve -mode stream: {len(want) // 256} norms rows, bit-equal to StreamRunner over the file")
        from torch.profiler import ProfilerActivity, profile

        from profile_stream import device_busy

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            if session("stream (norms, profiled)", port, data, {"frontend_fir": chunks}, CAPTURE_SAMPLES) != want:
                raise AssertionError("serve -mode stream: the profiled session's norms differ")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        busy = device_busy(prof)[0] / 1e3
        end_daemon(th, errors)
        print(f"  serve -mode stream, a profiled session: wall {wall:.3f}s, device busy {busy:.3f}s, "
              f"device share {100 * busy / wall:.1f}% ({card})")
        laps.append(("stream", time.perf_counter()))

        # -mode stream -search: the whole capture against the command, then the sequential eight
        # the parallel round's eight payloads: halves of the capture, 1/16 of it apart
        n_slice = CAPTURE_SAMPLES // 2
        slices = [memoryview(data)[2 * i * (CAPTURE_SAMPLES // 16) :][: 2 * n_slice] for i in range(8)]
        per = n_chunks(n_slice, cfg)
        th, port, errors = start_daemon([*bench, "-search", "yes"], 9)
        out = os.path.join(tmp, "dsearch")
        run_cli(["stream", "-shift", "280k", "-chunk", str(CHUNK), "-search", "yes", "-out", out, cap])
        with open(f"{out}.peaks.csv") as f:
            want_lines = f.read().strip().splitlines()
        got = lines(session("stream -search", port, data, {"frontend_fir": chunks}, CAPTURE_SAMPLES), "# stream: ")
        if got != want_lines:
            raise AssertionError("serve -mode stream -search: lines differ from stream -search's")
        print(f"  serve -mode stream -search: {len(got) - 1} lines, those of stream -search -out")
        t0 = time.perf_counter()
        sequential = [session(f"sequential {i}", port, s, {"frontend_fir": per}, n_slice) for i, s in enumerate(slices)]
        seq_wall = time.perf_counter() - t0
        end_daemon(th, errors)
        laps.append(("stream -search", time.perf_counter()))

        # -parallel 4 -timeout 5: the eight at once, half trickling, and a stalled client
        th, port, errors = start_daemon([*bench, "-search", "yes", "-parallel", "4", "-timeout", str(DAEMON_STALL)], 9)
        for k in kernels.values():
            k.launches = 0
        banded = fe.frontend_banded.launches
        replies: list = [None] * 8
        walls: list = [None] * 8
        log0 = len(tee.buf.getvalue())

        def client(i: int) -> None:
            replies[i], walls[i] = serve_client(port, slices[i], 6 if i % 2 else 1)

        t0 = time.perf_counter()
        clients = [threading.Thread(target=client, args=(i,)) for i in range(8)]
        for c in clients:
            c.start()
        stalled = socket.create_connection(("127.0.0.1", port), timeout=60)
        for c in clients:
            c.join(timeout=300)
        par_wall = time.perf_counter() - t0
        try:
            # the daemon writes the CSV header, then waits for bytes that never come, then drops the client
            stalled.settimeout(60)
            try:
                dropped = b"".join(iter(lambda: stalled.recv(1024), b""))
            except OSError:
                dropped = b""
            held = time.perf_counter() - t0
        finally:
            stalled.close()
        end_daemon(th, errors)
        log = tee.buf.getvalue()[log0:]
        got = {n: k.launches for n, k in kernels.items() if k.launches}
        if fe.frontend_banded.launches != banded:
            got["frontend_banded"] = fe.frontend_banded.launches - banded
        if any(c.is_alive() for c in clients) or None in replies:
            raise AssertionError("a -parallel session did not finish")
        for i in range(8):
            print(f"    parallel session {i}{' (trickling)' if i % 2 else ''}: {walls[i]:.3f}s, "
                  f"{n_slice / walls[i] / 1e6:.1f} Msps ({card})")
            a, b = replies[i].decode().strip().splitlines(), sequential[i].decode().strip().splitlines()
            if a[:-1] != b[:-1] or a[-1].split(", ")[:2] != b[-1].split(", ")[:2]:
                raise AssertionError(f"parallel session {i} differs from its sequential reply")
        if got != {"frontend_fir": 8 * per}:
            raise AssertionError(f"the parallel sessions launched {got}, expected {8 * per} frontend_fir")
        total["frontend_fir"] += got["frontend_fir"]
        if dropped not in (b"", b"window,bin,mag\n") or log.count(" done: ") != 8 or log.count("failed: TimeoutError") != 1:
            raise AssertionError(f"-timeout: the stalled client was not dropped alone: {dropped!r} {log}")
        print(f"  serve -parallel 4: the eight replies equal the sequential ones byte for byte (but for the trailer's "
              f"time); the stalled client dropped after {held:.2f}s, logged, while the others finished in {par_wall:.3f}s")
        print(f"  serve -parallel 4, eight sessions of {n_slice} samples, half trickling: "
              f"{8 * n_slice / par_wall / 1e6:.1f} Msps aggregate ({par_wall:.3f}s), against "
              f"{8 * n_slice / seq_wall / 1e6:.1f} Msps one after another ({seq_wall:.3f}s) ({card})")
        # the same eight sent at once, none trickling: what -parallel 4 gains where no client holds it back
        th, port, errors = start_daemon([*bench, "-search", "yes", "-parallel", "4"], 8)
        for k in kernels.values():
            k.launches = 0
        t0 = time.perf_counter()
        clients = [threading.Thread(target=lambda i=i: replies.__setitem__(i, serve_client(port, slices[i])[0]))
                   for i in range(8)]
        for c in clients:
            c.start()
        for c in clients:
            c.join(timeout=300)
        burst_wall = time.perf_counter() - t0
        end_daemon(th, errors)
        got = {n: k.launches for n, k in kernels.items() if k.launches}
        for i in range(8):
            a, b = replies[i].decode().strip().splitlines(), sequential[i].decode().strip().splitlines()
            if a[:-1] != b[:-1]:
                raise AssertionError(f"parallel session {i} (sent at once) differs from its sequential reply")
        if got != {"frontend_fir": 8 * per}:
            raise AssertionError(f"the parallel sessions sent at once launched {got}, expected {8 * per} frontend_fir")
        total["frontend_fir"] += got["frontend_fir"]
        print(f"  serve -parallel 4, the eight sent at once: {8 * n_slice / burst_wall / 1e6:.1f} Msps aggregate "
              f"({burst_wall:.3f}s, {seq_wall / burst_wall:.2f}x the sequential eight), the replies the sequential "
              f"ones ({card})")
        laps.append(("-parallel 4", time.perf_counter()))

        # -mode waterfall and scan over one capture of the bank, against the commands over the file
        (bank,) = write_bank(tmp, 1, BANK_SAMPLES)
        with open(bank, "rb") as f:
            bank_data = f.read()
        out = os.path.join(tmp, "dbank")
        tiled, over = -(-((BANK_SAMPLES - 1024) // 1024 + 1) // BANK_CHUNK), -(-((BANK_SAMPLES - 1024) // 256 + 1) // BANK_CHUNK)
        wfall = ["-width", "1024", "-chunk", str(BANK_CHUNK)]
        srate = ["-sr", str(SAMPLE_RATE), "-format", "cs8"]
        scan_args = ["-width", "1024", "-stride", "256", "-chunk", str(BANK_CHUNK), "-threshold", "20"]
        run_cli(["waterfall", *wfall, "-out", out, bank])
        run_cli(["waterfall", *wfall, "-stride", "256", "-search", "yes", "-out", out, bank])
        run_cli(["scan", *scan_args, "-top", "3", "-overwrite", "yes", "-out", out, bank])
        for what, argv, kernel, n, trailer in (
                ("waterfall", ["-mode", "waterfall", *wfall], "waterfall_norms", tiled, None),
                ("waterfall -search", ["-mode", "waterfall", *wfall, "-stride", "256", "-search", "yes"], "waterfall_search",
                 over, "# waterfall: "),
                ("scan", ["-mode", "scan", *scan_args], "waterfall_scan", over, "# scan: ")):
            th, port, errors = start_daemon([*argv, *srate], 1)
            reply = session(what, port, bank_data, {kernel: n}, BANK_SAMPLES)
            end_daemon(th, errors)
            if trailer is None:
                with open(f"{out}.s0.norms.f32", "rb") as f:
                    same = reply == f.read()
            elif kernel == "waterfall_search":
                with open(f"{out}.peaks.csv") as f:
                    csv = f.read().strip().splitlines()
                same = lines(reply, trailer) == ["window,bin,mag"] + [ln.split(",", 1)[1] for ln in csv[1:]]
            else:
                with open(f"{out}.s0.scan.csv") as f:
                    same = lines(reply, trailer) == f.read().strip().splitlines()
            print(f"  serve -mode {what}: {len(reply)} bytes, equal to the command's output over the file: {same}")
            if not same:
                raise AssertionError(f"serve -mode {what} differs from the command over the file")
        laps.append(("bank", time.perf_counter()))

        # -mode find: the bank of three over the 9-row grid, the lines of replay | find -stdin
        names = [os.path.join(tmp, f"b{k}.sr21M.cs8") for k in range(len(FIND_BANK))]
        th, port, errors = start_daemon(["-mode", "find", *[a for b in names for a in ("-pattern", b)], "-freq-tol", FIND_TOL,
                                   *srate], 1)
        with open(os.path.join(tmp, "find.sr21M.cs8"), "rb") as f:
            reply = session("find (bank)", port, f.read(), {}, CAPTURE_SAMPLES)
        end_daemon(th, errors)
        want_lines = find_stdin.strip().splitlines()
        got = reply.decode().strip().splitlines()
        if got != [*want_lines[:-1], f"# {want_lines[-1]}"]:
            raise AssertionError(f"serve -mode find: {got[-3:]} against find -stdin's {want_lines[-3:]}")
        print(f"  serve -mode find: {len(got) - 1} matches, the lines of replay | find -stdin")
        laps.append(("find", time.perf_counter()))

        # the receivers: each against its command on the card over the same capture
        rx = {"ook": (caps["ook"], RX_ARGV["ook"], "1M"), "fsk": (cap, RX_ARGV["fsk"], str(SAMPLE_RATE)),
              "psk": (caps["bpsk"], psk_argv("bpsk"), str(PSK_RATE)), "fm": (caps["fm"], RX_ARGV["fm"], "2400k"),
              "am": (caps["am"], RX_ARGV["am"], "2400k"), "ssb": (caps["ssb"], RX_ARGV["ssb"], str(PSK_RATE))}
        for mode, (path, argv, rate) in rx.items():
            fmt = path.rsplit(".", 1)[1]
            audio = mode in ("fm", "am", "ssb")
            out = os.path.join(tmp, f"d{mode}")
            text = run_cli([*argv, *(["-out", out] if audio else []), path])
            th, port, errors = start_daemon(["-mode", mode, *argv[1:], "-sr", rate, "-format", fmt], 1)
            with open(path, "rb") as f:
                burst = f.read()
            reply = session(mode, port, burst, {}, len(burst) // 2)
            end_daemon(th, errors)
            if audio:
                head, rest = reply.split(b"\n", 1)
                _, n, r = head.decode().removeprefix("# ").split()
                with open(f"{out}.sr{r}.f32", "rb") as f:
                    pcm = f.read()
                same = rest[: 4 * int(n)] == pcm and rest[4 * int(n) :].decode() == f"\n# {mode}: {n} audio samples @ {r} Hz\n"
                print(f"  serve -mode {mode}: {n} audio samples at {r} Hz, the bytes of {mode} -out: {same}")
            else:
                want_lines = text.strip().splitlines()
                got = reply.decode().strip().splitlines()
                same = got == [want_lines[0], f"# {want_lines[1]}"]
                print(f"  serve -mode {mode}: {len(got[0])} characters, the lines of {mode} on the card: {same}")
            if not same:
                raise AssertionError(f"serve -mode {mode} differs from its command on the card")
        laps.append(("receivers", time.perf_counter()))

        # one daemon in a process of its own, QUADRS_PLATFORM unset: it builds and loads before it listens
        argv = [sys.executable, "-m", "quadrs_tpu_torch", "serve", "-once", "yes", "-port", "0", "-search", "yes",
                "-timeout", str(DAEMON_STALL), *bench]
        t0 = time.perf_counter()
        proc = subprocess.Popen(argv, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                                env={k: v for k, v in os.environ.items() if k != "QUADRS_PLATFORM"})
        try:
            banner = proc.stdout.readline()
            up = time.perf_counter() - t0
            m = re.match(r"serve: listening on 127\.0\.0\.1:(\d+) \(complex_int8, sr 21000000, stream search, "
                         rf"timeout {DAEMON_STALL:g}s\)$", banner)
            if not m:
                raise AssertionError(f"serve in a process: banner {banner!r}; {proc.stderr.read()}")
            reply, wall = serve_client(int(m[1]), slices[0])
            log, err = proc.communicate(timeout=120)
        finally:
            proc.kill()
            proc.wait()
        if proc.returncode != 0 or not re.match(r"serve: conn 1 127\.0\.0\.1:\d+ done: ", log):
            raise AssertionError(f"serve in a process exited {proc.returncode}: {log} {err}")
        a, b = reply.decode().strip().splitlines(), sequential[0].decode().strip().splitlines()
        if a[:-1] != b[:-1]:
            raise AssertionError("serve in a process: its reply differs from the in-process daemon's")
        print(f"  python -m quadrs_tpu_torch serve -once yes: banner {up:.2f}s after the start, one session of "
              f"{wall:.3f}s inside its {DAEMON_STALL:g}s timeout ({log.strip()}); the reply the in-process daemon's")
        laps.append(("a process", time.perf_counter()))
    finally:
        sys.stdout = stdout
    print("  the daemon, its steps: " + ", ".join(f"{name} {t - laps[i][1]:.1f}s" for i, (name, t) in enumerate(laps[1:])))
    return {n: v for n, v in total.items() if v}


MESH_SAMPLES = 1 << 24  # phase 4's mesh runs: the stream over the main capture's first 2^24 samples
MESH_BANK = 8  # ... and the bank over the first 8 captures of the bank phase (2^21 samples each)
MESH_TOL = 1e-5  # a mesh run against the single-device run: stream norms, of scale


def _near_ties(norms: np.ndarray, tol: float) -> np.ndarray:
    """Windows whose top two norms lie within ``tol``: a peak bin there may
    flip with the last bits of the norms."""
    top2 = np.sort(norms, axis=-1)[..., -2:]
    return top2[..., 1] - top2[..., 0] <= tol


def _zero_launches() -> None:
    from quadrs_tpu_torch.ops import frontend as fe
    from quadrs_tpu_torch.ops import waterfall as wf

    for k in (fe.frontend_fir, fe.frontend_fir_stft, wf.waterfall_norms, wf.waterfall_search, wf.waterfall_scan):
        k.launches = 0


def _launched() -> dict[str, int]:
    return {k: v for k, v in all_launches().items() if v and k != "frontend_banded"}


def _profiled_call(fn) -> tuple[float, float]:
    """(wall s, device busy s) of ``fn()`` under ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile

    from profile_stream import device_busy

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return wall, device_busy(prof)[0] / 1e3


def _collect(run, **kw):
    """A runner run's outputs, joined along the window axis, its stats and wall."""
    parts = []
    t0 = time.perf_counter()
    stats = run(lambda w0, out: parts.append(out), **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if parts and isinstance(parts[0], tuple):
        return tuple(np.concatenate(p, axis=-1) for p in zip(*parts)), stats, wall
    return np.concatenate(parts, axis=-2), stats, wall


def _check_peaks(name: str, idx: np.ndarray, want_idx: np.ndarray, norms: np.ndarray, tol: float) -> int:
    """Peak bins of a mesh run against the single-device run's: every
    differing bin must sit on a near-tie of the single run's norms."""
    diff = idx != want_idx
    ties = _near_ties(norms, tol)
    print(f"    {name}: {int(diff.sum())} of {diff.size} peak bins differ, all inside near-ties: "
          f"{bool((~diff | ties).all())} ({int(ties.sum())} near-ties)")
    if (diff & ~ties).any():
        raise AssertionError(f"{name}: peak bins differ outside near-ties")
    return int(diff.sum())


def _check_counts(name: str, above: np.ndarray, want: np.ndarray, norms: np.ndarray, thr: float, tol: float) -> None:
    """Survey counts against the single run's: equal but for norms within
    ``tol`` of the threshold."""
    near = (np.abs(norms - np.float32(thr)) <= tol).sum(axis=-2)
    off = np.abs(above - want)
    print(f"    {name}: counts differ in {int((off > 0).sum())} bins, each by at most its near-threshold norms: "
          f"{bool((off <= near).all())}")
    if (off > near).any():
        raise AssertionError(f"{name}: survey counts differ outside the threshold's noise band")


def phase_mesh_path(card: str, cap: str, tmp: str, band: str) -> dict[str, int]:
    """Phase 4, ``-mesh``: the stream and the bank over meshes that repeat
    the first card (a one-card machine stands for a mesh so), ``find`` and
    ``channelize`` on a 2x1 mesh, each held to the single-device run on the
    card, each kernel's launches counted from 0 over every mesh run; with
    two or more cards, the stream and the bank over distinct cards too.
    The current device must be what it was after every run.  Returns the
    kernels' launches over the mesh runs."""
    from quadrs_tpu_torch import sinks
    from quadrs_tpu_torch import args as targs
    from quadrs_tpu_torch.formats import FileFormat
    from quadrs_tpu_torch.models.channelizer import Channelize, run_channelize
    from quadrs_tpu_torch.models.receiver import PipelineModel
    from quadrs_tpu_torch.models.waterfall import WaterfallConfig, WaterfallModel
    from quadrs_tpu_torch.parallel.sharding import make_mesh
    from quadrs_tpu_torch.sources import open_capture
    from quadrs_tpu_torch.stream_runner import StreamRunner, WaterfallRunner

    os.environ.pop("QUADRS_PLATFORM", None)  # the CLI's default device: cuda
    t_phase = time.perf_counter()
    current = torch.cuda.current_device()
    card0 = torch.device("cuda", 0) if DEVICE.type == "cuda" else DEVICE  # the CPU in a rehearsal
    launches: dict[str, int] = {}

    def mesh_run(name: str, fn):
        """``fn()`` with every count set to 0 just before and read just
        after; the current device unchanged."""
        _zero_launches()
        out = fn()
        torch.cuda.synchronize()
        got = _launched()
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
        if torch.cuda.current_device() != current:
            raise AssertionError(f"{name} left device {torch.cuda.current_device()} current, not {current}")
        return out, got

    # -- the stream: the bench config over 2^24 samples ---------------------
    stream_cap = os.path.join(tmp, "mesh.sr21M.cs8")
    with open(cap, "rb") as f, open(stream_cap, "wb") as g:
        g.write(f.read(MESH_SAMPLES * 2))
    cfg = bench_cfg(FileFormat.COMPLEX_INT8)
    model = PipelineModel(cfg)
    single = StreamRunner(open_capture(stream_cap), model, DEVICE, chunk_samples=CHUNK)
    single.run()  # a warm run: the ring's page-locked slots made, each kernel loaded
    norms, st, wall = _collect(single.run)
    (idx, _), _, wall_s = _collect(single.run_search)
    thr = float(np.median(norms))
    scan = single.run_scan(thr)
    scale = float(norms.max())
    busy = _profiled_call(lambda: single.run())
    print(f"  stream, single device: {norms.shape[0]} windows, {wall:.3f}s ({MESH_SAMPLES / wall / 1e6:.1f} Msps), "
          f"-search {wall_s:.3f}s; profiled {busy[0]:.3f}s, device busy {100 * busy[1] / busy[0]:.1f}% ({card})")
    meshes = [("1x1", [card0]), ("2x1", [card0] * 2), ("4x1", [card0] * 4)]
    if torch.cuda.device_count() >= 2:
        meshes.append(("2x1 distinct", [torch.device("cuda", 0), torch.device("cuda", 1)]))
    for name, devices in meshes:
        mesh = make_mesh(len(devices), 1, devices=devices)
        runner = StreamRunner(open_capture(stream_cap), model, DEVICE, chunk_samples=CHUNK, mesh=mesh)
        t0 = time.perf_counter()
        _, warm = mesh_run(f"stream {name} (warm run)", runner.run)
        cold = time.perf_counter() - t0
        (got, stats, mwall), counts = mesh_run(f"stream {name}", lambda: _collect(runner.run))
        counts = {k: counts.get(k, 0) + warm.get(k, 0) for k in {**counts, **warm}}
        err = float(np.abs(got - norms).max()) if got.shape == norms.shape else float("inf")
        ((gidx, _), _, swall), _ = mesh_run(f"stream {name} -search", lambda: _collect(runner.run_search))
        gscan, _ = mesh_run(f"stream {name} -scan", lambda: runner.run_scan(thr))
        pwall, pbusy = _profiled_call(lambda: mesh_run(f"stream {name} profiled", runner.run))
        print(f"  stream -mesh {name} ({runner.chunk_samples}-sample chunks): the first run {cold:.3f}s, then {mwall:.3f}s "
              f"({MESH_SAMPLES / mwall / 1e6:.1f} Msps; {mwall / wall:.2f}x the single-device wall), -search "
              f"{swall:.3f}s; profiled {pwall:.3f}s, device busy {100 * pbusy / pwall:.1f}%; launches {counts}; "
              f"norms max_abs_err {err:.3e} of scale {scale:.4g} ({card})")
        if err > MESH_TOL * scale or stats.windows_out != st.windows_out or not counts.get("frontend_fir"):
            raise AssertionError(f"stream -mesh {name}: norms off by {err} or {stats.windows_out} windows or no launch")
        _check_peaks(f"stream -mesh {name} -search", gidx, idx, norms, MESH_TOL * scale)
        sum_err = float(np.abs(gscan.sum_norms - scan.sum_norms).max())
        print(f"    stream -mesh {name} -scan: {gscan.windows} windows, sums max |diff| {sum_err:.4g} "
              f"(bound {gscan.windows * MESH_TOL * scale:.4g})")
        if gscan.windows != scan.windows or sum_err > gscan.windows * MESH_TOL * scale:
            raise AssertionError(f"stream -mesh {name} -scan: the survey disagrees")
        _check_counts(f"stream -mesh {name} -scan", gscan.above[0], scan.above[0], norms, thr, MESH_TOL * scale)
    if torch.cuda.device_count() < 2:
        print(f"  the distinct-card runs: skipped, this machine has {torch.cuda.device_count()} card "
              "(the meshes above repeat cuda:0)")

    # through the CLI: stream -mesh 1x1 from the file, and from replay's pipe
    prefix = os.path.join(tmp, "mesh")
    argv = ["stream", "-shift", "280k", "-chunk", str(CHUNK), "-mesh", "1x1"]
    mesh_run("stream -mesh 1x1 (CLI)", lambda: run_cli([*argv, "-out", prefix, stream_cap]))
    cli = np.fromfile(f"{prefix}.norms.f32", dtype=np.float32).reshape(-1, cfg.fft_width)
    err = float(np.abs(cli - norms).max()) if cli.shape == norms.shape else float("inf")
    print(f"    stream -mesh 1x1 (CLI) norms max_abs_err {err:.3e} against the single-device runner ({card})")
    if err > MESH_TOL * scale:
        raise AssertionError("stream -mesh 1x1 through the CLI disagrees")
    mesh_run("replay | stream -stdin -mesh 1x1", lambda: piped(
        [*argv, "-stdin", "yes", "-sr", "21M", "-format", "cs8", "-out", prefix + "pipe"], stream_cap))
    if np.fromfile(f"{prefix}pipe.norms.f32", dtype=np.float32).tobytes() != cli.tobytes():
        raise AssertionError("replay | stream -stdin -mesh 1x1: norms differ from the file run's")
    print("    replay | stream -stdin yes -mesh 1x1: norms byte for byte the file run's")

    # -- the bank: 8 captures of 2^21 cs8 samples on a 2x2 mesh ---------------
    files = write_bank(tmp, MESH_BANK, BANK_SAMPLES)
    for stride in (1024, 256):
        bank = WaterfallModel(WaterfallConfig(n_streams=MESH_BANK, fft_width=1024, stride=stride))
        one = WaterfallRunner([open_capture(p) for p in files], bank, DEVICE, chunk_windows=BANK_CHUNK)
        one.run()  # a warm run
        want, _, wall = _collect(one.run)
        (widx, _), _, _ = _collect(one.run_search)
        wthr = 20.0
        wscan = one.run_scan(wthr)
        wscale = float(want.max())
        bank_meshes = [("2x2", [card0] * 4)]
        if torch.cuda.device_count() >= 2:
            bank_meshes.append(("2x2 distinct", [torch.device("cuda", i % 2) for i in range(4)]))
        for name, devices in bank_meshes:
            runner = WaterfallRunner([open_capture(p) for p in files], bank, DEVICE, chunk_windows=BANK_CHUNK,
                                     mesh=make_mesh(2, 2, devices=devices))
            _, warm = mesh_run(f"waterfall {name} (warm run)", runner.run)
            (got, _, mwall), counts = mesh_run(f"waterfall {name}", lambda: _collect(runner.run))
            counts = {k: counts.get(k, 0) + warm.get(k, 0) for k in {**counts, **warm}}
            ((gidx, _), _, _), c2 = mesh_run(f"waterfall {name} -search", lambda: _collect(runner.run_search))
            gscan, c3 = mesh_run(f"scan {name}", lambda: runner.run_scan(wthr))
            err = float(np.abs(got - want).max()) if got.shape == want.shape else float("inf")
            print(f"  waterfall -stride {stride} -mesh {name} over {MESH_BANK} captures: {mwall:.3f}s (single device "
                  f"{wall:.3f}s); norms max_abs_err {err:.3e} of scale {wscale:.4g}; launches {counts}, -search {c2}, "
                  f"scan {c3} ({card})")
            if err > WF_RTOL * wscale or not counts.get("waterfall_norms") or not c2.get("waterfall_search"):
                raise AssertionError(f"waterfall -mesh {name}: norms off by {err} or a kernel not launched")
            _check_peaks(f"waterfall -stride {stride} -mesh {name} -search", gidx, widx, want, WF_RTOL * wscale)
            sum_err = float(np.abs(gscan.sum_norms - wscan.sum_norms).max())
            print(f"    scan -stride {stride} -mesh {name}: {gscan.windows} windows, sums max |diff| {sum_err:.4g} "
                  f"(bound {gscan.windows * WF_RTOL * wscale:.4g})")
            if gscan.windows != wscan.windows or sum_err > gscan.windows * WF_RTOL * wscale:
                raise AssertionError(f"scan -mesh {name}: the survey disagrees")
            _check_counts(f"scan -stride {stride} -mesh {name}", gscan.above, wscan.above, want, wthr, WF_RTOL * wscale)
        del want

    # -- find and channelize on a 2x1 mesh of the repeated card ----------------
    find_cap, template = os.path.join(tmp, "find.sr21M.cs8"), os.path.join(tmp, "t.sr21M.cs8")
    code = np.fromfile(template, dtype=np.int8).reshape(-1, 2).astype(np.float32) / np.float32(127.0)
    pattern = (code[:, 0] + 1j * code[:, 1]).astype(np.complex64)
    t0 = time.perf_counter()
    want = sinks.find_pattern(open_capture(find_cap), pattern, device=DEVICE)
    fwall = time.perf_counter() - t0
    mesh2 = make_mesh(2, 1, devices=[card0] * 2)
    mesh_run("find -mesh 2 (warm run)", lambda: sinks.find_pattern(open_capture(find_cap), pattern, mesh=mesh2,
                                                                   device=DEVICE))
    t0 = time.perf_counter()
    got, _ = mesh_run("find -mesh 2", lambda: sinks.find_pattern(open_capture(find_cap), pattern, mesh=mesh2,
                                                                 device=DEVICE))
    mwall = time.perf_counter() - t0
    score_err = float(np.abs(got.scores - want.scores).max()) if len(got.scores) == len(want.scores) else float("inf")
    print(f"  find -mesh 2 over {CAPTURE_SAMPLES} samples: {len(got.offsets)} matches, {mwall:.3f}s (single device "
          f"{fwall:.3f}s); offsets equal: {np.array_equal(got.offsets, want.offsets)}, scores max |diff| "
          f"{score_err:.3g} (bound 2e-4) ({card})")
    if not (np.array_equal(got.offsets, want.offsets) and np.array_equal(got.which, want.which)
            and score_err <= 2e-4 and len(got.offsets) > 0):
        raise AssertionError("find -mesh 2 disagrees with the single-device run")

    # every shard pulls a whole -chunk here, so the per-read truncation at
    # each pull's end falls where the single-device run's does
    (cmd,) = targs.parse(["channelize", "-channels", str(CH_K), "-power", str(CH_POWER), "-chunk", str(CH_CHUNK), band])

    def channels(mesh):
        src = open_capture(band)
        return run_channelize(Channelize(src, cmd.channels, frequency=cmd.frequency, size=cmd.size), device=DEVICE,
                              chunk=cmd.chunk, mesh=mesh)

    mesh_run("channelize -mesh 2 (warm run)", lambda: list(run_channelize(
        Channelize(open_capture(band), cmd.channels, frequency=cmd.frequency, size=cmd.size), device=DEVICE,
        chunk=cmd.chunk, max_out=2 * cmd.chunk, mesh=mesh2)))
    t0 = time.perf_counter()
    pieces, _ = mesh_run("channelize -mesh 2", lambda: list(channels(mesh2)))
    mwall = time.perf_counter() - t0
    got = np.concatenate([p.data for p in pieces], axis=1)
    del pieces
    t0, at, err, scale = time.perf_counter(), 0, 0.0, 0.0
    for piece in channels(None):
        w = piece.data
        err = max(err, float(np.abs(got[:, at : at + w.shape[1]] - w).max()))
        scale = max(scale, float(np.abs(w).max()))
        at += w.shape[1]
    cwall = time.perf_counter() - t0
    print(f"  channelize -channels {CH_K} -mesh 2: {got.shape[1]} samples a channel, {mwall:.3f}s (single device "
          f"{cwall:.3f}s); channels max |diff| {err:.3g} of scale {scale:.4g} (bound 2e-6 of it) ({card})")
    if at != got.shape[1] or err > 2e-6 * scale:
        raise AssertionError("channelize -mesh 2 disagrees with the single-device run")
    del got
    print(f"  the mesh runs: {time.perf_counter() - t_phase:.1f}s of phase 4; kernel launches {launches}; "
          f"current device {torch.cuda.current_device()} throughout")
    return launches


AUDIO_TOL = 1e-5  # audio of full scale 1, a mesh run against the single-device run (phase 4's bound)


@contextlib.contextmanager
def repeated_card_meshes():
    """The CLI's ``-mesh TxS`` over meshes that repeat the first card
    (``serve.mesh_of`` takes a card a shard, where there may be one card):
    a one-card machine stands for a mesh so, as in ``phase_mesh_path``."""
    from quadrs_tpu_torch import serve
    from quadrs_tpu_torch.parallel.sharding import make_mesh

    card0 = torch.device("cuda", 0) if DEVICE.type == "cuda" else DEVICE
    of = serve.mesh_of
    serve.mesh_of = lambda shape: None if shape is None else make_mesh(
        shape[0], shape[1], devices=[card0] * (shape[0] * shape[1]))
    try:
        yield card0
    finally:
        serve.mesh_of = of


def same_psk(name: str, a: str, b: str) -> None:
    """Two ``psk`` runs' lines: the bits equal, the trailer's numbers within
    one unit of their last printed digit."""
    (bits_a, nums_a), (bits_b, nums_b) = psk_line(a), psk_line(b)
    res = {"freq": 0.1, "phase": 1e-3, "tau": 1e-2, "sps": 0.0}
    if bits_a != bits_b or any(abs(nums_a[k] - nums_b[k]) > res[k] + 1e-9 for k in res):
        raise AssertionError(f"{name}: {nums_a} against {nums_b}, bits equal: {bits_a == bits_b}")


def phase_receiver_mesh(card: str, caps: dict[str, str], tmp: str) -> dict[str, float]:
    """Phase 4, the receivers' ``-mesh``: each receiver at its phase-4
    capture and configuration through the CLI with ``-mesh 2`` and ``-mesh
    4`` on meshes that repeat the card, against the same command without
    ``-mesh`` on the card: ``ook``'s bits, ``fsk``'s digits (but at
    near-ties) and ``psk``'s bits equal, audio within ``1e-5`` of full
    scale; PSK's baseband on a 4-way mesh within ``1e-5`` of its scale.
    Each mesh run must shard (a ``_MeshChannelStep`` dispatch at least) and
    launch no kernel of the port.  Returns the walls."""
    from quadrs_tpu_torch.models.demod import PskDemod
    from quadrs_tpu_torch.parallel.sharding import make_mesh
    from quadrs_tpu_torch.sources import open_capture

    t_phase = time.perf_counter()
    walls: dict[str, float] = {}
    runs = {"ook": (RX_ARGV["ook"], None), "fsk": (RX_ARGV["fsk"], None), "psk": (psk_argv("bpsk"), None),
            "fm": (RX_ARGV["fm"], 48_000), "am": (RX_ARGV["am"], 48_000), "ssb": (RX_ARGV["ssb"], 250_000)}
    paths = {**caps, "psk": caps["bpsk"]}
    with repeated_card_meshes() as card0:
        for name, (argv, rate) in runs.items():
            samples = PSK_SAMPLES if name == "psk" else samples_of(name)
            outs, audio = {}, {}
            for mesh in (1, 2, 4):
                tag = f"{name}-mesh{mesh}"
                extra = ["-mesh", str(mesh)] if mesh > 1 else []
                out = ["-out", os.path.join(tmp, tag), "-overwrite", "yes"] if rate else []
                with counting_dispatches("_MeshChannelStep") as sharded:
                    outs[mesh] = card_run(tag, [*argv, *extra, *out, paths[name]], card, walls, samples=samples)
                if (sharded["n"] > 0) != (mesh > 1):
                    raise AssertionError(f"{tag}: {sharded['n']} sharded dispatches")
                if rate:
                    audio[mesh] = np.fromfile(os.path.join(tmp, f"{tag}.sr{rate}.f32"), dtype="<f4")
                print(f"    {tag}: {sharded['n']} sharded dispatches, {walls[tag] / walls[f'{name}-mesh1']:.2f}x "
                      f"the single-device wall ({card})")
            for mesh in (2, 4):
                if rate:
                    err = float(np.abs(audio[mesh] - audio[1]).max()) if audio[mesh].shape == audio[1].shape else np.inf
                    print(f"    {name} -mesh {mesh}: {len(audio[mesh])} audio samples, max |diff| {err:.3e} of full "
                          f"scale 1 against the single-device run")
                    if err > AUDIO_TOL:
                        raise AssertionError(f"{name} -mesh {mesh}: the audio disagrees")
                elif name == "psk":
                    same_psk(f"psk -mesh {mesh}", outs[mesh], outs[1])
                elif name == "fsk":
                    got, want = outs[mesh].splitlines()[0], outs[1].splitlines()[0]
                    bad = [i for i in range(len(want)) if got[i] != want[i]] if len(got) == len(want) else None
                    if bad is None or (bad and not fsk_near_ties(bad, paths["fsk"], DEVICE)):
                        raise AssertionError(f"fsk -mesh {mesh}: digits differ away from a near-tie")
                    print(f"    fsk -mesh {mesh}: {len(got)} digits, {len(bad)} differ (near-ties)")
                elif outs[mesh] != outs[1]:
                    raise AssertionError(f"{name} -mesh {mesh}: {outs[mesh]!r} against {outs[1]!r}")
        psk = PskDemod(symbol_rate=PSK_CASES["bpsk"][1])
        rate, want = psk.baseband(open_capture(caps["bpsk"]), device=DEVICE)
        _, got = psk.baseband(open_capture(caps["bpsk"]), device=DEVICE, mesh=make_mesh(4, devices=[card0] * 4))
        scale = float(np.abs(want).max())
        err = float(np.abs(got - want).max()) if got.shape == want.shape else np.inf
        print(f"    psk baseband -mesh 4: {len(got)} samples at {rate} Hz, max |diff| {err:.3e} of scale {scale:.4g}")
        if err > 1e-5 * scale:
            raise AssertionError("psk -mesh 4: the baseband disagrees")
    print(f"  the receivers' -mesh: {time.perf_counter() - t_phase:.1f}s of phase 4")
    return walls


def phase_daemon_mesh(card: str, cap: str, tmp: str, find_stdin: str) -> dict[str, int]:
    """Phase 4, ``serve -mesh`` on meshes that repeat the card, each session
    against the unmeshed daemon's reply to the same bytes: ``-mesh 2x1`` at
    the stream config over the 2^26-sample capture (norms within ``1e-5``
    of scale), ``-mode fsk -mesh 4`` over the stream's capture (digits
    equal but at near-ties), ``-mode find -mesh 2`` over ``find``'s capture
    (offsets equal, scores within ``2e-4``, against ``find_stdin``: the
    lines of ``replay | find -stdin``, which the unmeshed daemon's reply
    equals in ``phase_daemon``), ``-mode waterfall -mesh 2x1``
    over the bank's first capture (norms within ``2e-5`` of scale; a
    connection is one stream, so a mesh of two stream rows fails each
    session, as in the JAX package), and ``-parallel 2 -mesh 2``: two
    ``-search`` sessions at once, each reply a direct mesh run's lines.  Each
    session's launches counted from 0.  Returns the sessions' launches."""
    import threading

    from quadrs_tpu_torch.formats import FileFormat
    from quadrs_tpu_torch.models.receiver import PipelineModel
    from quadrs_tpu_torch.parallel.sharding import make_mesh
    from quadrs_tpu_torch.sources import PipeSource
    from quadrs_tpu_torch.stream_runner import StreamRunner

    os.environ.pop("QUADRS_PLATFORM", None)
    t_phase = time.perf_counter()
    launches: dict[str, int] = {}
    cfg = bench_cfg(FileFormat.COMPLEX_INT8)
    bench = ["-shift", "280k", "-lowpass", "200k", "-power", "200", "-decimate", "32", "-width", "64",
             "-chunk", str(CHUNK), "-sr", str(SAMPLE_RATE), "-format", "cs8"]
    srate = ["-sr", str(SAMPLE_RATE), "-format", "cs8"]

    def serve_once(name: str, argv: list[str], payload, mesh=None) -> bytes:
        """One session of a daemon made for it; its launches counted from 0."""
        th, port, errors = start_daemon(argv, 1, mesh)
        _zero_launches()
        reply, wall = serve_client(port, payload)
        end_daemon(th, errors)
        got = _launched()
        if mesh is not None:
            for k, v in got.items():
                launches[k] = launches.get(k, 0) + v
        print(f"    {name}: {wall:.3f}s, {len(reply)} bytes back; launches {got or 'none'} ({card})")
        return reply

    def lines(reply: bytes) -> list[str]:
        return reply.decode().strip().splitlines()

    with repeated_card_meshes() as card0, open(cap, "rb") as f:
        data = f.read()
        # -mode stream: the norms
        want = np.frombuffer(serve_once("stream", bench, data), dtype=np.float32).reshape(-1, cfg.fft_width)
        got = np.frombuffer(serve_once("stream -mesh 2x1", bench, data, (2, 1)), dtype=np.float32).reshape(-1, cfg.fft_width)
        err = float(np.abs(got - want).max()) if got.shape == want.shape else np.inf
        print(f"  serve -mesh 2x1: {got.shape[0]} norms rows, max |diff| {err:.3e} of scale {want.max():.4g} against the "
              f"unmeshed daemon ({card})")
        if err > MESH_TOL * float(want.max()) or not launches.get("frontend_fir"):
            raise AssertionError("serve -mesh 2x1: the norms disagree, or no kernel launched")
        # -mode fsk -mesh 4
        fsk = ["-mode", "fsk", *RX_ARGV["fsk"][1:], *srate]
        want, got = (lines(serve_once(f"fsk{tag}", fsk, data, mesh)) for tag, mesh in (("", None), (" -mesh 4", (4, 1))))
        bad = [i for i in range(len(want[0])) if got[0][i] != want[0][i]] if len(got[0]) == len(want[0]) else None
        if bad is None or got[1] != want[1] or (bad and not fsk_near_ties(bad, cap, DEVICE)):
            raise AssertionError("serve -mode fsk -mesh 4: the digits differ away from a near-tie")
        print(f"  serve -mode fsk -mesh 4: {len(got[0])} digits, {len(bad)} differ from the unmeshed reply (near-ties)")
        # -mode find -mesh 2: the bank of three over the 9-row grid
        names = [os.path.join(tmp, f"b{k}.sr21M.cs8") for k in range(len(FIND_BANK))]
        find = ["-mode", "find", *[a for b in names for a in ("-pattern", b)], "-freq-tol", FIND_TOL, *srate]
        with open(os.path.join(tmp, "find.sr21M.cs8"), "rb") as f:
            got = lines(serve_once("find -mesh 2", find, f.read(), (2, 1)))
        want = find_stdin.strip().splitlines()
        want[-1] = f"# {want[-1]}"
        rows_w, rows_g = ([ln.split(",") for ln in x[:-1]] for x in (want, got))
        if (len(rows_g) != len(rows_w) or not rows_g or got[-1] != want[-1]
                or any(g[0] != w[0] or g[3:] != w[3:] or abs(float(g[1]) - float(w[1])) > 2e-4 + 5e-5
                       for g, w in zip(rows_g, rows_w))):
            raise AssertionError("serve -mode find -mesh 2 disagrees with the unmeshed daemon")
        print(f"  serve -mode find -mesh 2: {len(rows_g)} matches, offsets and freqs equal, scores within 2e-4")
        # -mode waterfall -mesh 2x1 over one capture of the bank
        (bank,) = write_bank(tmp, 1, BANK_SAMPLES)
        with open(bank, "rb") as f:
            bank_data = f.read()
        wfall = ["-mode", "waterfall", "-width", "1024", "-chunk", str(BANK_CHUNK), *srate]
        want, got = (np.frombuffer(serve_once(f"waterfall{tag}", wfall, bank_data, mesh), dtype=np.float32)
                     for tag, mesh in (("", None), (" -mesh 2x1", (2, 1))))
        err = float(np.abs(got - want).max()) if got.shape == want.shape else np.inf
        print(f"  serve -mode waterfall -mesh 2x1: {got.size // 1024} rows, max |diff| {err:.3e} of scale "
              f"{want.max():.4g}")
        if err > WF_RTOL * float(want.max()) or not launches.get("waterfall_norms"):
            raise AssertionError("serve -mode waterfall -mesh 2x1 disagrees, or no kernel launched")
        # -parallel 2 -mesh 2: two -search sessions at once over halves of the capture
        halves = [memoryview(data)[i * CAPTURE_SAMPLES : (i + 1) * CAPTURE_SAMPLES] for i in range(2)]
        th, port, errors = start_daemon([*bench, "-search", "yes", "-parallel", "2"], 2, (2, 1))
        _zero_launches()
        replies: list = [None, None]
        clients = [threading.Thread(target=lambda i=i: replies.__setitem__(i, serve_client(port, halves[i])))
                   for i in range(2)]
        t0 = time.perf_counter()
        for c in clients:
            c.start()
        for c in clients:
            c.join(timeout=300)
        wall = time.perf_counter() - t0
        end_daemon(th, errors)
        for k, v in _launched().items():
            launches[k] = launches.get(k, 0) + v
        model = PipelineModel(cfg)
        for i, half in enumerate(halves):
            rows = []
            StreamRunner(PipeSource(io.BytesIO(bytes(half)), cfg.fmt, SAMPLE_RATE), model, DEVICE, chunk_samples=CHUNK,
                         mesh=make_mesh(2, devices=[card0] * 2)).run_search(lambda w0, out: rows.append((w0, out)))
            want = [f"{w0 + j},{int(idx[j])},{float(val[j]):.9g}" for w0, (idx, val) in rows for j in range(len(idx))]
            got = lines(replies[i][0])
            if got[1:-1] != want or not got[-1].startswith("# stream: "):
                raise AssertionError(f"serve -parallel 2 -mesh 2: session {i} differs from a direct mesh run")
        print(f"  serve -parallel 2 -mesh 2: two sessions of {CAPTURE_SAMPLES // 2} samples at once in {wall:.3f}s "
              f"({CAPTURE_SAMPLES / wall / 1e6:.1f} Msps aggregate), each reply a direct mesh run's lines ({card})")
    print(f"  the daemon's -mesh: {time.perf_counter() - t_phase:.1f}s of phase 4; launches {launches}")
    return launches


DIST_CHUNK = 1 << 22  # the distributed run's chunk: a whole number of 4 shards' 2048-sample windows


def phase_distributed(card: str, tmp: str) -> dict[str, int]:
    """Phase 4, several processes: ``python -m
    quadrs_tpu_torch.parallel.distributed`` as two processes on the card
    (gloo by the backend rule: NCCL refuses two ranks on one card), two
    shards each, at the stream config over the mesh phase's 2^24-sample
    capture, each worker on its current card (``QUADRS_PLATFORM`` unset,
    the package's rule); each rank's ``addressable_rows`` against the
    single-device rows at the same global index (within ``1e-5`` of
    scale), each worker with a timeout of its own.  Returns the workers'
    kernel launches."""
    import socket

    from quadrs_tpu_torch.parallel.distributed import backend_for

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    capture = os.path.join(tmp, "mesh.sr21M.cs8")
    env = {k: v for k, v in os.environ.items() if k != "QUADRS_PLATFORM"}
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, "-m", "quadrs_tpu_torch.parallel.distributed", "--address",
                               f"127.0.0.1:{port}", "--processes", "2", "--rank", str(r), "--shards", "2", "--chunk",
                               str(DIST_CHUNK), capture],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
                              cwd=os.path.dirname(os.path.abspath(__file__))) for r in range(2)]
    got = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=300)
            if p.returncode != 0:
                raise AssertionError(f"a distributed worker exited {p.returncode}: {out[-2000:]} {err[-2000:]}")
            got.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    launches = 0
    for r in got:
        print(f"  distributed rank {r['rank']} ({r['backend']}, {r['device']}, fused route {r['fused']}): "
              f"{r['shards']} shards, {r['rows']} rows, max |diff| {r['max_abs_err']:.3e} of scale {r['scale']:.4g} "
              f"against the single-device rows; frontend_fir launches {r['launches']} ({card})")
        if not (r["ok"] and r["device"] == "cuda:0" and r["rows"] > 0 and r["max_abs_err"] <= MESH_TOL * r["scale"]):
            raise AssertionError(f"distributed rank {r['rank']} disagrees with the single-device run")
        launches += r["launches"]
    print(f"  distributed: 2 processes x 2 shards, backend rule {backend_for(2)!r} for 2 ranks on "
          f"{torch.cuda.device_count()} card(s); {wall:.1f}s with the workers' start-up")
    return {"frontend_fir": launches} if launches else {}


def phase_profiler(card: str, tmp: str) -> None:
    """Phase 4, the stage accounting: one ``profiled()`` stream run over the
    mesh phase's capture and one Executor pull, and the profiler's report;
    the runner's and the Executor's stages must be counted."""
    from quadrs_tpu_torch.formats import FileFormat
    from quadrs_tpu_torch.models.receiver import PipelineModel
    from quadrs_tpu_torch.sources import ToneGen, open_capture
    from quadrs_tpu_torch.stream_runner import StreamRunner
    from quadrs_tpu_torch.utils.profiling import PROFILER, profiled

    PROFILER.reset()
    runner = StreamRunner(open_capture(os.path.join(tmp, "mesh.sr21M.cs8")), PipelineModel(bench_cfg(FileFormat.COMPLEX_INT8)),
                          DEVICE, chunk_samples=CHUNK)
    with profiled():
        stats = runner.run()
        ToneGen([1000], 48_000, 1.0).read_at(0, 4096, DEVICE)
    print("  profiled(): a stream run and an Executor pull ({})\n    {}".format(
        card, PROFILER.report().replace("\n", "\n    ")))
    s = PROFILER.stages["stream_runner"]
    if s.steps != 1 or s.samples != stats.samples_in or PROFILER.stages["tonegen"].steps != 1:
        raise AssertionError(f"profiled() missed a stage: {dict(PROFILER.stages)}")


class _Prefixed:
    """A text stream that writes to standard output with ``prefix`` at the
    start of each line."""

    def __init__(self, prefix: str):
        self.prefix, self.at_start = prefix, True

    def write(self, s: str) -> None:
        for part in s.splitlines(keepends=True):
            sys.stdout.write((self.prefix if self.at_start else "") + part)
            self.at_start = part.endswith("\n")

    def flush(self) -> None:
        sys.stdout.flush()


def phase_bench(card: str, tmp: str) -> dict[str, int]:
    """Phase 4's last: every entry of the bench at its ``quick`` scale
    (the full bench's shapes and lengths, 0.25 s windows, one rep, the
    1G-sample captures cut to 2^28 samples, written under ``tmp``), each
    line printed as it is measured.  Fails on an entry's error, on a kernel
    entry whose route launched no kernel or that lacks its output check.
    Returns the kernels' launches over the entries' timed windows and
    end-to-end runs (the output checks' launches are not counted)."""
    from quadrs_tpu_torch import bench
    from quadrs_tpu_torch import bench_suite as bs

    sc = bs.Scale("quick", DEVICE, tmp)
    print(f"  the bench, {len(bench.ENTRIES)} entries at the quick scale (cut: the 1G-sample captures to "
          f"{sc.capture_samples} samples; 0.25 s windows, one rep) ({card}):")
    t0 = time.perf_counter()
    lines = bench.run(list(bench.ENTRIES), sc, out=_Prefixed("    "))
    failed = [line["entry"] for line in lines if "error" in line]
    kernel_lines = [line for line in lines if line["entry"] in bs.KERNEL_ENTRIES]
    no_kernel = [line["entry"] for line in kernel_lines if not line.get("launches")]
    unchecked = [line["entry"] for line in kernel_lines if "max_err_over_scale" not in line]
    print(f"  the bench: {len(lines)} entries in {time.perf_counter() - t0:.1f}s; errors {failed}, kernel entries "
          f"with no launch {no_kernel}, without an output check {unchecked}")
    if failed or no_kernel or unchecked:
        raise AssertionError("the bench's quick phase failed")
    totals: dict[str, int] = {}
    for line in lines:
        for name, count in line.get("launches", {}).items():
            totals[name] = totals.get(name, 0) + count
    return totals


HBM_BYTES_PER_S = 3.35e12  # one H100 SXM: peak HBM3 rate
F32_FLOPS = 67e12  # f32 outside the tensor cores


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    """(the least ms the card could take: bytes over the HBM rate or
    operations over the f32 peak, the larger; which of the two it is)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def device_ms(fn, launches: int = 20, replays: int = 7) -> float:
    """The device's own time of ``fn``'s work, in ms: ``launches`` calls of
    ``fn`` are captured in one ``torch.cuda.CUDAGraph`` (the wrappers launch
    on the current stream and allocate with ``torch.empty``, which capture
    takes from the graph's pool), the graph is replayed between two events,
    and the median replay is divided by ``launches``.  No Python runs
    between the kernels of a replay, so a kernel shorter than its wrapper's
    host time is still read at its own length."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    times = []
    for _ in range(replays):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return sorted(times)[len(times) // 2]


def time_ms(fn, iters: int = 20) -> float:
    """``iters`` calls of ``fn`` back to back between two events: the larger
    of the device's and the host's time per call."""
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
    timed twice in mirrored order with :func:`time_ms`; the kernels and the
    yardstick, shorter than a call of their wrappers, also with
    :func:`device_ms`, which the kernels line reports as ``ms``."""
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
    dev_runs: dict[str, list[float]] = {k: [] for k in ("kernel1", "kernel2", "library_conv1d")}
    for k in order:
        runs[k].append(time_ms(variants[k]))
        if k in dev_runs:
            dev_runs[k].append(device_ms(variants[k]))
    ms = {k: sum(v) / len(v) for k, v in runs.items()}
    samples = n - (cfg.taps + cfg.taps - cfg.taps // 2)
    print(f"  timing: one cs8 chunk of {samples} samples, D 32, 400 taps, W 64 ({card})")
    for k, v in runs.items():
        print(f"    {k:22s} {ms[k]:.4f} ms back to back (runs {', '.join(f'{x:.4f}' for x in v)})  "
              f"{samples / ms[k] / 1e3:.1f} Msps")
    for k, v in dev_runs.items():
        ms[f"call {k}"], ms[k] = ms[k], sum(v) / len(v)
        print(f"    {k:22s} {ms[k]:.4f} ms on the device, graph replays (runs {', '.join(f'{x:.4f}' for x in v)})  "
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
    impl over :data:`FIR_SHAPES`, the chain's batch shapes and the sweep
    that the card's ``auto`` rule rests on (``ops.fir.auto_impl``; the frame
    sizes inside the spectral impls are still the JAX package's)."""
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
    dev_runs = []
    for k in list(variants) + list(reversed(variants)):
        runs[k].append(time_ms(variants[k]))
        if k == "banded":
            dev_runs.append(device_ms(variants[k]))
    ms = {k: sum(v) / len(v) for k, v in runs.items()}
    ms["call banded"], ms["banded"] = ms["banded"], sum(dev_runs) / len(dev_runs)
    print(f"  timing: the v1 kernel at one cs8 chunk of {n} samples, D 32, 400 taps ({card})")
    for k, v in runs.items():
        print(f"    {k:14s} {sum(v) / len(v):.4f} ms back to back (runs {', '.join(f'{x:.4f}' for x in v)})")
    print(f"    {'banded':14s} {ms['banded']:.4f} ms on the device, graph replays "
          f"(runs {', '.join(f'{x:.4f}' for x in dev_runs)})  {n / ms['banded'] / 1e3:.1f} Msps")

    g = torch.Generator(device=DEVICE).manual_seed(SEED)
    for label, b, d, taps, n_out in FIR_SHAPES:
        n_in = n_out * d + taps
        x = torch.complex(torch.randn((b, n_in), generator=g, device=DEVICE),
                          torch.randn((b, n_in), generator=g, device=DEVICE))
        h = lowpass_taps(200_000 / SAMPLE_RATE, taps)
        ref = fir_decimate(x, h, d, n_out, impl="polyphase")
        line = []
        for impl in IMPLS:
            if impl == "direct" and b * n_out * taps * 8 > 8 << 30:
                line.append(f"{impl} not measured (its frames would take {b * n_out * taps * 8 / 2**30:.0f} GiB)")
                continue
            if impl == "banded" and b * -(-n_out // 128) * (127 * d + taps) * 8 > 8 << 30:
                line.append(f"{impl} not measured (its spans would take "
                            f"{b * -(-n_out // 128) * (127 * d + taps) * 8 / 2**30:.0f} GiB)")
                continue
            err = float((fir_decimate(x, h, d, n_out, impl=impl) - ref).abs().max())
            t = time_ms(lambda: fir_decimate(x, h, d, n_out, impl=impl), iters=5)
            ms[f"fir {impl} @ {label}"] = t
            line.append(f"{impl} {t:.3f} ms ({b * n_in / t / 1e3:.0f} Msps in, |diff| vs polyphase {err:.1e})")
        best = min((k for k in ms if k.endswith(f"@ {label}")), key=ms.get).split()[1]
        took = auto_impl(taps, d, b * n_out, "cuda", n_out)
        print(f"  fir_decimate at the {label}: {b} x {n_in} -> {n_out}, D {d}, {taps} taps; fastest {best}, auto takes "
              f"{took} on CUDA ({ms[f'fir {took} @ {label}'] / ms[f'fir {best} @ {label}']:.2f}x the fastest), "
              f"{auto_impl(taps, d, b * n_out)} on the CPU ({card})")
        for item in line:
            print(f"    {item}")
        del x, ref
    return ms


def phase_cs16_readings(card: str) -> None:
    """Phase 5, ``step_stream`` at cs16 (D 8, 1100 taps, W 128: premixed
    taps, a spectral FIR), op by op against an f64 sum of the same function,
    on the card and on the CPU: the FIR output of each impl, then the norms.
    cs16 decodes to a DC of -32767.5 that the shift puts in the stopband; the
    output is mostly what the filter leaves of it, so an error of 1e-7 of
    the input is 1e-4 of the output."""
    from quadrs_tpu_torch.formats import FileFormat, decode_plane, synth_planes
    from quadrs_tpu_torch.models.receiver import PipelineConfig, PipelineModel
    from quadrs_tpu_torch.ops.fir import fir_decimate, lowpass_taps
    from quadrs_tpu_torch.ops.nco import ExactNCO

    d, taps, width, offset = 8, 1100, 128, 999_999_937
    n = d * width * 50 + taps + 777
    raw = synth_planes(FileFormat.COMPLEX_INT16, n, seed=d)
    prefix, n_dec = taps - taps // 2, (n - taps) // d
    x = decode_plane(raw[0], FileFormat.COMPLEX_INT16).astype(np.float64) \
        + 1j * decode_plane(raw[1], FileFormat.COMPLEX_INT16).astype(np.float64)
    x = x * np.exp(1j * ExactNCO(280_000, SAMPLE_RATE).angles(offset + np.arange(n), dtype=np.float64))
    h = lowpass_taps(200_000 / SAMPLE_RATE, taps).astype(np.float64)
    xp = np.concatenate([x[prefix:], np.zeros(taps + d)])
    y64 = np.lib.stride_tricks.sliding_window_view(xp, taps)[: n_dec * d : d] @ h
    n_w = n_dec // width
    exact = np.abs(np.fft.fftshift(np.fft.fft(y64[: n_w * width].reshape(n_w, width), axis=-1), axes=-1))
    scale, y_scale = float(exact.max()), float(np.abs(y64).max())
    print(f"  step_stream at cs16, D {d}, {taps} taps, W {width}: input magnitude {np.abs(x).max():.6g}, FIR output "
          f"max {y_scale:.4g}, norms max {scale:.4g}; errors over those maxima against an f64 sum ({card})")
    for impl in ("os_poly", "overlap_save", "polyphase", "banded"):
        model = PipelineModel(PipelineConfig(sample_rate=SAMPLE_RATE, shift_freq=280_000, lp_freq=200_000,
                                             decimate=d, taps=taps, fft_width=width, fmt=FileFormat.COMPLEX_INT16, fir_impl=impl))
        theta0 = model.theta0(np.asarray([offset]))[0]
        line = []
        for dev in (DEVICE, torch.device("cpu")):
            model.to(dev)
            planes = torch.from_numpy(raw).to(dev)
            z = model._decode(planes)
            t0 = torch.as_tensor(theta0, dtype=torch.float32, device=dev)
            if model._spectral_fir:
                y = model._twiddle_decimated(fir_decimate(z[None], model._premixed_taps, d, n_dec, impl=impl)[0], t0, n_dec)
            else:
                y = fir_decimate(model._mix_stream(z, t0)[None], model._taps_np, d, n_dec, impl=impl)[0]
            norms = model.step_stream(planes, theta0)
            fir_err = float(np.abs(y.cpu().numpy() - y64).max()) / y_scale
            err = float(np.abs(norms.cpu().numpy() - exact).max()) / scale
            line.append(f"{dev.type}: FIR {fir_err:.3e}, norms {err:.3e}")
        print(f"    {impl:13s} {'premixed taps' if model._spectral_fir else 'mixed samples'}; " + "; ".join(line))


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
            front = re.search(r"frontend_kernelI(\w)Li(\d)ELi(\d+)E", m.group(1))
            if front:
                t, mode, dc = front.groups()
                name = (f"frontend_kernel<{ {'f': 'f32', 'a': 'int8', 'h': 'uint8', 's': 'int16'}[t]}, "
                        f"{('fir', 'stft', 'banded')[int(mode)]}, {'D ' + dc if dc != '0' else 'any D'}>")
            elif wf:
                t, mode, ln = wf.groups()
                name = None if t != "a" else (f"waterfall_kernel<int8, {('norms', 'search', 'scan')[int(mode)]}, "
                                              f"{'width 2^' + ln if ln != '0' else 'any width'}>")
            else:
                name = f"{other.group(1)}<{other.group(2) or ''}>" if other else m.group(1)[-48:]
        elif name and ("Used" in line or "spill" in line):
            out.setdefault(name, []).append(line.split(":", 1)[-1].strip() if "Used" in line else line.strip())
    return [(k, "; ".join(v)) for k, v in out.items()]


def sass_mix(lib_path) -> list[str]:
    """The instruction mix of the cs8 waterfall body at 1024 points and of
    the cs8 frontend body at D 32, one line per mode, from ``cuobjdump
    -sass`` of the built library: static instructions in all, FP (FADD,
    FMUL, FFMA, MUFU; FFMA alone for the frontend), shared-memory (LDS,
    STS), global (LDG, STG) and barriers.  Empty without cuobjdump."""
    import collections
    import re
    from torch.utils.cpp_extension import CUDA_HOME

    tool = os.path.join(CUDA_HOME or "/usr/local/cuda", "bin", "cuobjdump")
    if not os.path.exists(tool):
        return []
    sass = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True, text=True, timeout=300).stdout
    lines = []
    for body in re.split(r"\n\s*Function : ", sass)[1:]:
        head = body.split("\n", 1)[0]
        m = re.search(r"waterfall_kernelIaLi(\d)ELi10E", head)
        f = re.search(r"frontend_kernelIaLi(\d)ELi32E", head)
        if not (m or f):
            continue
        ops = collections.Counter(o.split(".")[0] for o in re.findall(
            r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]+)", body))
        group = {k: sum(ops[o] for o in v) for k, v in (
            ("FP", ("FADD", "FMUL", "FFMA", "MUFU")), ("shared", ("LDS", "STS")), ("global", ("LDG", "STG")),
            ("barriers", ("BAR",)))}
        name = (f"waterfall_kernel<int8, {('norms', 'search', 'scan')[int(m.group(1))]}, width 2^10>" if m else
                f"frontend_kernel<int8, {('fir', 'stft', 'banded')[int(f.group(1))]}, D 32>")
        if f:
            group["FFMA"] = ops["FFMA"]
        lines.append(f"{name}: {sum(ops.values())} instructions, " + ", ".join(f"{k} {v}" for k, v in group.items()))
    return lines


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this smoke run needs one CUDA card", file=sys.stderr)
        return 1
    from quadrs_tpu_torch.ops import _cuda

    card = card_line()
    print(f"phase 1: card {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    from concurrent.futures import ThreadPoolExecutor

    from quadrs_tpu_torch import native

    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:  # nvcc and g++ side by side
        loader, lib = pool.submit(native.library), _cuda.library()
        loader = loader.result()
    print(f"phase 2: built {lib.path.name} in {time.perf_counter() - t0:.1f}s (nvcc {lib.build_seconds:.1f}s) and "
          f"{loader.path.name} (g++ {loader.build_seconds:.1f}s)")
    for name, used in ptxas_usage(lib.build_log):
        print(f"    {name}: {used}")
    for line in sass_mix(lib.path):
        print(f"    {line} (cuobjdump -sass)")
    print("phase 3: the loader against stage; kernels against their plain versions")
    tmp_dir = tempfile.TemporaryDirectory()
    tmp = tmp_dir.name
    cap = os.path.join(tmp, "smoke.sr21M.cs8")
    write_capture(cap, CAPTURE_SAMPLES)
    phase_loader(cap, tmp)
    at_main = phase_kernels()
    phase_frontend_edges()
    at_main["frontend_banded"] = phase_banded_kernel()
    phase_waterfall_kernels()
    print("phase 4: the main paths")
    from quadrs_tpu_torch.ops import frontend as fe

    fe.frontend_banded.launches = 0  # counts of the main paths only, from here
    try:
        launches, norms = phase_main_path(card, cap, tmp)
        live_launches = phase_live_path(card, cap, tmp, norms)
        del norms
        phase_chain_path(card, cap, tmp)
        before, t0 = all_launches(), time.perf_counter()
        walls, find_stdin = phase_find_path(card, tmp, cap)
        t1 = time.perf_counter()
        walls.update(phase_stage_path(card, cap, tmp))
        if all_launches() != before:
            raise AssertionError("find or the stages launched a kernel of the port: they run as torch ops")
        print(f"  find and the stages: {time.perf_counter() - t0:.1f}s of phase 4 (find {t1 - t0:.1f}s, "
              f"the stages {time.perf_counter() - t1:.1f}s)")
        t0 = time.perf_counter()
        rx_walls, rx_caps = phase_receiver_path(card, tmp, cap)
        print(f"  the receivers: {time.perf_counter() - t0:.1f}s of phase 4")
        # psk, channelize and the renderers: torch ops and cuFFT, no kernel
        # (card_run fails a run that launches one; the counts are read again here)
        before, new_walls, steps = all_launches(), {}, {}
        t0 = time.perf_counter()
        new_caps = phase_psk_path(card, tmp, new_walls)
        steps["psk"], t0 = time.perf_counter() - t0, time.perf_counter()
        new_caps["band"] = phase_channelize_path(card, tmp, new_walls)
        steps["channelize"], t0 = time.perf_counter() - t0, time.perf_counter()
        phase_viz_path(card, cap, tmp, new_walls)
        steps["the renderers"] = time.perf_counter() - t0
        if all_launches() != before:
            raise AssertionError("psk, channelize or the renderers launched a kernel of the port: they run as torch ops")
        print("  kernel launches unchanged across psk, channelize, ui and eui; " +
              ", ".join(f"{k} {v:.1f}s" for k, v in steps.items()) + " of phase 4")
        bank_launches, bank_err = phase_bank_path(card)
        launches.update(bank_launches)
        for name, count in live_launches.items():
            launches[name] += count
        t0 = time.perf_counter()
        daemon_launches = phase_daemon(card, cap, tmp, {**rx_caps, **new_caps}, find_stdin)
        print(f"  the daemon: {time.perf_counter() - t0:.1f}s of phase 4; its sessions' launches {daemon_launches}")
        for name, count in daemon_launches.items():
            launches[name] += count
        for name, count in phase_mesh_path(card, cap, tmp, new_caps["band"]).items():
            launches[name] += count
        phase_receiver_mesh(card, {**rx_caps, **new_caps}, tmp)
        for phase in (lambda: phase_daemon_mesh(card, cap, tmp, find_stdin), lambda: phase_distributed(card, tmp)):
            for name, count in phase().items():
                launches[name] += count
        phase_profiler(card, tmp)
        for name, count in phase_bench(card, tmp).items():
            launches[name] = launches.get(name, 0) + count
        print(f"  launches over the main paths (the stream runs, the live runs, the bank runs, the daemon's "
              f"sessions, the mesh runs, the daemon's mesh sessions, the distributed workers and the bench's "
              f"timed windows): {launches}")
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
        phase_cs16_readings(card)
        wf_ms = phase_waterfall_timing(card, at_main)
        t0 = time.perf_counter()
        phase_find_timing(card)
        print(f"  find's sweep and the resampler's product: {time.perf_counter() - t0:.1f}s of phase 5")
        for name in ("find", "find bank", "stages write"):
            print(f"  {name}: {CAPTURE_SAMPLES / walls[name] / 1e6:.1f} Msps of capture; a profiled run's device share "
                  f"{100 * walls[f'{name} busy'] / walls[f'{name} profiled']:.1f}% ({card})")
        t0 = time.perf_counter()
        phase_receiver_timing(card, rx_caps)
        print(f"  the receivers' dispatches and profiled runs: {time.perf_counter() - t0:.1f}s of phase 5")
        for name in ("ook", "fsk", "fm", "am", "ssb"):
            print(f"  {name}: {samples_of(name) / rx_walls[name] / 1e6:.1f} Msps of "
                  f"capture in its phase-4 card run ({card})")
        t0 = time.perf_counter()
        phase_channelize_timing(card, new_caps["band"], tmp)
        phase_psk_timing(card, new_caps)
        print(f"  the channelizer's dispatch, PSK's programs and their profiled runs: {time.perf_counter() - t0:.1f}s of phase 5")
        for name, wall in new_walls.items():
            if name.startswith(("psk", "channelize")) and " prefix" not in name and "-pre" not in name:
                n = PSK_SAMPLES if name.startswith("psk") else CAPTURE_SAMPLES
                print(f"  {name}: {wall:.3f}s, {n / wall / 1e6:.1f} Msps of capture in its phase-4 card run ({card})")
    finally:
        tmp_dir.cleanup()

    # errors at the main paths' shapes: max_abs_err, and err_over_max
    # (that over the max of the plain output; for scan, the sum error
    # per window or the max error, whichever is larger)
    # library_ms: one PyTorch call that does part of each kernel's work
    # (no single call computes these functions): conv1d over the mixed
    # planes for the frontend kernels, torch.fft.fft over the decoded
    # frames for the waterfall kernels.  The v1 kernel's bound and
    # yardstick are kernel 1's: the same chunk and FIR (its trig not counted)
    src = "quadrs_tpu_torch/csrc/frontend.cu"
    # ms and library_ms: the device's own times (device_ms); call_ms and
    # library_call_ms: back to back through the Python call (time_ms)
    conv = {"library_ms": ms["library_conv1d"], "library_call_ms": ms["call library_conv1d"],
            "library": "conv1d over the mixed planes (covers part of the work)"}
    kernels = [
        {"name": "frontend_fir", "route": "cuda", "source": src,
         "replaces": "quadrs_tpu/ops/frontend_pallas.py:409", "launches": launches["frontend_fir"],
         "ms": ms["kernel1"], "call_ms": ms["call kernel1"], "plain_ms": ms["plain"], "bound": ms["bound kernel1"], **conv},
        {"name": "frontend_fir_stft", "route": "cuda", "source": src,
         "replaces": "quadrs_tpu/ops/frontend_pallas.py:513", "launches": launches["frontend_fir_stft"],
         "ms": ms["kernel2"], "call_ms": ms["call kernel2"], "plain_ms": ms["plain_stft_epilogue"], "bound": ms["bound kernel2"], **conv},
        {"name": "frontend_banded", "route": "cuda", "source": src,
         "replaces": "quadrs_tpu/ops/frontend_pallas.py:146", "launches": launches["frontend_banded"], "path": None,
         "ms": ms["banded"], "call_ms": ms["call banded"], "plain_ms": ms["plain_banded"], "bound": ms["bound kernel1"], **conv},
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
