"""A window's output does not depend on the windows batched with it, on
the CPU, in the port as in the JAX package.  (The trailing stages' row
scans on the card are the ``cuda`` test ``-k trailing_stages`` and
``chip_smoke.py``'s ``batch_invariance``.)

Every complex product over a batch of windows or dispatches goes through
``ops/nco.rotate`` (and ``mix``), which the CPU takes in real planes:
torch's CPU complex64 ``*`` rounds its vector lanes and its scalar tail
apart, so a product's last bit would follow its flat index in the batch,
which moves with the batch's size, the row's place in it and the threads'
split of the work.  (The card's branch, the complex product, is held in
``test_torch_cuda.py`` and ``chip_smoke.py``.)

- **The executor's chains**: 200 windows of 63 outputs at stride 16 over
  seeded cs8, cu8 and cf32 bytes (and a two-tone ``gen`` root) through
  ``Executor`` at 1, 7 and 200 windows a batch, with 1 and 4 threads:
  ``shift``, ``iqbal -c``, ``shift dcblock agc`` and ``gen shift`` are
  bit-equal to each other, and equal to the JAX package's ``Executor``
  within the parity tests' tolerances (``shift`` 2e-6 as in
  ``test_torch_chain.py`` and ``gen`` 4e-6, in units of the decoded scale
  of ``test_torch_stages.py``: cu8 decodes to about -127; the stages 1e-4
  of that scale, as there).
- **The receivers' front ends**: ``PipelineModel.step_windows`` (the
  per-window mode) and an SSB ``_ChannelStep`` (its mix and channel-rate
  re-shift) dispatched as one, as 7-window and as 1-window dispatches;
  against the JAX package's ``jit_step_windows`` (5e-5 of scale) and SSB
  ``baseband`` (1e-5 of full scale).  Their FIR takes one impl at every
  batch: at these sizes the CPU's ``auto`` rule (the JAX package's, which
  picks by a batch's total outputs) is on one side of its crossover.
- **The other batched products**: the FM discriminator and the
  channelizer's phase, bit-equal at every batch.
- **The FFT-domain products**: ``fir_decimate``'s ``overlap_save`` and
  ``os_poly`` (33 taps, D 2) and ``find``'s ``XCorr`` (a 2-template bank
  over a 5-row grid), bit-equal at every batch and thread count, and
  within ``test_torch_fir.py``'s and ``test_torch_find.py``'s bounds of
  the JAX package's.  The CPU's FFT splits a lone long transform across
  threads and rounds it otherwise than one inside a batch, so every CPU
  transform call takes exactly ``ops/fir.FFT_ROWS`` rows (the last padded
  with zero rows), and the products around it take ``rotate``'s real
  planes (``ops/fir.spectral_product``).  On the card one call, which cuFFT
  plans by batch (ROADMAP, "Reference behaviour").
- **The reference**: the JAX package's ``Executor`` and
  ``jit_step_windows`` give the same windows at 7 and at 200 a batch, and
  at one a batch for ``shift``, ``iqbal -c``, ``gen shift`` and the
  stages over cs8 and cu8.  XLA compiles a batch of one apart, and for
  ``jit_step_windows`` and the stages over cf32 that program rounds
  otherwise (within the parity tolerances): the port is bit-equal there
  too.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quadrs_tpu import sources as jsources
from quadrs_tpu import stream as jstream
from quadrs_tpu.formats import FileFormat as JFormat
from quadrs_tpu.models import demod as jd
from quadrs_tpu.ops import correlate as jcorr
from quadrs_tpu.ops import fir as jfir
from quadrs_tpu.models.receiver import PipelineConfig as JConfig
from quadrs_tpu.models.receiver import PipelineModel as JModel
from quadrs_tpu.runtime import Executor as JExecutor

from quadrs_tpu_torch import sources as tsources
from quadrs_tpu_torch import stream as tstream
from quadrs_tpu_torch.formats import FileFormat
from quadrs_tpu_torch.models import demod as td
from quadrs_tpu_torch.models.receiver import PipelineConfig, PipelineModel
from quadrs_tpu_torch.ops import correlate as tcorr
from quadrs_tpu_torch.ops import fir as tfir
from quadrs_tpu_torch.ops.channelizer import channelize_block
from quadrs_tpu_torch.ops.fir import lowpass_taps
from quadrs_tpu_torch.runtime import Executor
from util import from_device_complex, to_device_complex

CPU = "cpu"
WINDOWS, N, STRIDE = 200, 63, 16
BATCHES = (1, 7, 200)
THREADS = (1, 4)
FORMATS = ["cs8", "cu8", "cf32"]
SR = 48_000
SCALE = {"cf32": 1.0, "cs8": 1.0, "cu8": 128.0}  # test_torch_stages.py's decoded scale


@contextlib.contextmanager
def threads(n: int):
    before = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(before)


def capture_bytes(fmt: str, n: int, seed: int = 11) -> np.ndarray:
    """``n`` seeded samples of ``fmt``: noise with a DC offset and a slow
    swell (test_torch_stages.py's capture)."""
    rng = np.random.default_rng(seed)
    swell = 0.2 + np.abs(np.sin(np.arange(n) * 3e-3))
    x = (rng.normal(size=n) + 1j * rng.normal(size=n)) * swell + (0.3 - 0.2j)
    if fmt == "cf32":
        return np.ascontiguousarray(x.astype(np.complex64)).view(np.uint8)
    iq = np.stack([x.real, x.imag], axis=-1) * 40
    if fmt == "cs8":
        return np.clip(np.rint(iq), -127, 127).astype(np.int8).view(np.uint8).reshape(-1)
    return np.clip(np.rint(iq + 127.5), 0, 255).astype(np.uint8).reshape(-1)


def by_batches(run, offs: np.ndarray, batch: int) -> np.ndarray:
    """``run(offsets)`` over ``offs`` in batches of ``batch``, concatenated."""
    return np.concatenate([np.asarray(run(offs[i : i + batch])) for i in range(0, len(offs), batch)])


# ------------------------------------------------------ the executor's chains


def chain(kind: str, fmt: str | None, port: bool):
    """``kind`` over ``fmt`` bytes (or a ``gen`` root) in the port or the
    JAX package, and the tolerance of its parity."""
    src_mod, stream_mod = (tsources, tstream) if port else (jsources, jstream)
    if kind == "gen shift":
        return stream_mod.Shift(src_mod.ToneGen([3000, -7000], SR, 1.0), 5000), dict(rtol=0, atol=4e-6)
    raw = capture_bytes(fmt, WINDOWS * STRIDE + N + 600)
    src = src_mod.SampleSource(raw, (FileFormat if port else JFormat)(fmt), SR)
    stage_tol = dict(rtol=1e-4, atol=1e-4 * SCALE[fmt])
    if kind == "shift":
        return stream_mod.Shift(src, 5000, SR), dict(rtol=0, atol=2e-6 * SCALE[fmt])
    if kind == "iqbal -c":
        return stream_mod.IqCorrect(src, c=0.01 - 0.02j, **({"device": CPU} if port else {})), stage_tol
    # shift dcblock -window 500 agc -window 100
    return stream_mod.Agc(stream_mod.DcBlock(stream_mod.Shift(src, 5000, SR), 500), window=100), stage_tol


CHAIN_CASES = [(k, f) for k in ("shift", "iqbal -c", "shift dcblock agc") for f in FORMATS] + [("gen shift", None)]
OFFSETS = STRIDE * np.arange(WINDOWS, dtype=np.int64)


@pytest.mark.parametrize("kind,fmt", CHAIN_CASES)
def test_executor_chain_is_batch_invariant(kind, fmt):
    stream, tol = chain(kind, fmt, port=True)
    ex = Executor(stream, N, CPU)
    runs = {}
    for t in THREADS:
        with threads(t):
            for b in BATCHES:
                runs[t, b] = by_batches(lambda o: ex.run(o)[0], OFFSETS, b)
    want = runs[1, 1]
    assert want.shape == (WINDOWS, N) and want.dtype == np.complex64
    for key, got in runs.items():
        assert got.tobytes() == want.tobytes(), (key, int(np.sum(got != want)))
    j_stream, _ = chain(kind, fmt, port=False)
    j = by_batches(lambda o: JExecutor(j_stream, N).run(o)[0], OFFSETS, WINDOWS)
    np.testing.assert_allclose(want, np.asarray(j), **tol)


# where XLA's program for a batch of one rounds otherwise than its batched one
JAX_ONE_APART = {("shift dcblock agc", "cf32")}


@pytest.mark.parametrize("kind,fmt", CHAIN_CASES)
def test_jax_executor_chain_is_batch_invariant(kind, fmt):
    """The property held above is the reference's: the JAX package's
    windows at 7 and 200 a batch are bit-equal, and at one a batch but
    where XLA's batch-of-one program rounds apart."""
    j_stream, tol = chain(kind, fmt, port=False)
    runs = {}
    for b in BATCHES:
        ex = JExecutor(j_stream, N, batch=b)
        runs[b] = by_batches(lambda o: np.asarray(ex.run(o)[0]), OFFSETS, b)
    assert runs[7].tobytes() == runs[200].tobytes(), int(np.sum(runs[7] != runs[200]))
    if (kind, fmt) in JAX_ONE_APART:
        np.testing.assert_allclose(runs[1], runs[200], **tol)
    else:
        assert runs[1].tobytes() == runs[200].tobytes(), int(np.sum(runs[1] != runs[200]))


# ------------------------------------------------------ the receivers' front ends


def models(fmt: str):
    args = dict(sample_rate=1_000_000, shift_freq=12_345, lp_freq=50_000, decimate=4, taps=41, fft_width=16)
    return JModel(JConfig(fmt=JFormat(fmt), **args)), PipelineModel(PipelineConfig(fmt=FileFormat(fmt), **args))


def step_windows_inputs(jm, fmt: str):
    w = jm.cfg.window_raw
    raw = jm.synth_raw(WINDOWS * w, seed=len(fmt)).reshape(2, WINDOWS, w).transpose(1, 0, 2).copy()
    return raw, jm.theta0(999_999_937 + 977 * np.arange(WINDOWS, dtype=np.int64))


@pytest.mark.parametrize("fmt", FORMATS)
def test_step_windows_is_batch_invariant(fmt):
    jm, tm = models(fmt)
    raw, thetas = step_windows_inputs(jm, fmt)
    rows = np.arange(WINDOWS)
    runs = {}
    for t in THREADS:
        with threads(t):
            for b in BATCHES:
                runs[t, b] = by_batches(lambda r: tm.step_windows(torch.from_numpy(raw[r]), thetas[r]).numpy(), rows, b)
    want = runs[1, 1]
    for key, got in runs.items():
        assert got.tobytes() == want.tobytes(), (key, int(np.sum(got != want)))
    j = np.asarray(jm.jit_step_windows(raw, thetas))
    np.testing.assert_allclose(want, j, rtol=0, atol=5e-5 * np.abs(j).max())


@pytest.mark.parametrize("fmt", FORMATS)
def test_jax_step_windows_is_batch_invariant(fmt):
    """The JAX package's batched windows agree bit for bit at 7 and 200 a
    batch; its batch-of-one program rounds apart, within the parity
    tolerance."""
    jm, _ = models(fmt)
    raw, thetas = step_windows_inputs(jm, fmt)
    rows = np.arange(WINDOWS)
    runs = {b: by_batches(lambda r: np.asarray(jm.jit_step_windows(raw[r], thetas[r])), rows, b) for b in BATCHES}
    assert runs[7].tobytes() == runs[200].tobytes(), int(np.sum(runs[7] != runs[200]))
    np.testing.assert_allclose(runs[1], runs[200], rtol=0, atol=5e-5 * np.abs(runs[200]).max())


def ssb_capture(fmt: str, n: int) -> np.ndarray:
    """A USB tone 1 kHz above a suppressed carrier at +20 kHz of 192 kHz,
    in noise (test_torch_audio.py's)."""
    rng = np.random.default_rng(3)
    t = np.arange(n) / 192_000
    x = 0.6 * np.exp(2j * np.pi * 21_000 * t + 1.1j) + 0.01 * (rng.normal(size=n) + 1j * rng.normal(size=n))
    if fmt == "cf32":
        return np.ascontiguousarray(x.astype(np.complex64)).view(np.uint8)
    iq = np.stack([x.real, x.imag], axis=-1) * 127
    if fmt == "cs8":
        return np.clip(np.rint(iq), -127, 127).astype(np.int8).view(np.uint8).reshape(-1)
    return np.clip(np.rint(iq + 127.5), 0, 255).astype(np.uint8).reshape(-1)


SSB = dict(center=-20_000, bandwidth=3_000, decimate=4, taps=40, chunk=N)


def ssb_dispatches(chan, windows: int | None) -> torch.Tensor:
    """The first ``WINDOWS`` windows of SSB's channel through
    ``_ChannelStep`` dispatches of at most ``windows`` windows each."""
    step = td._channel_step(chan, N, 0, torch.real, device=CPU, windows=windows)
    assert step is not None and step.k == (windows or step.k)
    outs, o = [], 0
    try:
        while sum(len(x) for x in outs) < WINDOWS:
            out, v = step(o)
            outs.append(out)
            o += step.step
    finally:
        step.close()
    return torch.cat(outs)[:WINDOWS]


@pytest.mark.parametrize("fmt", FORMATS)
def test_ssb_dispatch_is_batch_invariant(fmt):
    """One dispatch of every window, 7-window and 1-window dispatches: the
    same samples, bit for bit; the JAX package's ``baseband`` within 1e-5
    of full scale."""
    raw = ssb_capture(fmt, (WINDOWS + 2) * N * SSB["decimate"] + SSB["taps"])
    chan = td.SsbDemod(**SSB).channel(tsources.SampleSource(raw, FileFormat(fmt), 192_000))
    runs = {}
    for t in THREADS:
        with threads(t):
            for k in (None, 7, 1):
                runs[t, k] = ssb_dispatches(chan, k).numpy()
    want = runs[1, None]
    assert want.shape == (WINDOWS, N)
    for key, got in runs.items():
        assert got.tobytes() == want.tobytes(), (key, int(np.sum(got != want)))
    j = np.asarray(jd.SsbDemod(**SSB).baseband(jsources.SampleSource(raw, JFormat(fmt), 192_000))[1])
    np.testing.assert_allclose(want.reshape(-1), j[: WINDOWS * N], rtol=0, atol=1e-5)


# ------------------------------------------------------ the other batched products


def noise(shape, seed: int) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape) + 1j * rng.normal(size=shape)
    return torch.from_numpy(x.astype(np.complex64))


def fm_post(x):
    d = td.discriminate(x)
    return torch.atan2(d.imag, d.real)


PRODUCTS = {
    "fm discriminator": (lambda x: fm_post(x), 65),
    "channelizer phase": (lambda x: channelize_block(x, lowpass_taps(1 / 12, 40), 6, 24), 6 * 24 + 40),
}


@pytest.mark.parametrize("name", list(PRODUCTS))
def test_batched_product_is_batch_invariant(name):
    fn, n_in = PRODUCTS[name]
    x = noise((WINDOWS, n_in), seed=len(name))
    runs = {}
    for t in THREADS:
        with threads(t):
            for b in BATCHES:
                runs[t, b] = by_batches(lambda r: fn(x[r]).numpy(), np.arange(WINDOWS), b)
    want = runs[1, 1]
    for key, got in runs.items():
        assert got.tobytes() == want.tobytes(), (key, int(np.sum(got != want)))


# ------------------------------------------------------ the FFT-domain products


def spectral_fir(impl: str, x: np.ndarray, port: bool) -> np.ndarray:
    taps = lowpass_taps(0.1, FIR_TAPS)
    if port:
        return tfir.fir_decimate(torch.from_numpy(x), taps, FIR_D, FIR_OUT, impl=impl).numpy()
    fn = jax.jit(lambda xx: jfir.fir_decimate(xx, taps, FIR_D, FIR_OUT, impl=impl))
    return from_device_complex(fn(to_device_complex(x)))


FIR_TAPS, FIR_D, FIR_OUT = 33, 2, 1000


@pytest.mark.parametrize("impl", ["overlap_save", "os_poly"])
def test_spectral_fir_is_batch_invariant(impl):
    """The spectral FIR impls over 200 blocks at 1, 7 and 200 blocks a call
    and 1 and 4 threads: bit-equal (every CPU transform call takes
    ``FFT_ROWS`` rows; the products take real planes), and within
    ``test_torch_fir.py``'s bound of the JAX package's."""
    x = noise((WINDOWS, FIR_OUT * FIR_D + FIR_TAPS), seed=len(impl)).numpy()
    runs = {}
    for t in THREADS:
        with threads(t):
            for b in BATCHES:
                runs[t, b] = by_batches(lambda r: spectral_fir(impl, x[r], port=True), np.arange(WINDOWS), b)
    want = runs[1, 1]
    assert want.shape == (WINDOWS, FIR_OUT)
    for key, got in runs.items():
        assert got.tobytes() == want.tobytes(), (key, int(np.sum(got != want)))
    j = spectral_fir(impl, x, port=False)
    np.testing.assert_allclose(want, j, rtol=0, atol=3e-5 * max(np.abs(j).max(), 1.0))


XCORR_C = 1024


def xcorr_inputs():
    """A 2-template bank over a 5-row grid (``test_torch_find.py``'s) and
    200 windows of noise with the templates planted at random offsets."""
    rng = np.random.default_rng(8)
    pats = [noise(300, seed=81).numpy(), noise(180, seed=82).numpy()]
    x = 0.3 * noise((WINDOWS, XCORR_C), seed=83).numpy()
    for i in range(WINDOWS):
        p = pats[i % 2]
        o = int(rng.integers(0, XCORR_C - len(p)))
        x[i, o : o + len(p)] += np.complex64(0.5 * np.exp(1j * i)) * p
    return pats, np.arange(-2, 3) * 0.4 / 300, x


def test_xcorr_rows_are_batch_invariant():
    """``find``'s device program (forward FFT, the rows' products and
    inverse FFTs, the best row a lag) at 1, 7 and 200 windows a batch and 1
    and 4 threads: bit-equal; scores and scales within ``test_torch_find.py``'s
    2e-4 of the JAX package's."""
    pats, freqs, x = xcorr_inputs()
    xc = tcorr.XCorr(pats, XCORR_C, freqs)
    runs = {}
    for t in THREADS:
        with threads(t):
            for b in BATCHES:
                runs[t, b] = [by_batches(lambda r: xc.compute(torch.from_numpy(x[r]))[k].numpy(), np.arange(WINDOWS), b)
                              for k in range(3)]
    want = runs[1, 1]
    for key, got in runs.items():
        for k in range(3):
            assert got[k].tobytes() == want[k].tobytes(), (key, k, int(np.sum(got[k] != want[k])))
    j = [np.asarray(a) for a in jcorr.make_xcorr_post(pats, XCORR_C, freqs)(jnp.asarray(x))]
    np.testing.assert_allclose(want[0], j[0], rtol=0, atol=2e-4)
    np.testing.assert_allclose(want[1], j[1], rtol=0, atol=2e-4)
