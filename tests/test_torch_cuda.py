"""The CUDA kernels against their plain PyTorch versions on the card.

Marked ``cuda``: each test asks for the ``cuda`` fixture, which skips
where ``torch.cuda.is_available()`` is false (the CPU lanes).  On a
machine with a card and ``nvcc``, run them with
``python -m pytest --noconftest tests/test_torch_cuda.py`` (the
conftest imports jax, which such a machine need not have); the first
test builds the kernels.  Frontend tolerance ``5e-5 * scale``, the JAX
package's kernel-versus-chain bound; waterfall tolerances the JAX
package's waterfall ones (``tests/test_waterfall_pallas.py``).  The
chain of torch ops (``step_stream``, the reference chain's sinks) runs on
the card and on CPU tensors, held to the same bound."""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from quadrs_tpu_torch.formats import FileFormat, synth_planes  # noqa: E402
from quadrs_tpu_torch.models.receiver import PipelineConfig, PipelineModel  # noqa: E402
from quadrs_tpu_torch.ops import frontend as fe  # noqa: E402
from quadrs_tpu_torch.ops import waterfall as wf  # noqa: E402

pytestmark = pytest.mark.cuda
TOL = 5e-5


@pytest.fixture
def cuda() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def inputs(fmt, d, taps, width, n, device, n_valid=None, offset=0):
    model = PipelineModel(
        PipelineConfig(
            sample_rate=21_000_000, shift_freq=280_000, lp_freq=200_000,
            decimate=d, taps=taps, fft_width=width, fmt=fmt,
        )
    ).to(device)
    raw = torch.from_numpy(synth_planes(fmt, n, seed=d + taps)).to(device)
    bases = torch.from_numpy(model.stream_bases(offset, n)).to(device)
    prefix = taps - taps // 2
    n_out = (n - taps) // d // width * width
    n_ok = n - prefix if n_valid is None else n_valid - prefix
    return model, raw[:, prefix:], bases, n_out, n_ok


def assert_close(got, want):
    torch.cuda.synchronize()
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    scale = max(float(want.abs().max()), 1e-6)
    assert float((got - want).abs().max()) <= TOL * scale


@pytest.mark.parametrize("fmt", list(FileFormat))
@pytest.mark.parametrize(
    "d,taps,n,n_valid,offset",
    [
        (32, 400, 1 << 20, None, 0),
        (3, 40, 1 << 18, None, 999_999_937),
        (64, 8192, 1 << 20, None, 0),
        (32, 4000, 1 << 20, (1 << 20) - 77_777, 0),
    ],
)
def test_frontend_fir_matches_plain(cuda, fmt, d, taps, n, n_valid, offset):
    model, planes, bases, n_out, n_ok = inputs(fmt, d, taps, 64, n, cuda, n_valid, offset)
    spec, tables = model.frontend_spec, model.frontend_tables()
    before = fe.frontend_fir.launches
    got = fe.fused_frontend_t(planes, bases, spec, n_out, n_valid=n_ok, tables=tables)
    assert fe.frontend_fir.launches == before + 1
    assert_close(got, fe.fused_frontend_t_reference(planes, bases, spec, n_out, n_ok, tables))


@pytest.mark.parametrize("width", [8, 32, 64, 128])
def test_frontend_fir_stft_matches_plain(cuda, width):
    model, planes, bases, n_out, n_ok = inputs(FileFormat.COMPLEX_UINT8, 32, 400, width, 1 << 20, cuda, (1 << 20) - 999)
    spec, tables = model.frontend_spec, model.frontend_tables()
    before = fe.frontend_fir_stft.launches
    got = fe.fused_frontend_t(planes, bases, spec, n_out, n_valid=n_ok, stft_width=width, tables=tables)
    assert fe.frontend_fir_stft.launches == before + 1
    assert_close(got, fe.fused_frontend_t_reference(planes, bases, spec, n_out, n_ok, tables, width))


def test_wrapper_checks_inputs(cuda):
    model, planes, bases, n_out, n_ok = inputs(FileFormat.COMPLEX_INT8, 32, 400, 64, 1 << 18, cuda)
    spec, tables = model.frontend_spec, model.frontend_tables()
    with pytest.raises(ValueError, match="must be torch.int8"):
        fe.frontend_fir(planes.to(torch.int16), bases, tables, spec, n_out, n_ok)
    with pytest.raises(ValueError, match="bases"):
        fe.frontend_fir(planes, bases[:-1], tables, spec, n_out, n_ok)
    with pytest.raises(ValueError, match="bases"):
        fe.frontend_fir(planes, bases.cpu(), tables, spec, n_out, n_ok)
    with pytest.raises(ValueError, match="unit stride"):
        fe.frontend_fir(planes.t().contiguous().t(), bases, tables, spec, n_out, n_ok)
    launches = fe.frontend_fir.launches, fe.frontend_fir_stft.launches
    for bad in (planes.shape[1] + 1, -1):
        with pytest.raises(ValueError, match="n_ok"):
            fe.frontend_fir(planes, bases, tables, spec, n_out, bad)
        with pytest.raises(ValueError, match="n_ok"):
            fe.frontend_fir_stft(planes, bases, tables, spec, n_out, bad, 64)
    assert (fe.frontend_fir.launches, fe.frontend_fir_stft.launches) == launches


def staged_view(fmt, n, streams, seed, view, device):
    """(S, 2, n) planes on ``device``: contiguous; ``sliced``, a view
    starting 3 samples into its rows (a base pointer off every 16-byte
    boundary); or ``padded``, a view of rows of odd length (stream and
    plane strides no multiple of 16 bytes)."""
    extra = {"contiguous": 0, "sliced": 3, "padded": 5 + (n + 5) % 2 + 1}[view]
    raw = torch.from_numpy(synth_planes(fmt, n + extra, seed=seed, n_streams=streams)).to(device)
    return raw[:, :, 3:] if view == "sliced" else raw[:, :, :n]


@pytest.mark.parametrize("fmt", list(FileFormat))
@pytest.mark.parametrize(
    "width,stride,windowing,streams,nw,view",
    [
        (256, 256, "rectangular", 5, 301, "contiguous"),
        (384, 96, "blackman-harris", 3, 203, "contiguous"),
        (1024, 256, "rectangular", 8, 77, "contiguous"),
        (2048, 2348, "blackman-harris", 2, 19, "contiguous"),
        (8192, 2048, "rectangular", 2, 7, "contiguous"),
        # hop 1; hop 1023 from a sliced view; width 640 (b = 5) over rows of
        # odd length; 8192 at stride 1; window counts no multiple of the
        # block's tile (16, 4, 6, 1 and 10 windows)
        (256, 1, "rectangular", 3, 517, "contiguous"),
        (1024, 1023, "blackman-harris", 3, 41, "sliced"),
        (640, 200, "rectangular", 3, 83, "padded"),
        (8192, 1, "rectangular", 2, 33, "sliced"),
        (384, 384, "blackman-harris", 5, 97, "padded"),
    ],
)
def test_waterfall_kernels_match_plain(cuda, fmt, width, stride, windowing, streams, nw, view):
    spec = wf.WaterfallSpec(fmt, width, windowing)
    planes = staged_view(fmt, (nw - 1) * stride + width + 5, streams, width, view, cuda)
    tables = wf.waterfall_tables(spec, device=cuda)
    want = wf.fused_waterfall_reference(planes, spec, nw, stride=stride)
    peak = float(want.max())
    counts = wf.waterfall_norms.launches, wf.waterfall_search.launches, wf.waterfall_scan.launches

    got = wf.fused_waterfall(planes, spec, nw, stride=stride, tables=tables)
    torch.cuda.synchronize()
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5 * peak)

    idx, val = wf.fused_waterfall_search(planes, spec, nw, stride=stride, tables=tables)
    top = want.amax(-1)
    picked = torch.gather(want, -1, idx.long()[..., None])[..., 0]
    same = idx == want.argmax(-1)
    assert bool((same | ((picked - top).abs() <= 2e-5 * top)).all())
    torch.testing.assert_close(val, top, rtol=2e-5, atol=0)

    thr = float(want.median())
    s, mx, cnt = wf.fused_waterfall_scan(planes, spec, nw, thr, stride=stride, tables=tables)
    torch.testing.assert_close(s.double(), want.double().sum(1), rtol=0, atol=nw * 2e-5 * peak)
    torch.testing.assert_close(mx, want.amax(1), rtol=0, atol=2e-5 * peak)
    lo, hi = (want > thr + 2e-5 * peak).sum(1), (want > thr - 2e-5 * peak).sum(1)
    assert bool(((cnt >= lo) & (cnt <= hi)).all())
    again = wf.fused_waterfall_scan(planes, spec, nw, thr, stride=stride, tables=tables)
    assert all(torch.equal(a, b) for a, b in zip(again, (s, mx, cnt)))  # no atomics: it repeats
    after = wf.waterfall_norms.launches, wf.waterfall_search.launches, wf.waterfall_scan.launches
    assert after == (counts[0] + 1, counts[1] + 1, counts[2] + 2)


def test_waterfall_search_nan_and_ties(cuda):
    raw = torch.zeros((2, 2, 5 * 256), dtype=torch.float32)
    raw[0, 0, 256] = 1.0  # a delta: every bin exactly 1, the lowest wins
    raw[1, 0, 3 * 256 + 17] = float("nan")
    spec = wf.WaterfallSpec(FileFormat.COMPLEX_FLOAT32, 256)
    idx, val = wf.fused_waterfall_search(raw.to(cuda), spec, 5)
    r_idx, r_val = wf.fused_waterfall_search(raw, spec, 5)
    assert torch.equal(idx.cpu(), r_idx) and idx[1, 3] == 255 and bool(torch.isnan(val[1, 3]))
    torch.testing.assert_close(val.cpu(), r_val, equal_nan=True)


def test_waterfall_wrappers_check_inputs(cuda):
    spec = wf.WaterfallSpec(FileFormat.COMPLEX_INT8, 256, "blackman-harris")
    planes = torch.zeros((2, 2, 4 * 256), dtype=torch.int8, device=cuda)
    tables = wf.waterfall_tables(spec, device=cuda)
    counts = wf.waterfall_norms.launches, wf.waterfall_search.launches, wf.waterfall_scan.launches
    bad = [
        ((planes.to(torch.int16), tables, spec, 4, 256), "must be torch.int8"),
        ((planes[:, :, ::2], tables, spec, 1, 256), "unit stride"),
        ((planes, tables, spec, 5, 256), "need 1280 samples"),
        ((planes, tables, spec, 0, 256), "n_windows"),
        ((planes, tables, spec, 2, 0), "stride"),
        ((planes, wf.WaterfallTables(tables.twiddles, None, tables.decode), spec, 4, 256), "window"),
        ((planes, wf.WaterfallTables(tables.twiddles.cpu(), tables.window, tables.decode), spec, 4, 256), "twiddles"),
        ((planes, wf.WaterfallTables(tables.twiddles, tables.window, None), spec, 4, 256), "decode"),
        ((planes, wf.WaterfallTables(tables.twiddles, tables.window, tables.decode[:128]), spec, 4, 256), "decode"),
        ((planes, tables, wf.WaterfallSpec(FileFormat.COMPLEX_INT8, 384, "blackman-harris"), 1, 256), "twiddles"),
        ((planes, tables, wf.WaterfallSpec(FileFormat.COMPLEX_INT8, 128), 1, 128), "128\\*b"),
    ]
    for args, match in bad:
        for kernel in (wf.waterfall_norms, wf.waterfall_search):
            with pytest.raises(ValueError, match=match):
                kernel(*args)
        with pytest.raises(ValueError, match=match):
            wf.waterfall_scan(*args, 1.0)
    assert (wf.waterfall_norms.launches, wf.waterfall_search.launches, wf.waterfall_scan.launches) == counts


def banded_case(fmt, d, taps, n_out, frac, start, device):
    from quadrs_tpu_torch.ops.fir import lowpass_taps

    spec = fe.FrontendSpec(fmt, 21_000_000, 280_000, d, lowpass_taps(200e3 / 21e6, taps).tobytes())
    planes = torch.from_numpy(synth_planes(fmt, int((n_out * d + taps) * frac), seed=d + taps)).to(device)
    bases = torch.from_numpy(fe.tile_bases(spec, start, -(-n_out // 2048))).to(device)
    return spec, planes, bases


@pytest.mark.parametrize("fmt", list(FileFormat))
@pytest.mark.parametrize("d", [1, 4, 8, 32, 64])
@pytest.mark.parametrize("taps", [40, 400])
def test_frontend_banded_matches_plain(cuda, fmt, d, taps):
    """The v1 kernel: 5000 outputs (the last 2048-output tile partial);
    raw planes shorter than the tiles need at D 4 and 64; an absolute
    offset near 1e9 at D 8."""
    frac = 0.6 if d in (4, 64) else 1.0
    start = 999_999_937 if d == 8 else 0
    spec, planes, bases = banded_case(fmt, d, taps, 5000, frac, start, cuda)
    before = fe.frontend_banded.launches
    got = fe.fused_frontend(planes, bases, spec, 5000)
    assert fe.frontend_banded.launches == before + 1
    assert_close(got, fe.fused_frontend_reference(planes, bases, spec, 5000))


def test_frontend_banded_checks_inputs(cuda):
    spec, planes, bases = banded_case(FileFormat.COMPLEX_INT8, 32, 400, 3000, 1.0, 0, cuda)
    tables = fe.banded_tables(spec, device=cuda)
    before = fe.frontend_banded.launches
    bad = [
        ((planes.to(torch.int16), bases, tables, spec, 3000), "must be torch.int8"),
        ((planes, bases[:-1], tables, spec, 3000), "bases"),
        ((planes, bases.cpu(), tables, spec, 3000), "bases"),
        ((planes.t().contiguous().t(), bases, tables, spec, 3000), "unit stride"),
        ((planes, bases, fe.BandedTables(tables.taps[:-1], tables.delta), spec, 3000), "taps"),
    ]
    for args, match in bad:
        with pytest.raises(ValueError, match=match):
            fe.frontend_banded(*args)
    assert fe.frontend_banded.launches == before


def chain_model(fmt, d, taps, width, impl="auto"):
    return PipelineModel(
        PipelineConfig(
            sample_rate=21_000_000, shift_freq=280_000, lp_freq=200_000,
            decimate=d, taps=taps, fft_width=width, fmt=fmt, fir_impl=impl,
        )
    )


def step_stream_f64(cfg, raw, offset, valid):
    """``step_stream``'s function summed in f64 on the host: the f32
    decode, then the exact NCO angles, the FIR and the DFT in f64."""
    from quadrs_tpu_torch.formats import decode_plane
    from quadrs_tpu_torch.ops.fir import lowpass_taps
    from quadrs_tpu_torch.ops.nco import ExactNCO

    n = raw.shape[-1]
    x = decode_plane(raw[0], cfg.fmt).astype(np.float64) + 1j * decode_plane(raw[1], cfg.fmt).astype(np.float64)
    if valid is not None:
        x[valid:] = 0
    x *= np.exp(1j * ExactNCO(cfg.shift_freq, cfg.sample_rate).angles(offset + np.arange(n), dtype=np.float64))
    h = lowpass_taps(cfg.lp_freq / cfg.sample_rate, cfg.taps).astype(np.float64)
    prefix = cfg.taps - cfg.taps // 2  # the group delay fir_decimate drops
    n_dec = (n - cfg.taps) // cfg.decimate
    n_windows = n_dec // cfg.fft_width
    xp = np.concatenate([x[prefix:], np.zeros(cfg.taps + cfg.decimate)])
    y = np.lib.stride_tricks.sliding_window_view(xp, cfg.taps)[: n_dec * cfg.decimate : cfg.decimate] @ h
    spec = np.fft.fft(y[: n_windows * cfg.fft_width].reshape(n_windows, cfg.fft_width), axis=-1)
    return np.abs(np.fft.fftshift(spec, axes=-1))


@pytest.mark.parametrize(
    "fmt,d,taps,width,impl,tol",
    [
        (FileFormat.COMPLEX_UINT8, 100, 400, 64, "auto", TOL),  # outside the fused envelope
        # premixed taps, os_poly.  cs16 decodes to a -32767.5 DC that the
        # shift puts in the stopband, and the output is mostly its residual
        # there: JAX's XLA chain, the CPU's and the card's lie 4.6e-5,
        # 5.4e-5 and 8.9e-5 of scale from an f64 sum on this input, card
        # and CPU 8.3e-5 apart (PERF.md)
        (FileFormat.COMPLEX_INT16, 8, 1100, 128, "auto", 2e-4),
        (FileFormat.COMPLEX_INT8, 8, 1100, 128, "auto", TOL),
        (FileFormat.COMPLEX_INT8, 32, 400, 64, "banded", TOL),
        (FileFormat.COMPLEX_FLOAT32, 32, 400, 64, "overlap_save", TOL),
        (FileFormat.COMPLEX_INT8, 4, 40, 64, "direct", TOL),
    ],
)
def test_step_stream_matches_cpu(cuda, fmt, d, taps, width, impl, tol):
    """The chain of torch ops on the card against the same calls on CPU
    tensors, a masked tail included; both within ``tol·scale`` of an f64
    sum of the same function."""
    model = chain_model(fmt, d, taps, width, impl)
    n = d * width * 50 + taps + 777
    raw = synth_planes(fmt, n, seed=d)
    offset = 999_999_937
    theta0 = model.theta0(np.asarray([offset]))[0]
    for valid in (None, n - 5 * d * width):
        want = model.step_stream(torch.from_numpy(raw), theta0, valid)
        got = model.to(cuda).step_stream(torch.from_numpy(raw).to(cuda), theta0, valid)
        torch.cuda.synchronize()
        model.cpu()
        exact = step_stream_f64(model.cfg, raw, offset, valid)
        scale = float(exact.max())
        assert got.shape == want.shape == exact.shape and bool(torch.isfinite(got).all())
        got, want = got.cpu().numpy(), want.numpy()
        for a, b in ((got, want), (got, exact), (want, exact)):
            assert float(np.abs(a - b).max()) <= tol * scale


def test_reference_chain_matches_cpu(cuda, tmp_path):
    """The reference chain's sinks on the card against the same calls on
    the CPU: spectrogram norms, bucket digits outside near-ties, written
    samples."""
    from quadrs_tpu_torch import sinks, sources, stream
    from quadrs_tpu_torch.ops.stft import stft_norms
    from quadrs_tpu_torch.runtime import Executor

    rng = np.random.default_rng(5)
    raw = rng.integers(-127, 128, 2 * 400_000).astype(np.int8).view(np.uint8)
    src = sources.SampleSource(raw, FileFormat.COMPLEX_INT8, 21_000_000)
    chain = stream.LowPass(stream.Shift(src, 280_000), 200_000, 32, 400)
    offs = np.arange(0, chain.length - 64, 16)
    norms = {dev: Executor(chain, 64, dev, post=stft_norms).run(offs) for dev in ("cpu", cuda)}
    assert list(norms["cpu"][1]) == list(norms[cuda][1])
    assert_close(torch.from_numpy(norms[cuda][0]).to(cuda), torch.from_numpy(norms["cpu"][0]).to(cuda))

    def halves(x):
        n = stft_norms(x, shift=False)
        return n[:, :64].sum(1), n[:, 64:].sum(1)

    first, second = Executor(chain, 128, "cpu", post=halves).run(np.arange((chain.length - 128) // 16) * 16)[0]
    clear = np.abs(first - second) > 1e-5 * np.maximum(first, second)  # not a near-tie
    g = np.asarray(sinks.freq_levels(chain, 128, 16, device=cuda).vals)
    c = np.asarray(sinks.freq_levels(chain, 128, 16, device="cpu").vals)
    assert len(g) == len(c) == len(clear) and clear.mean() > 0.99
    assert np.array_equal(g[clear], c[clear])

    gen = stream.LowPass(stream.Shift(sources.ToneGen([2000, -13_000], 48_000, 3.0), 1000), 4000, 4, 40)
    got = np.fromfile(sinks.do_write(gen, False, "g", directory=str(tmp_path), device=cuda), np.complex64)
    want = np.fromfile(sinks.do_write(gen, False, "c", directory=str(tmp_path), device="cpu"), np.complex64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
