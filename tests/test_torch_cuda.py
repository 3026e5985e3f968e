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
the card and on CPU tensors, held to the same bound; ``find``, the
conditioning stages and the receivers' channel step to their parity tests'
bounds."""

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


@pytest.mark.parametrize("width", [2, 8, 32, 64, 128])
def test_frontend_fir_stft_matches_plain(cuda, width):
    model, planes, bases, n_out, n_ok = inputs(FileFormat.COMPLEX_UINT8, 32, 400, width, 1 << 20, cuda, (1 << 20) - 999)
    spec, tables = model.frontend_spec, model.frontend_tables()
    before = fe.frontend_fir_stft.launches
    got = fe.fused_frontend_t(planes, bases, spec, n_out, n_valid=n_ok, stft_width=width, tables=tables)
    assert fe.frontend_fir_stft.launches == before + 1
    assert_close(got, fe.fused_frontend_t_reference(planes, bases, spec, n_out, n_ok, tables, width))


def edge_case(fmt, d, taps, n_out, device, *, offset=0, h=None):
    """(spec, planes, bases, tables factory) with the planes a view
    ``offset`` samples into their rows."""
    from quadrs_tpu_torch.ops.fir import lowpass_taps

    h = lowpass_taps(200e3 / 21e6, taps) if h is None else h
    spec = fe.FrontendSpec(fmt, 21_000_000, 280_000, d, h.tobytes())
    n = (n_out + spec.m_sub) * d + 16
    raw = torch.from_numpy(synth_planes(fmt, n, seed=d + taps + offset)).to(device)
    bases = torch.from_numpy(fe.tile_bases_t(spec, 999_999_937, n_out)).to(device)
    return spec, raw[:, offset:], bases


def run_edge(spec, planes, bases, n_out, n_ok=None, width=None):
    tables = fe.frontend_tables(spec, width, device=planes.device)
    n_ok = planes.shape[1] if n_ok is None else n_ok
    got = fe.fused_frontend_t(planes, bases, spec, n_out, n_valid=n_ok, stft_width=width, tables=tables)
    want = fe.fused_frontend_t_reference(planes, bases, spec, n_out, n_ok, tables, stft_width=width)
    assert_close(got, want)
    return got, want


@pytest.mark.parametrize("fmt", list(FileFormat))
@pytest.mark.parametrize("taps", [399, 400, 401])
def test_frontend_views_at_every_alignment(cuda, fmt, taps):
    """Planes whose base pointer sits at every offset mod 16 samples."""
    for offset in range(16):
        run_edge(*edge_case(fmt, 32, taps, 2048 + 24, cuda, offset=offset), 2048 + 24)
    run_edge(*edge_case(fmt, 32, taps, 4096, cuda, offset=taps - taps // 2), 4096, width=64)


@pytest.mark.parametrize("fmt", list(FileFormat))
def test_frontend_mask_edges(cuda, fmt):
    """``n_ok`` inside the first block, on a block boundary, 1 below the end."""
    spec, planes, bases = edge_case(fmt, 32, 400, 4096, cuda, offset=3)
    block = fe.launch_plan(spec).bout
    for n_ok in (0, 1, 1000, 3 * block * 32, 3 * block * 32 + 2, planes.shape[1] - 1):
        run_edge(spec, planes, bases, 4096, n_ok)
        run_edge(spec, planes, bases, 4096, n_ok, width=128)


@pytest.mark.parametrize("fmt", list(FileFormat))
@pytest.mark.parametrize("d,taps,n_out", [
    (1, 13, 9001), (3, 37, 9001), (5, 61, 9001), (33, 397, 9001), (64, 769, 9001),  # D no multiple of 4; D 64
    (32, 20, 4099), (2, 2, 777),  # one subfilter
    (32, 400, 5003), (32, 400, 8292), (32, 400, 7),  # n_out no multiple of the block or of 8
    (16, 130, 4100), (8, 64, 12_000),  # one chunk, exactly full
])
def test_frontend_envelope_edges(cuda, fmt, d, taps, n_out):
    run_edge(*edge_case(fmt, d, taps, n_out, cuda), n_out)


@pytest.mark.parametrize("fmt", list(FileFormat))
def test_decode_and_mix_are_exact(cuda, fmt):
    """A single unit tap at D 1: the output is the mixed sample itself, so
    kernel and plain version agree bit for bit."""
    spec, planes, bases = edge_case(fmt, 1, 1, 70_001, cuda, offset=1, h=np.float32([1.0]))
    got, want = run_edge(spec, planes, bases, 70_001, n_ok=65_000)
    assert torch.equal(got, want)


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
        # premixed taps, a spectral FIR.  cs16 decodes to a -32767.5 DC that
        # the shift puts in the stopband, and the output is mostly its
        # residual there.  On the card auto takes overlap_save, 4.9e-5 of
        # scale from an f64 sum on this input (os_poly, which the CPU's rule
        # takes, lies 8.9e-5 off on the card and 5.4e-5 on the CPU: its cuFFT
        # frames are what widened it; chip_smoke.py phase 5 prints the
        # readings op by op).  Card against f64: the bound; CPU against f64:
        # 6e-5; card against CPU: their sum
        (FileFormat.COMPLEX_INT16, 8, 1100, 128, "auto", (1.1e-4, TOL, 6e-5)),
        (FileFormat.COMPLEX_INT8, 8, 1100, 128, "auto", TOL),
        (FileFormat.COMPLEX_INT8, 32, 400, 64, "banded", TOL),
        (FileFormat.COMPLEX_FLOAT32, 32, 400, 64, "overlap_save", TOL),
        (FileFormat.COMPLEX_INT8, 4, 40, 64, "direct", TOL),
    ],
)
def test_step_stream_matches_cpu(cuda, fmt, d, taps, width, impl, tol):
    """The chain of torch ops on the card against the same calls on CPU
    tensors, a masked tail included; both within ``tol·scale`` of an f64
    sum of the same function (``tol``: one bound, or the three of card
    against CPU, card against f64 and CPU against f64)."""
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
        tols = tol if isinstance(tol, tuple) else (tol, tol, tol)
        for (a, b), t in zip(((got, want), (got, exact), (want, exact)), tols):
            assert float(np.abs(a - b).max()) <= t * scale


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


# -- find and the conditioning stages on the card (torch ops and cuFFT) ------------


def test_find_pattern_matches_cpu(cuda, monkeypatch):
    """``find_pattern`` on the card against the CPU: a bank of three
    templates over a 5-row carrier-offset grid, planted in cs8 noise, with
    dispatches small enough that the device scan decides most and the
    full-score path takes the tail.  Offsets, which and freqs exact, scores
    and scales within 2e-4; the extract tuple's 0-dim outputs come back
    through the page-locked download as 0-dim arrays."""
    from quadrs_tpu_torch import sinks, sources
    from quadrs_tpu_torch.ops.correlate import make_xcorr_post
    from quadrs_tpu_torch.runtime import Executor

    rate, n = 2_000_000, 1 << 20
    rng = np.random.default_rng(11)
    x = rng.integers(-40, 41, (n, 2)) @ np.array([1, 1j])
    pats = [rng.integers(-60, 61, (l, 2)) @ np.array([1, 1j]) for l in (256, 180, 128)]
    step = 0.4 * rate / 256
    plants = [(5_000, 0, 1, 0.5), (30_719, 1, -2, 1.0), (400_003, 2, 0, 0.2), (n - 256, 0, 2, 1.5)]
    for o, k, row, gain in plants:
        m = np.arange(len(pats[k]))
        x[o : o + len(m)] = gain * pats[k] * np.exp(1j * (0.7 * k + 2 * np.pi * row * step * m / rate))
    raw = np.clip(np.rint(np.stack([x.real, x.imag], -1)), -127, 127).astype(np.int8).reshape(-1).view(np.uint8)
    src = sources.SampleSource(raw, FileFormat.COMPLEX_INT8, rate)
    monkeypatch.setattr(sinks, "FIND_DISPATCH_BUDGET", 1 << 15)
    res = {}
    for dev in ("cpu", cuda):
        sinks.find_pattern.dispatches.update(extract=0, overflow=0, full=0)
        res[dev] = sinks.find_pattern(src, pats, freq_tol=2 * step, device=dev)
    assert sinks.find_pattern.dispatches["extract"] > 1 and sinks.find_pattern.dispatches["full"] >= 1
    got, want = res[cuda], res["cpu"]
    assert list(want.offsets) == [o for o, *_ in plants] and list(want.which) == [k for _, k, _, _ in plants]
    assert np.allclose(want.freqs, [row * step for *_, row, _ in plants])
    for f in ("offsets", "which", "freqs"):
        assert np.array_equal(getattr(got, f), getattr(want, f))
    assert np.abs(got.scores - want.scores).max() <= 2e-4
    assert np.abs(got.scales - want.scales).max() <= 2e-4 * want.scales.max()

    post = make_xcorr_post(pats[0], 4096, extract=(0.5, 16))
    out = {dev: Executor(src, 4096, dev, batch=4, post=post, post_takes_aux=True).run(np.arange(4) * 3841, aux=-np.inf)[0]
           for dev in ("cpu", cuda)}
    assert [a.shape for a in out[cuda]] == [a.shape for a in out["cpu"]] == [(16,)] * 4 + [()] * 6
    assert int(out[cuda][4]) == int(out["cpu"][4])


@pytest.mark.parametrize("fmt", [FileFormat.COMPLEX_INT8, FileFormat.COMPLEX_UINT8])
def test_stages_match_cpu(cuda, fmt):
    """The conditioning stages on the card against the CPU at random
    offsets: ``iqbal dcblock agc resample 147/160`` within 1e-5 of the
    output's scale in units of the decoded magnitude (cu8 decodes to
    ``x/255 - 127.5``, so its f32 sums round at 128's ulp: 1.3e-4 of the
    output's scale apart on an H100, where cs8 keeps within 1e-5), and the
    resampler in full f32 even when the caller left TF32 on (it is reached
    outside the CLI here)."""
    from quadrs_tpu_torch import sources, stream
    from quadrs_tpu_torch.runtime import Executor

    raw = np.ascontiguousarray(synth_planes(fmt, 300_000, seed=4).T).reshape(-1).view(np.uint8)
    src = sources.SampleSource(raw, fmt, 21_000_000)

    def chain(dev):
        return stream.Resample(stream.Agc(stream.DcBlock(stream.IqCorrect(src, device=dev), 300), window=64), 147, 160)

    offs = np.sort(np.random.default_rng(2).integers(0, chain("cpu").length, 64))
    want, valid = Executor(chain("cpu"), 0x1000, "cpu").run(offs)
    torch.backends.cuda.matmul.allow_tf32 = True
    got, valid_card = Executor(chain(cuda), 0x1000, cuda).run(offs)
    assert not torch.backends.cuda.matmul.allow_tf32
    assert np.array_equal(valid, valid_card) and np.isfinite(got).all()
    magnitude = 128.0 if fmt is FileFormat.COMPLEX_UINT8 else 1.0
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * magnitude * np.abs(want).max())


# -- the receivers' channel step on the card (torch ops and cuFFT) ---------------


@pytest.mark.parametrize("kind", ["fm", "fsk"])
def test_channel_step_matches_cpu(cuda, kind, tmp_path):
    """The receivers' streaming front end on the card against the CPU, at the
    smoke run's FM shape (2.4 Msps cu8 read from a file through the pinned
    ring, station at +500 kHz, lowpass 100k, D 8, 400 taps, 1 kHz at 75 kHz
    deviation, audio to 48 kHz) and its FSK shape (21 Msps cs8, shift 280k,
    lowpass 200k, D 32, 400 taps, width 64).  FM audio within 1e-5 of full
    scale; FSK digits equal but at near-ties of the two half sums (within
    1e-5 of the larger on the CPU's own sums)."""
    from quadrs_tpu_torch import sources
    from quadrs_tpu_torch.models import demod
    from quadrs_tpu_torch.ops.stft import stft_norms
    from quadrs_tpu_torch.runtime import Executor

    rng = np.random.default_rng(6)
    n = 1 << 20
    if kind == "fm":
        t = np.arange(n) / 2_400_000
        x = np.exp(1j * (2 * np.pi * 500_000 * t + 75 * np.sin(2 * np.pi * 1000 * t)))
        x = x + 0.05 * (rng.normal(size=n) + 1j * rng.normal(size=n))
        iq = np.stack([x.real, x.imag], -1) * 127.5 + 127.5
        path = tmp_path / "fm.sr2400k.cu8"
        np.clip(np.rint(iq), 0, 255).astype(np.uint8).tofile(path)
        src = sources.open_capture(str(path))
        fm = demod.FmDemod(center=-500_000, bandwidth=100_000, decimate=8, taps=400, audio_rate=48_000)
        (rate, got), (_, want) = fm.demodulate(src, device=cuda), fm.demodulate(src, device="cpu")
        assert rate == 48_000 and got.shape == want.shape and np.isfinite(got).all()
        assert float(np.abs(got - want).max()) <= 1e-5
        return
    x = 0.3 * np.exp(-2j * np.pi * 230_000 * np.arange(n) / 21_000_000) + 0.3 * (rng.normal(size=n) + 1j * rng.normal(size=n))
    raw = np.clip(np.rint(np.stack([x.real, x.imag], -1) * 127), -127, 127).astype(np.int8).reshape(-1).view(np.uint8)
    src = sources.SampleSource(raw, FileFormat.COMPLEX_INT8, 21_000_000)
    fsk = demod.FskDemod(center=280_000)
    got, want = np.asarray(fsk.symbols(src, device=cuda)), np.asarray(fsk.symbols(src, device="cpu"))
    assert got.shape == want.shape and len(got) > 400
    bad = np.flatnonzero(got != want)

    def halves(z):
        norms = stft_norms(z, shift=False)
        return norms[:, :32].sum(1), norms[:, 32:].sum(1)

    if len(bad):
        first, second = Executor(fsk.channel(src), 64, "cpu", post=halves).run(bad * 64)[0]
        assert (np.abs(first - second) <= 1e-5 * np.maximum(first, second)).all()


# -- the staging rings on the card ------------------------------------------------


def write_raw(tmp_path, fmt: FileFormat, n: int, seed: int):
    planes = synth_planes(fmt, n, seed)
    raw = np.ascontiguousarray(planes.T).reshape(-1).view(np.uint8)
    path = tmp_path / f"cap{seed}.sr21M.{fmt.value}"
    path.write_bytes(raw.tobytes())
    return str(path), raw


def collect(run, **kw):
    rows = []
    stats = run(lambda w0, out: rows.append((w0, out)), **kw)
    return rows, stats


def assert_same_rows(got, want):
    assert len(got) == len(want) > 1
    for (gw, g), (ww, w) in zip(got, want):
        assert gw == ww
        for a, b in zip(g if isinstance(g, tuple) else (g,), w if isinstance(w, tuple) else (w,)):
            assert a.shape == b.shape and a.tobytes() == b.tobytes()


# a short last chunk after full ones: a reused page-locked slot's stale tail
# must be zeroed (the model masks zero bytes in the decoded domain, not stale ones)
@pytest.mark.parametrize("fmt,d,taps", [
    (FileFormat.COMPLEX_UINT8, 32, 400), (FileFormat.COMPLEX_INT16, 32, 400),
    (FileFormat.COMPLEX_INT8, 100, 400),  # outside the fused envelope: the chain of torch ops
])
def test_stream_through_the_pinned_ring_equals_the_in_memory_route(cuda, fmt, d, taps, tmp_path):
    """A file read by the loader's ring prefetcher into page-locked slots
    and copied on the copy stream, against the same bytes staged from
    memory, against a pipe, and run twice over the same ring: rows, peaks
    and survey bit for bit."""
    import io

    from quadrs_tpu_torch.sources import PipeSource, SampleSource, open_capture
    from quadrs_tpu_torch.stream_runner import StreamRunner

    win = d * 64
    n = 7 * 40 * win + 3 * win + 77  # eight chunks of 40 windows, the last one short
    path, raw = write_raw(tmp_path, fmt, n, seed=d)
    model = PipelineModel(PipelineConfig(sample_rate=21_000_000, shift_freq=280_000, lp_freq=200_000,
                                         decimate=d, taps=taps, fft_width=64, fmt=fmt))

    def runner(src):
        return StreamRunner(src, model, cuda, chunk_samples=40 * win)

    def mem():
        return SampleSource(raw, fmt, 21_000_000)

    file_src = open_capture(path)
    assert file_src.native is not None
    want, want_stats = collect(runner(mem()).run)
    assert len(want) == 8 and want[-1][1].shape[0] == 3
    r = runner(file_src)
    for _ in range(2):
        got, stats = collect(r.run)
        assert_same_rows(got, want)
        assert (stats.samples_in, stats.windows_out) == (want_stats.samples_in, want_stats.windows_out)
    piped, _ = collect(runner(PipeSource(io.BytesIO(raw.tobytes()), fmt, 21_000_000)).run)
    assert_same_rows(piped, want)
    assert_same_rows(collect(r.run_search)[0], collect(runner(mem()).run_search)[0])
    assert_same_rows(collect(runner(PipeSource(io.BytesIO(raw.tobytes()), fmt, 21_000_000)).run_search)[0],
                     collect(runner(mem()).run_search)[0])
    scan, mem_scan = r.run_scan(3.0), runner(mem()).run_scan(3.0)
    assert scan.windows == mem_scan.windows
    assert scan.sum_norms.tobytes() == mem_scan.sum_norms.tobytes() and scan.above.tobytes() == mem_scan.above.tobytes()
    tail, _ = collect(r.run, start_window=80, max_chunks=2)
    assert_same_rows(tail, want[2:4])
    # against the CPU device: the same route, within the chain's tolerance
    cpu_rows, _ = collect(StreamRunner(mem(), model, "cpu", chunk_samples=40 * win).run)
    model.to(cuda)
    a, b = np.concatenate([x for _, x in want]), np.concatenate([x for _, x in cpu_rows])
    assert float(np.abs(a - b).max()) <= (2e-4 if fmt is FileFormat.COMPLEX_INT16 else TOL) * float(b.max())


@pytest.mark.parametrize("fmt,stride", [(FileFormat.COMPLEX_INT8, 1024), (FileFormat.COMPLEX_UINT8, 256), (FileFormat.COMPLEX_INT16, 1500)])
def test_bank_through_the_pinned_ring_equals_the_in_memory_route(cuda, fmt, stride, tmp_path):
    """Eight files read row by row into one page-locked slot a chunk, and a
    one-stream bank from a pipe, against the same bytes staged from memory."""
    import io

    from quadrs_tpu_torch.models.waterfall import WaterfallConfig, WaterfallModel
    from quadrs_tpu_torch.sources import PipeSource, SampleSource, open_capture
    from quadrs_tpu_torch.stream_runner import WaterfallRunner

    n = 1024 + 230 * stride + 5  # three chunks of 100 windows, the last one of 31
    files = [write_raw(tmp_path, fmt, n, seed=s) for s in range(8)]
    model = WaterfallModel(WaterfallConfig(n_streams=8, fft_width=1024, stride=stride, fmt=fmt))

    def runner(sources, m=model):
        return WaterfallRunner(sources, m, cuda, chunk_windows=100)

    disk = [open_capture(p) for p, _ in files]

    def mem():
        return [SampleSource(raw, fmt, 21_000_000) for _, raw in files]

    want, want_stats = collect(runner(mem()).run)
    assert len(want) == 3 and want[-1][1].shape[1] == 31
    r = runner(disk)
    for _ in range(2):
        got, stats = collect(r.run)
        assert_same_rows(got, want)
        assert (stats.samples_in, stats.windows_out) == (want_stats.samples_in, want_stats.windows_out)
    assert_same_rows(collect(r.run_search)[0], collect(runner(mem()).run_search)[0])
    scan, mem_scan = r.run_scan(5.0), runner(mem()).run_scan(5.0)
    assert scan.sum_norms.tobytes() == mem_scan.sum_norms.tobytes() and scan.above.tobytes() == mem_scan.above.tobytes()

    one = WaterfallModel(WaterfallConfig(n_streams=1, fft_width=1024, stride=stride, fmt=fmt))
    raw = files[0][1]
    want1, _ = collect(runner([SampleSource(raw, fmt, 21_000_000)], one).run)
    got1, _ = collect(runner([PipeSource(io.BytesIO(raw.tobytes()), fmt, 21_000_000)], one).run)
    assert_same_rows(got1, want1)


def test_outputs_are_the_callbacks_to_keep(cuda, tmp_path):
    """Every chunk's output is page-locked memory of its own: rows a
    callback keeps stay valid while slots and buffers are reused."""
    from quadrs_tpu_torch.sources import open_capture
    from quadrs_tpu_torch.stream_runner import StreamRunner

    fmt, win = FileFormat.COMPLEX_INT8, 32 * 64
    path, _ = write_raw(tmp_path, fmt, 64 * 10 * win, seed=3)
    model = PipelineModel(PipelineConfig(sample_rate=21_000_000, shift_freq=280_000, lp_freq=200_000,
                                         decimate=32, taps=400, fft_width=64, fmt=fmt))
    runner = StreamRunner(open_capture(path), model, cuda, chunk_samples=10 * win)
    kept, _ = collect(runner.run)
    copies = [r.copy() for _, r in kept]
    assert len(kept) == 64
    collect(runner.run)
    collect(runner.run_search)
    assert all(a.tobytes() == b.tobytes() for (_, a), b in zip(kept, copies))


@pytest.mark.parametrize("fmt,k,size", [(FileFormat.COMPLEX_INT8, 64, 1024), (FileFormat.COMPLEX_UINT8, 8, 40), (FileFormat.COMPLEX_FLOAT32, 7, 50)])
def test_channelize_matches_cpu(cuda, fmt, k, size):
    """The channelizer's device program (branch sums, cuFFT over K, the
    centre phase) on the card against the CPU, within ``2e-6`` of the
    block's scale (the JAX parity bound), chunk by chunk through the
    Executor and its ``(B, K, n)`` outputs."""
    from quadrs_tpu_torch.models.channelizer import Channelize, run_channelize
    from quadrs_tpu_torch.sources import SampleSource

    raw = synth_planes(fmt, 300_000, seed=k).T.reshape(-1).view(np.uint8)
    src = SampleSource(np.ascontiguousarray(raw), fmt, 21_000_000)
    chan = Channelize(src, k, size=size)
    got = list(run_channelize(chan, device=cuda, chunk=2000))
    want = list(run_channelize(chan, device="cpu", chunk=2000))
    assert [(p.start, p.data.shape) for p in got] == [(p.start, p.data.shape) for p in want]
    scale = max(float(np.abs(p.data).max()) for p in want)
    assert max(float(np.abs(p.data - q.data).max()) for p, q in zip(got, want)) <= 2e-6 * scale


def test_psk_programs_match_cpu(cuda):
    """PSK's two device programs on the card against the CPU: the peak's
    ``k0`` equal and its powers within 1e-5, the sums within 1e-5; ``z``
    within ``8 * log2(npad) * eps * max|c| / mf_len``: the card's ``cumsum``
    is an f32 scan of depth log2(n) whose partial sums stay within twice the
    largest prefix ``max|c|`` (the CPU's accumulates in double); then a
    whole burst's bits."""
    import math

    from quadrs_tpu_torch.models import demod

    rng = np.random.default_rng(8)
    n, npad, sps, order = 200_000, 1 << 18, 16.0, 2
    sym = np.repeat(np.exp(1j * np.pi * np.cumsum(rng.integers(0, 2, n // 16 + 1))), 16)[:n]
    x = (sym * np.exp(2j * np.pi * 0.0031 * np.arange(n)) + 0.05 * rng.standard_normal(n)).astype(np.complex64)
    planes, _ = demod._padded_planes(x)
    got = demod.psk_peak(torch.from_numpy(planes).to(cuda), n, order).cpu().numpy()
    want = demod.psk_peak(torch.from_numpy(planes), n, order).numpy()
    assert got[0] == want[0] and np.allclose(got[1:], want[1:], rtol=1e-5)
    psk = demod.PskDemod(bandwidth=20_000, decimate=1, taps=64, symbol_rate=8_000.0)
    rot, tim = demod.psk_tables(psk._peak_khat(planes, n, npad, "cpu"), npad, order, sps)
    args = [torch.from_numpy(a) for a in (planes, rot, tim)]
    z, se = demod.psk_process(*(a.to(cuda) for a in args), n, order, 16)
    z_cpu, se_cpu = demod.psk_process(*args, n, order, 16)
    c = np.abs(np.cumsum((planes[0] + 1j * planes[1]).astype(np.complex128) * (rot[0] + 1j * rot[1]))).max()
    tol = 8 * math.log2(npad) * float(np.finfo(np.float32).eps) * c / 16
    assert float((z.cpu() - z_cpu).abs().max()) <= tol
    assert np.allclose(se.cpu().numpy(), se_cpu.numpy(), rtol=1e-5, atol=1e-5 * float(np.abs(se_cpu.numpy()).max()))
    rate = 128_000
    assert psk.slice(psk.analyze(rate, x, device=cuda)[1]) == psk.slice(psk.analyze(rate, x, device="cpu")[1])


def test_take_fft_matches_cpu(cuda):
    """``take_fft`` (eui's GUI defaults: 2048 Blackman-Harris windows of 512
    over a slice) on the card against the CPU, within ``1e-5 * max``."""
    from quadrs_tpu_torch import sinks
    from quadrs_tpu_torch.sources import SampleSource

    raw = synth_planes(FileFormat.COMPLEX_INT8, 1 << 20, seed=3).T.reshape(-1).view(np.uint8)
    src = SampleSource(np.ascontiguousarray(raw), FileFormat.COMPLEX_INT8, 2_000_000)
    got = sinks.take_fft(src, (400_000, 900_000), 512, 2048, device=cuda)
    want = sinks.take_fft(src, (400_000, 900_000), 512, 2048, device="cpu")
    assert got.norms.shape == want.norms.shape == (2048, 512)
    assert float(np.abs(got.norms - want.norms).max()) <= 1e-5 * want.max()
