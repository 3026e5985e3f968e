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
bounds.  The row scans (``csrc/rowscan.cu``) within 1e-5 of each row's sum
of |v| of their plain versions (torch's ``cumsum`` adds in another order),
and the trailing stages through them bit-equal at every batch."""

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


@pytest.mark.parametrize("chain", ["shift", "iqbal -c", "gen shift"])
def test_batched_products_are_batch_invariant(cuda, chain):
    """``ops.nco.rotate`` takes the complex product on the card, which
    computes each element alone: 200 executor windows of 63 at 1, 7 and 200
    a batch are bit-equal, and within 2e-6 of the CPU's real planes."""
    from quadrs_tpu_torch import sources, stream
    from quadrs_tpu_torch.runtime import Executor

    raw = np.ascontiguousarray(synth_planes(FileFormat.COMPLEX_INT8, 4_000, seed=6).T).reshape(-1).view(np.uint8)

    def make(dev):
        if chain == "gen shift":
            return stream.Shift(sources.ToneGen([3_000, -7_000], 48_000, 1.0), 5_000)
        src = sources.SampleSource(raw, FileFormat.COMPLEX_INT8, 48_000)
        return stream.Shift(src, 5_000) if chain == "shift" else stream.IqCorrect(src, c=0.01 - 0.02j, device=dev)

    offs = 16 * np.arange(200, dtype=np.int64)
    ex = Executor(make(cuda), 63, cuda)
    runs = {b: np.concatenate([ex.run(offs[i:i + b])[0] for i in range(0, 200, b)]) for b in (1, 7, 200)}
    assert runs[7].tobytes() == runs[1].tobytes() and runs[200].tobytes() == runs[1].tobytes()
    want = Executor(make("cpu"), 63, "cpu").run(offs)[0]
    np.testing.assert_allclose(runs[1], want, rtol=0, atol=2e-6 * np.abs(want).max())


# -- the trailing stages' row scans (csrc/rowscan.cu) --------------------------

ROWSCAN_TOL = 1e-5  # of each row's sum of |v| (a channel's, for complex64)


def rowscan_rows(b: int, n: int, dtype, device, seed: int) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, n)) + 1j * rng.normal(size=(b, n)) + (0.3 - 0.2j)
    x = x.astype(np.complex64) if dtype == torch.complex64 else x.real.astype(np.float32)
    return torch.from_numpy(x).to(device)


def rowscan_err(got: torch.Tensor, want: torch.Tensor, v: torch.Tensor) -> float:
    """The largest |got - want| over each row's (and channel's) sum of
    |v|: (B, cols[, 2]) outputs, (B, L[, 2]) values."""
    f = (lambda t: torch.view_as_real(t) if t.is_complex() else t[..., None])
    scale = f(v).abs().sum(dim=1, keepdim=True).clamp(min=1e-30)
    return float(((f(got) - f(want)).abs() / scale).max())


# (rows, length): the edges of the tile, a length no multiple of it, and
# the main path's shapes (DcBlock's 36,062 complex64, Agc's 4,063 f32)
ROWSCAN_SHAPES = [(1, 1), (200, 1), (1, 4095), (200, 4096), (1, 4097), (200, 4097), (3, 3 * 4096 + 5),
                  (58, 36_062), (58, 4_063)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.complex64], ids=["f32", "c64"])
@pytest.mark.parametrize("b,n", ROWSCAN_SHAPES)
def test_rowscan_matches_plain(cuda, b, n, dtype):
    """``row_mean`` and ``row_exclusive_prefix`` (with and without the
    subtracted mean) against their plain versions on the same CUDA rows,
    within 1e-5 of each row's sum of |v|; one launch counted a call; a row
    alone, the rows again and the rows in a batch of other rows bit-equal
    (the order is the row length's alone)."""
    from quadrs_tpu_torch.ops import rowscan

    x = rowscan_rows(b, n, dtype, cuda, seed=n)
    before = (rowscan.row_mean.launches, rowscan.row_exclusive_prefix.launches)
    mean = rowscan.row_mean(x)
    plain_prefix = rowscan.row_exclusive_prefix_reference(x, mean)
    got = {"plain": rowscan.row_exclusive_prefix(x), "centred": rowscan.row_exclusive_prefix(x, mean)}
    torch.cuda.synchronize()
    assert (rowscan.row_mean.launches, rowscan.row_exclusive_prefix.launches) == (before[0] + 1, before[1] + 2)
    assert mean.shape == (b, 1) and mean.dtype == dtype
    assert rowscan_err(mean * n, rowscan.row_mean_reference(x) * n, x) <= ROWSCAN_TOL
    assert got["plain"].shape == (b, n + 1) and bool((got["plain"][:, 0] == 0).all())
    assert rowscan_err(got["plain"], rowscan.row_exclusive_prefix_reference(x), x) <= ROWSCAN_TOL
    assert rowscan_err(got["centred"], plain_prefix, x - mean) <= ROWSCAN_TOL
    assert torch.equal(rowscan.row_exclusive_prefix(x, mean), got["centred"])
    alone = torch.cat([rowscan.row_exclusive_prefix(x[i : i + 1], mean[i : i + 1]) for i in range(min(b, 3))])
    assert torch.equal(alone, got["centred"][: min(b, 3)])
    wide = torch.cat([x, rowscan_rows(5, n, dtype, cuda, seed=n + 1)])
    assert torch.equal(rowscan.row_mean(wide)[:b], mean)


def test_rowscan_checks_inputs(cuda):
    """The kernels take contiguous rows and a contiguous per-row ``sub``
    on the rows' device; nothing launches otherwise."""
    from quadrs_tpu_torch.ops import rowscan

    x = rowscan_rows(4, 100, torch.complex64, cuda, seed=1)
    before = (rowscan.row_mean.launches, rowscan.row_exclusive_prefix.launches)
    with pytest.raises(ValueError, match="contiguous rows"):
        rowscan.row_exclusive_prefix(x[:, ::2])
    with pytest.raises(ValueError, match="contiguous rows"):
        rowscan.row_mean(x.t().contiguous().t())
    with pytest.raises(ValueError, match="sub must be"):
        rowscan.row_exclusive_prefix(x, x[:, :1].cpu())
    with pytest.raises(ValueError, match="sub must be"):
        rowscan.row_exclusive_prefix(x, x[:, :2][:, 1:])
    assert (rowscan.row_mean.launches, rowscan.row_exclusive_prefix.launches) == before


@pytest.mark.parametrize("chain", ["shift dcblock agc", "dcblock", "agc"])
def test_trailing_stages_are_batch_invariant(cuda, chain):
    """``shift dcblock -window 500 agc -window 100`` and each stage alone
    through the executor on the card: 200 windows of 63 at 1, 7 and 200 a
    batch bit-equal (their sums come from the row-scan kernels, whose
    order is the block length's), the kernels launched on the way, and
    within 1e-4 of scale of the CPU (the stage tests' bound)."""
    from quadrs_tpu_torch import sources, stream
    from quadrs_tpu_torch.ops import rowscan
    from quadrs_tpu_torch.runtime import Executor

    raw = np.ascontiguousarray(synth_planes(FileFormat.COMPLEX_INT8, 6_000, seed=7).T).reshape(-1).view(np.uint8)
    src = sources.SampleSource(raw, FileFormat.COMPLEX_INT8, 48_000)
    make = {"shift dcblock agc": lambda: stream.Agc(stream.DcBlock(stream.Shift(src, 5_000), 500), window=100),
            "dcblock": lambda: stream.DcBlock(src, 500), "agc": lambda: stream.Agc(src, window=100)}[chain]
    offs = 16 * np.arange(200, dtype=np.int64)
    ex = Executor(make(), 63, cuda)
    before = (rowscan.row_mean.launches, rowscan.row_exclusive_prefix.launches)
    runs = {b: np.concatenate([ex.run(offs[i:i + b])[0] for i in range(0, 200, b)]) for b in (1, 7, 200)}
    means, prefixes = rowscan.row_mean.launches - before[0], rowscan.row_exclusive_prefix.launches - before[1]
    assert prefixes > 0 and (means > 0) == (chain != "agc")
    assert runs[7].tobytes() == runs[1].tobytes() and runs[200].tobytes() == runs[1].tobytes()
    assert ex.run(offs[:7])[0].tobytes() == runs[1][:7].tobytes()
    want = Executor(make(), 63, "cpu").run(offs)[0]
    np.testing.assert_allclose(runs[1], want, rtol=0, atol=1e-4 * np.abs(want).max())



@pytest.mark.parametrize("chain", ["shift lowpass dcblock agc", "shift lowpass"])
def test_the_launch_never_waits_on_the_card(cuda, chain, monkeypatch):
    """``shift 280000 lowpass -power 200 -decimate 32 200000 [dcblock agc]
    sparkfft -width 64 -stride 16 -range 0.08:1`` over 2^21 cs8 samples at
    21 Msps (the benchmark's chains, a shorter capture), 58 windows a
    batch as the conditioned chain's gather cap makes them: every
    ``Executor.submit`` after the pass's first runs under
    ``torch.cuda.set_sync_debug_mode("error")``, so a copy that waits on
    the card raises; ``table_uploads`` is at least 1 on the first batch and
    0 on every later one; the rows equal a pass that uploads every table
    again and synchronizes after each batch."""
    from quadrs_tpu_torch import runtime, sinks, sources, stream
    from quadrs_tpu_torch.ops import tables
    from quadrs_tpu_torch.utils.profiling import PROFILER, profiled

    fmt = FileFormat.COMPLEX_INT8
    raw = np.ascontiguousarray(synth_planes(fmt, 1 << 21, seed=11).T).reshape(-1).view(np.uint8)

    def make():
        s = stream.LowPass(stream.Shift(sources.SampleSource(raw, fmt, 21_000_000), 280_000), 200_000, 32, 400)
        return stream.Agc(stream.DcBlock(s, 32_000), 1.0, 4_000, 1000.0) if "agc" in chain else s

    monkeypatch.setattr(sinks, "stream_batches", lambda s, offs, w: runtime.stream_batches(s, offs, w, budget=w * 58))
    orig = runtime.Executor.submit
    submits = []

    def never_waits(self, offs, aux=None):
        submits.append(len(offs))
        if len(submits) == 1:
            return orig(self, offs, aux)
        torch.cuda.set_sync_debug_mode("error")
        try:
            return orig(self, offs, aux)
        finally:
            torch.cuda.set_sync_debug_mode(0)

    def synchronized(self, offs, aux=None):
        tables.clear()
        out = orig(self, offs, aux)
        torch.cuda.synchronize()
        return out

    rows = {}
    for name, submit in (("async", never_waits), ("synchronized", synchronized)):
        tables.clear()
        PROFILER.reset()
        monkeypatch.setattr(runtime.Executor, "submit", submit)
        lines: list[str] = []
        with profiled():
            sinks.spark_fft(make(), 64, 16, 0.08, 1.0, out=lines.append, device=cuda)
        rows[name] = lines
        if name == "async":
            launches = sorted((s for s in PROFILER.spans() if s.name == "executor.launch"), key=lambda s: s.key[1])
            counts = [s.counters["table_uploads"] for s in launches]
    PROFILER.reset()
    assert len(submits) > 10 and len(counts) == len(submits)
    assert counts[0] >= 1 and not any(counts[1:]), counts
    assert rows["async"] == rows["synchronized"] and len(rows["async"]) > 4000


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


# -- the upload ring's streams ---------------------------------------------------------


def test_upload_ring_never_writes_memory_in_use(cuda):
    """A slot's first upload while the compute stream still runs kernels on
    memory it has already freed: the allocator hands such a block to the
    compute stream's next allocation at once, so a slot made there would be
    written by the copy stream under those kernels.  Here the compute stream
    spins, then fills a freed temporary of the slot's size; the slot must
    read what was uploaded."""
    from quadrs_tpu_torch.staging import UploadRing

    n = (1 << 20) + 4099
    # each kernel launched once first: loading a kernel's module at its first
    # launch would wait for the spin and hide the hazard
    float(torch.ones(8, device=cuda).sum())
    torch.cuda._sleep(1)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()  # no cached block but the temporary's
    ring = UploadRing(cuda, 2, x=(n, torch.float32))
    k = ring.take()
    ring.host(k, "x", (n,))[:] = 7.0
    tmp = torch.empty(n, dtype=torch.float32, device=cuda)
    torch.cuda._sleep(200_000_000)  # the compute stream busy for ~0.1 s
    tmp.fill_(1.0)
    del tmp  # back in the compute stream's pool, its fill still queued
    got = ring.upload(k, x=(n,))["x"]
    assert not torch.cuda.current_stream(cuda).query()  # the fill still queued behind the spin
    ring.consumed(k)
    total = float(got.sum())
    ring.recycle(k)
    assert total == 7.0 * n


# -- the serve daemon on the card -----------------------------------------------------


def _start_daemon(cmd, device, max_connections=None):
    """``run_serve`` on a thread on ``device``; returns (thread, port, errors)."""
    import threading

    from quadrs_tpu_torch.serve import run_serve

    box, errors, evt = [], [], threading.Event()

    def ready(p):
        box.append(p)
        evt.set()

    def run():
        try:
            run_serve(cmd, device, ready=ready, max_connections=max_connections)
        except BaseException as e:  # reported by the test
            errors.append(e)
            evt.set()

    th = threading.Thread(target=run)
    th.start()
    assert evt.wait(600), "the daemon never came up"  # the first test builds the kernels
    assert not errors, errors
    return th, box[0], errors


def _client(port: int, payload: bytes, pieces: int = 1) -> bytes:
    """Send the payload (in ``pieces`` timed pieces), half-close, read to EOF
    while sending."""
    import socket
    import threading
    import time

    out: list[bytes] = []
    with socket.create_connection(("127.0.0.1", port), timeout=60) as s:
        rd = threading.Thread(target=lambda: out.extend(iter(lambda: s.recv(1 << 16), b"")))
        rd.start()
        step = max(1, -(-len(payload) // pieces))
        for off in range(0, len(payload), step):
            s.sendall(payload[off : off + step])
            if pieces > 1:
                time.sleep(0.05)
        s.shutdown(socket.SHUT_WR)
        rd.join(timeout=120)
        assert not rd.is_alive()
    return b"".join(out)


def _serve_cmd(**kw):
    from quadrs_tpu_torch import args as targs

    base = dict(port=0, host="127.0.0.1", once=True, shift=280_000, lowpass=200_000, size=400, decimate=32,
                fft_width=64, chunk=1 << 18, sample_rate="21M", format="cs8")
    base.update(kw)
    return targs.ServeCmd(**base)


def _cf32(x: np.ndarray) -> bytes:
    raw = np.empty(2 * len(x), dtype="<f4")
    raw[0::2], raw[1::2] = x.real, x.imag
    return raw.tobytes()


def _serve_case(mode: str, tmp_path):
    """(ServeCmd keywords, payload, the direct run on a device: a function of
    the device giving the expected reply's bytes or lines) of one mode."""
    import io
    import os
    import sys
    from types import SimpleNamespace

    from quadrs_tpu_torch import cli as tcli
    from quadrs_tpu_torch.models.waterfall import WaterfallConfig, WaterfallModel
    from quadrs_tpu_torch.sources import PipeSource, SampleSource
    from quadrs_tpu_torch.stream_runner import StreamRunner, WaterfallRunner

    rng = np.random.default_rng(SERVE_MODES.index(mode))
    cs8 = rng.integers(-60, 61, 2 * 600_000).astype(np.int8).tobytes()

    def cli_lines(argv, payload, dev):
        """The CLI's stdout lines over a pipe of the payload on ``dev``."""
        import contextlib

        buf = io.StringIO()
        stdin, env = sys.stdin, os.environ.get("QUADRS_PLATFORM")
        sys.stdin = SimpleNamespace(buffer=io.BytesIO(payload))
        os.environ["QUADRS_PLATFORM"] = dev.type
        try:
            with contextlib.redirect_stdout(buf):
                assert tcli.main(argv) == 0
        finally:
            sys.stdin = stdin
            if env is None:
                os.environ.pop("QUADRS_PLATFORM")
            else:
                os.environ["QUADRS_PLATFORM"] = env
        return buf.getvalue().strip().splitlines()

    if mode in ("stream", "stream-search"):
        def direct(dev):
            model = PipelineModel(PipelineConfig(sample_rate=21_000_000, shift_freq=280_000, lp_freq=200_000,
                                                 decimate=32, taps=400, fft_width=64, fmt=FileFormat.COMPLEX_INT8))
            runner = StreamRunner(SampleSource(np.frombuffer(cs8, np.uint8), FileFormat.COMPLEX_INT8, 21_000_000),
                                  model, dev, chunk_samples=1 << 18)
            rows = []
            if mode == "stream":
                runner.run(lambda w0, n: rows.append(n.tobytes()))
                return b"".join(rows)
            runner.run_search(lambda w0, o: rows.extend(f"{w0 + i},{int(o[0][i])},{float(o[1][i]):.9g}"
                                                        for i in range(len(o[0]))))
            return ["window,bin,mag", *rows]
        return dict(search=mode == "stream-search"), cs8, direct
    if mode in ("waterfall", "waterfall-search", "scan"):
        stride = 1024 if mode == "waterfall" else 256

        def direct(dev):
            model = WaterfallModel(WaterfallConfig(n_streams=1, fft_width=1024, stride=stride, fmt=FileFormat.COMPLEX_INT8))
            runner = WaterfallRunner([PipeSource(io.BytesIO(cs8), FileFormat.COMPLEX_INT8, 21_000_000)], model, dev,
                                     chunk_windows=200)
            rows = []
            if mode == "waterfall":
                runner.run(lambda w0, n: rows.append(n[0].tobytes()))
                return b"".join(rows)
            if mode == "scan":
                from quadrs_tpu_torch.serve import _scan_csv_lines

                freq = (np.arange(1024) - 512) * (21_000_000 / 1024)
                return [ln.rstrip("\n") for ln in _scan_csv_lines(runner.run_scan(threshold=20.0), 0, freq)]
            runner.run_search(lambda w0, o: rows.extend(f"{w0 + i},{int(o[0][0, i])},{float(o[1][0, i]):.9g}"
                                                        for i in range(o[0].shape[1])))
            return ["window,bin,mag", *rows]
        kw = dict(mode="scan" if mode == "scan" else "waterfall", fft_width=1024, stride=stride, chunk=200,
                  search=mode == "waterfall-search")
        if mode == "scan":
            kw["threshold"] = 20.0
        return kw, cs8, direct
    if mode == "find":
        x = rng.integers(-40, 41, (400_000, 2)) @ np.array([1, 1j])
        p = rng.integers(-60, 61, (512, 2)) @ np.array([1, 1j])
        for o in (1_000, 123_457, 399_488):
            x[o : o + 512] = p
        payload = np.clip(np.rint(np.stack([x.real, x.imag], -1)), -127, 127).astype(np.int8).tobytes()
        pat = tmp_path / "t.sr21M.cs8"
        pat.write_bytes(np.clip(np.stack([p.real, p.imag], -1), -127, 127).astype(np.int8).tobytes())
        argv = ["find", "-pattern", str(pat), "-stdin", "yes", "-sr", "21M", "-format", "cs8"]

        def direct(dev):
            lines = cli_lines(argv, payload, dev)
            return [*lines[:-1], "# " + lines[-1]]
        return dict(mode="find", patterns=(str(pat),), threshold=0.5, chunk=None), payload, direct
    # the receivers: the command's lines (or its audio) over the same burst
    m = np.arange(1 << 19)
    if mode == "ook":
        env = np.repeat(rng.integers(0, 2, (1 << 19) // 64), 64).astype(np.float64)
        payload = _cf32(0.4 * env * np.exp(2j * np.pi * 0.01 * m))
        kw, argv = dict(mode="ook", fft_width=4, stride=2, bit=16.0, threshold=0.05, sample_rate="400",
                        format="cf32"), ["ook", "-bit", "16", "-threshold", "0.05"]
    elif mode == "fsk":
        tone = np.repeat(rng.integers(0, 2, (1 << 19) // 4096), 4096) * 2 - 1
        payload = _cf32(0.5 * np.exp(2j * np.pi * np.cumsum(tone * 3_000.0) / 48_000))
        kw, argv = dict(mode="fsk", shift=0, lowpass=8_000, size=20, decimate=4, fft_width=64, stride=600,
                        sample_rate="48k", format="cf32"), \
            ["fsk", "-lowpass", "8k", "-power", "10", "-decimate", "4", "-width", "64", "-stride", "600"]
    elif mode == "psk":
        a = np.cumsum(rng.integers(0, 2, (1 << 19) // 64)) % 2
        payload = _cf32(np.exp(1j * (np.pi * np.repeat(a, 64) + 0.5 + 2 * np.pi * 60.0 * m / 128_000)))
        kw, argv = dict(mode="psk", shift=0, lowpass=5_000, size=64, decimate=4, symbol_rate=2_000.0,
                        sample_rate="128k", format="cf32"), \
            ["psk", "-lowpass", "5k", "-power", "32", "-decimate", "4", "-symbol-rate", "2k"]
    else:
        audio_mod = {"fm": np.exp(1j * 4.0 * np.sin(2 * np.pi * 500.0 * m / 100_000)),
                     "am": (1.0 + 0.5 * np.cos(2 * np.pi * 250.0 * m / 100_000)).astype(np.complex128),
                     "ssb": 0.5 * np.exp(2j * np.pi * 700.0 * m / 100_000)}[mode]
        payload = _cf32(audio_mod)
        kw = dict(mode=mode, shift=0, lowpass=8_000, size=80, decimate=4, sample_rate="100k", format="cf32")

        def direct(dev):
            from quadrs_tpu_torch.serve import _make_serve_demod

            src = SampleSource(np.frombuffer(payload, np.uint8), FileFormat.COMPLEX_FLOAT32, 100_000)
            rate, audio = _make_serve_demod(_serve_cmd(**kw)).demodulate(src, device=dev)
            return (f"# {mode} {len(audio)} {rate}\n".encode() + audio.astype("<f4").tobytes()
                    + f"\n# {mode}: {len(audio)} audio samples @ {rate} Hz\n".encode())
        return kw, payload, direct
    rate = kw["sample_rate"]
    argv = [*argv, "-stdin", "yes", "-sr", rate, "-format", "cf32"]

    def direct(dev):
        lines = cli_lines(argv, payload, dev)
        return [lines[0], "# " + lines[1]]
    return kw, payload, direct


SERVE_MODES = ["stream", "stream-search", "waterfall", "waterfall-search", "scan", "find",
               "ook", "fsk", "psk", "fm", "am", "ssb"]


@pytest.mark.parametrize("mode", SERVE_MODES)
def test_serve_sessions_match_runner(cuda, mode, tmp_path):
    """One session of each ``-mode`` on the card: the reply equals the direct
    run on the card (the runner, the command's stdout over a pipe of the same
    bytes, or the receiver's audio), byte for byte but for the trailer's
    time; ``stream``, ``waterfall`` and ``scan`` sessions launch their
    kernel once a chunk, the others none."""
    from quadrs_tpu_torch.ops import waterfall as wf

    kw, payload, direct = _serve_case(mode, tmp_path)
    th, port, errors = _start_daemon(_serve_cmd(**kw), cuda)
    counted = (fe.frontend_fir, fe.frontend_fir_stft, fe.frontend_banded, wf.waterfall_norms, wf.waterfall_search,
               wf.waterfall_scan)
    for k in counted:
        k.launches = 0  # the warm run's launches were before ready
    reply = _client(port, payload)
    th.join(timeout=120)
    assert not th.is_alive() and not errors, errors
    launched = {k.__name__: k.launches for k in counted if k.launches}
    want = direct(cuda)
    if isinstance(want, bytes):
        assert reply == want
    else:
        lines = reply.decode().strip().splitlines()
        if mode in ("stream-search", "waterfall-search", "scan"):
            assert lines[-1].startswith(f"# {kw.get('mode', 'stream')}: ")
            lines = lines[:-1]
        assert lines == want
    kernel = {"stream": "frontend_fir", "stream-search": "frontend_fir", "waterfall": "waterfall_norms",
              "waterfall-search": "waterfall_search", "scan": "waterfall_scan"}.get(mode)
    assert set(launched) == ({kernel} if kernel else set())
    if mode.startswith("stream"):
        assert launched[kernel] == -(-(600_000 - 400) // (1 << 18))  # one a chunk (256k-sample chunks)


@pytest.mark.parametrize("mode", ["stream", "waterfall"])
def test_serve_parallel_sessions_match_sequential(cuda, mode, monkeypatch):
    """-parallel 4 on the card: eight concurrent ``-search`` sessions, half
    trickling, each on its own CUDA stream over the one model; every reply
    equals the sequential daemon's byte for byte but for the trailer's
    time, the launches are the sequential ones, and the model's lazily made
    tables (the decode table, the DFT tables) are made once, before the
    daemon listens."""
    from quadrs_tpu_torch.ops import waterfall as wf

    made = []
    for mod, name in ((fe, "decode_tensor"), (wf, "waterfall_tables")):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _real=real, _name=name, **k: made.append(_name) or _real(*a, **k))
    rng = np.random.default_rng(7)
    payloads = [rng.integers(-60, 61, 2 * (400_000 + 10_007 * i)).astype(np.int8).tobytes() for i in range(8)]
    kw = dict(search=True, once=False) if mode == "stream" else dict(
        search=True, once=False, mode="waterfall", fft_width=1024, stride=256, chunk=500)
    kernel = fe.frontend_fir if mode == "stream" else wf.waterfall_search
    replies, launches = {}, {}
    for parallel in (1, 4):
        made.clear()
        th, port, errors = _start_daemon(_serve_cmd(parallel=parallel, timeout=30.0, **kw), cuda, max_connections=8)
        assert made == (["decode_tensor"] if mode == "stream" else ["waterfall_tables"])
        kernel.launches = 0
        out: list[bytes | None] = [None] * 8
        if parallel == 1:
            for i in range(8):
                out[i] = _client(port, payloads[i])
        else:
            import threading

            clients = [threading.Thread(target=lambda i=i: out.__setitem__(i, _client(port, payloads[i], 6 if i % 2 else 1)))
                       for i in range(8)]
            for c in clients:
                c.start()
            for c in clients:
                c.join(timeout=300)
                assert not c.is_alive()
        th.join(timeout=120)
        assert not th.is_alive() and not errors, errors
        assert len(made) == 1  # no session made a table
        replies[parallel] = [r.decode().strip().splitlines() for r in out]
        launches[parallel] = kernel.launches
    assert launches[4] == launches[1] > 8
    for i, (seq, par) in enumerate(zip(replies[1], replies[4])):
        bad = [j for j, (a, b) in enumerate(zip(seq, par)) if a != b]
        assert par[:-1] == seq[:-1] and len(seq) > 100, (i, len(bad), bad[:3], [(seq[j], par[j]) for j in bad[:3]])
        assert par[-1].split(", ")[:2] == seq[-1].split(", ")[:2]  # samples and windows; the time differs


def test_serve_sequential_sessions_reuse_memory(cuda):
    """Twelve ``stream -search`` sessions one after another on one daemon,
    in small chunks, so each session's ring and temporaries take blocks the
    sessions before freed: every reply equals the runner's run on the card
    over the same bytes."""
    from quadrs_tpu_torch.sources import SampleSource
    from quadrs_tpu_torch.stream_runner import StreamRunner

    rng = np.random.default_rng(11)
    payloads = [rng.integers(-60, 61, 2 * (300_000 + 7_919 * i)).astype(np.int8).tobytes() for i in range(12)]
    cfg = PipelineConfig(sample_rate=21_000_000, shift_freq=280_000, lp_freq=200_000, decimate=32, taps=400,
                         fft_width=64, fmt=FileFormat.COMPLEX_INT8)
    th, port, errors = _start_daemon(_serve_cmd(search=True, once=False, chunk=1 << 16), cuda, max_connections=12)
    replies = [_client(port, p).decode().strip().splitlines() for p in payloads]
    th.join(timeout=120)
    assert not th.is_alive() and not errors, errors
    for i, (payload, reply) in enumerate(zip(payloads, replies)):
        runner = StreamRunner(SampleSource(np.frombuffer(payload, np.uint8), FileFormat.COMPLEX_INT8, 21_000_000),
                              PipelineModel(cfg), cuda, chunk_samples=1 << 16)
        rows = ["window,bin,mag"]
        runner.run_search(lambda w0, o: rows.extend(f"{w0 + j},{int(o[0][j])},{float(o[1][j]):.9g}"
                                                    for j in range(len(o[0]))))
        assert reply[-1].startswith("# stream: ") and reply[:-1] == rows, i


# -- the mesh on the card ---------------------------------------------------------


def _mesh_devices(kind: str, n: int) -> list[torch.device]:
    """``n`` shards' devices: the first card repeated, or the cards in
    turn (which needs two)."""
    if kind == "repeated":
        return [torch.device("cuda", 0)] * n
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    return [torch.device("cuda", i % torch.cuda.device_count()) for i in range(n)]


def test_launches_leave_the_current_device(cuda):
    """A launch on an explicitly indexed card leaves the calling thread's
    current device as it was (the launchers restore it): on the last card,
    so that with two cards the launch is on ``cuda:1`` while ``cuda:0`` is
    current."""
    dev = torch.device("cuda", torch.cuda.device_count() - 1)
    torch.cuda.set_device(0)
    model, planes, bases, n_out, n_ok = inputs(FileFormat.COMPLEX_INT8, 32, 400, 64, 1 << 16, dev)
    got = fe.fused_frontend_t(planes, bases, model.frontend_spec, n_out, n_valid=n_ok, tables=model.frontend_tables())
    assert torch.cuda.current_device() == 0
    from quadrs_tpu_torch.models.waterfall import WaterfallConfig, WaterfallModel

    wm = WaterfallModel(WaterfallConfig(n_streams=2, fft_width=1024, stride=256)).to(dev)
    raw = torch.from_numpy(wm.synth_raw(1024 * 8, seed=1)).to(dev)
    wm.step(raw), wm.search(raw), wm.scan(raw, 1.0)
    assert torch.cuda.current_device() == 0
    torch.cuda.synchronize(dev)
    assert got.device == dev


@pytest.mark.parametrize("kind", ["repeated", "distinct"])
@pytest.mark.parametrize("n_time", [2, 4])
@pytest.mark.parametrize("fmt", list(FileFormat))
def test_sharded_stream_step_matches_single_device(cuda, fmt, n_time, kind):
    """The sharded fused route against the single-device fused route over
    the same span, at an absolute offset near 1e9, so that every shard's
    bases are planned far from zero (by ``shard_bases``, as the runner
    plans them): each shard launches kernel 1 once, and the current device
    is unchanged."""
    from quadrs_tpu_torch.parallel.sharding import halo_samples, join, make_mesh, make_sharded_stream_step, shard_bases
    from quadrs_tpu_torch.parallel.sharding import shard_span

    mesh = make_mesh(n_time, 1, devices=_mesh_devices(kind, n_time))
    model = PipelineModel(PipelineConfig(sample_rate=21_000_000, shift_freq=280_000, lp_freq=200_000,
                                         decimate=32, taps=400, fft_width=64, fmt=fmt)).to(cuda)
    halo = halo_samples(model.cfg)
    n_local = 32 * 64 * 40
    total = n_time * n_local
    raw = synth_planes(fmt, total + halo, seed=n_time)
    off = 999_999_937
    torch.cuda.set_device(0)
    before = fe.frontend_fir.launches
    step = make_sharded_stream_step(model, mesh)
    bases = [[torch.from_numpy(shard_bases(model, off, n_local, n_local + halo, t)).to(d) for t, d in enumerate(row)]
             for row in mesh.devices]
    got = join(step(shard_span(raw, mesh, halo), off, bases), 1)[0].cpu().numpy()
    assert fe.frontend_fir.launches == before + n_time
    assert torch.cuda.current_device() == 0
    full = torch.from_numpy(raw).to(cuda)
    want = model.step_stream_fused(full, torch.from_numpy(model.stream_bases(off, total + halo)).to(cuda)).cpu().numpy()
    assert got.shape == want.shape == (n_time * 40, 64)
    assert float(np.abs(got - want).max()) <= TOL * float(want.max())


@pytest.mark.parametrize("kind", ["repeated", "distinct"])
@pytest.mark.parametrize("stride", [1024, 256, 1])
def test_sharded_waterfall_matches_single_device(cuda, stride, kind):
    """The sharded waterfall norms and search (a 2x2 mesh, two streams a
    row) against the single-device kernels over the same span: norms to
    the bank's rtol, peak bins equal but where the top two norms are
    within it."""
    from quadrs_tpu_torch.models.waterfall import WaterfallConfig, WaterfallModel
    from quadrs_tpu_torch.parallel.sharding import join, make_mesh, make_sharded_waterfall_step, shard_span, waterfall_halo

    mesh = make_mesh(2, 2, devices=_mesh_devices(kind, 4))
    model = WaterfallModel(WaterfallConfig(n_streams=4, fft_width=1024, stride=stride)).to(cuda)
    halo = waterfall_halo(model.cfg)
    n_local = stride * (3000 if stride == 1 else 40)
    n = 2 * n_local
    full = model.synth_raw(n + halo, seed=stride)
    torch.cuda.set_device(0)
    before = (wf.waterfall_norms.launches, wf.waterfall_search.launches)
    norms = join(make_sharded_waterfall_step(model, mesh)(shard_span(full, mesh, halo)), 1).cpu().numpy()
    idx, val = (o.cpu().numpy() for o in join(make_sharded_waterfall_step(model, mesh, search=True)(
        shard_span(full, mesh, halo)), 1))
    assert (wf.waterfall_norms.launches, wf.waterfall_search.launches) == (before[0] + 4, before[1] + 4)
    assert torch.cuda.current_device() == 0
    raw = torch.from_numpy(full).to(cuda)
    want = model.step(raw).cpu().numpy()[:, : n // stride]
    assert norms.shape == want.shape
    np.testing.assert_allclose(norms, want, rtol=2e-5, atol=2e-5 * want.max())
    top2 = np.sort(want, axis=-1)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] > 2e-5 * top2[..., 1]
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(idx[clear], np.argmax(want, axis=-1)[clear])
    np.testing.assert_allclose(val, want.max(axis=-1), rtol=2e-5)


@pytest.mark.parametrize("kind", ["repeated", "distinct"])
def test_mesh_runners_match_single_device_on_the_card(cuda, kind, tmp_path):
    """``StreamRunner`` and ``WaterfallRunner`` over a 2x1 mesh from a
    file against their single-device runs on the card: rows within the
    kernels' tolerances, survey counts equal but at the threshold's
    noise band, and the current device unchanged after every run."""
    from quadrs_tpu_torch.models.waterfall import WaterfallConfig, WaterfallModel
    from quadrs_tpu_torch.parallel.sharding import make_mesh
    from quadrs_tpu_torch.sources import open_capture
    from quadrs_tpu_torch.stream_runner import StreamRunner, WaterfallRunner

    fmt, win = FileFormat.COMPLEX_INT8, 32 * 64
    path, _ = write_raw(tmp_path, fmt, 64 * 10 * win + 777, seed=5)
    mesh = make_mesh(2, 1, devices=_mesh_devices(kind, 2))
    torch.cuda.set_device(0)
    model = PipelineModel(PipelineConfig(sample_rate=21_000_000, shift_freq=280_000, lp_freq=200_000,
                                         decimate=32, taps=400, fft_width=64, fmt=fmt))
    single = np.concatenate([r for _, r in collect(StreamRunner(open_capture(path), model, cuda,
                                                               chunk_samples=10 * win).run)[0]])
    sharded = np.concatenate([r for _, r in collect(StreamRunner(open_capture(path), model, cuda,
                                                                chunk_samples=20 * win, mesh=mesh).run)[0]])
    assert torch.cuda.current_device() == 0
    assert sharded.shape == single.shape
    assert float(np.abs(sharded - single).max()) <= TOL * float(single.max())
    thr = float(np.median(single))
    a = StreamRunner(open_capture(path), model, cuda, chunk_samples=10 * win).run_scan(thr)
    b = StreamRunner(open_capture(path), model, cuda, chunk_samples=20 * win, mesh=mesh).run_scan(thr)
    assert a.windows == b.windows and np.abs(a.above - b.above).max() <= 1
    bank = WaterfallModel(WaterfallConfig(n_streams=1, fft_width=1024, stride=256, fmt=fmt))
    one = np.concatenate([r for _, r in collect(WaterfallRunner([open_capture(path)], bank, cuda,
                                                               chunk_windows=500).run)[0]], axis=1)
    two = np.concatenate([r for _, r in collect(WaterfallRunner([open_capture(path)], bank, cuda,
                                                               chunk_windows=500, mesh=mesh).run)[0]], axis=1)
    assert torch.cuda.current_device() == 0
    np.testing.assert_allclose(two, one, rtol=2e-5, atol=2e-5 * one.max())


@pytest.mark.parametrize("kind", ["repeated", "distinct"])
def test_receiver_mesh_matches_single_device_on_the_card(cuda, kind, tmp_path):
    """Each receiver's ``mesh=`` on a 4-way mesh of the card (or of the
    cards in turn) against its single-device run on the card: bits, digits
    and pulses equal, audio and PSK baseband within ``1e-5`` (the parity
    tests' bound), through the sharded front end, and the current device
    unchanged after each run."""
    from quadrs_tpu_torch.models import demod
    from quadrs_tpu_torch.parallel.sharding import make_mesh
    from quadrs_tpu_torch.sources import open_capture

    rng = np.random.default_rng(3)
    n = 1 << 19
    t = np.arange(n) / 21e6
    x = 0.5 * np.exp(1j * (2 * np.pi * 280e3 * t + 50.0 * np.sin(2 * np.pi * 1000 * t)))
    x = x + 0.05 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    path = tmp_path / "tone.sr21M.cs8"
    path.write_bytes(np.clip(np.rint(np.stack([x.real, x.imag], 1) * 120), -127, 127).astype(np.int8).tobytes())
    mesh = make_mesh(4, devices=_mesh_devices(kind, 4))
    cases = [
        (demod.FmDemod(center=280_000, bandwidth=100_000, decimate=10, taps=400, chunk=1024), "demodulate"),
        (demod.AmDemod(center=280_000, bandwidth=10_000, decimate=20, taps=400, chunk=512), "demodulate"),
        (demod.SsbDemod(center=-280_000, bandwidth=3000, decimate=20, taps=400, chunk=512), "demodulate"),
        (demod.PskDemod(center=280_000, bandwidth=200_000, decimate=32, taps=400, symbol_rate=10_000, chunk=512),
         "baseband"),
        (demod.FskDemod(center=280_000, bandwidth=200_000, decimate=32, taps=400, fft_width=64), "symbols"),
        (demod.OokDemod(width=4, stride=2, threshold=0.001), "pulses"),
    ]
    torch.cuda.set_device(0)
    calls = []
    real = demod._MeshChannelStep.__call__
    demod._MeshChannelStep.__call__ = lambda step, o: calls.append(o) or real(step, o)
    try:
        for rx, method in cases:
            want = getattr(rx, method)(open_capture(str(path)), device=cuda)
            before = len(calls)
            got = getattr(rx, method)(open_capture(str(path)), device=cuda, mesh=mesh)
            assert len(calls) > before, type(rx).__name__
            assert torch.cuda.current_device() == 0
            if isinstance(want, tuple):  # (rate, audio or baseband)
                assert got[0] == want[0] and got[1].shape == want[1].shape and got[1].size > 0
                np.testing.assert_allclose(got[1], want[1], rtol=1e-5, atol=1e-5)
            else:
                assert np.array_equal(np.asarray(got), np.asarray(want)) and len(want) > 0, type(rx).__name__
    finally:
        demod._MeshChannelStep.__call__ = real


def test_serve_mesh_sessions_on_the_card(cuda, monkeypatch):
    """``serve -mesh`` on meshes that repeat the card: ``-parallel 2 -mesh
    2`` runs two ``-search`` sessions at once, each with a stream of its
    own on the card and a ring a shard, each reply a direct mesh run's
    lines; ``-mode fsk -mesh 4`` replies what the unmeshed daemon replies."""
    import io
    import threading

    from quadrs_tpu_torch import serve
    from quadrs_tpu_torch.parallel.sharding import make_mesh
    from quadrs_tpu_torch.sources import PipeSource
    from quadrs_tpu_torch.stream_runner import StreamRunner

    monkeypatch.setattr(serve, "mesh_of", lambda shape: None if shape is None else make_mesh(
        shape[0], shape[1], devices=[torch.device("cuda", 0)] * (shape[0] * shape[1])))
    rng = np.random.default_rng(8)
    payloads = [rng.integers(-60, 61, 2 * (900_000 + 10_007 * i)).astype(np.int8).tobytes() for i in range(2)]
    th, port, errors = _start_daemon(_serve_cmd(search=True, once=False, parallel=2, mesh=(2, 1)), cuda,
                                     max_connections=2)
    out: list[bytes | None] = [None, None]
    clients = [threading.Thread(target=lambda i=i: out.__setitem__(i, _client(port, payloads[i], 4))) for i in range(2)]
    for c in clients:
        c.start()
    for c in clients:
        c.join(timeout=300)
        assert not c.is_alive()
    th.join(timeout=120)
    assert not th.is_alive() and not errors, errors
    model = PipelineModel(PipelineConfig(sample_rate=21_000_000, shift_freq=280_000, lp_freq=200_000, decimate=32,
                                         taps=400, fft_width=64, fmt=FileFormat.COMPLEX_INT8))
    for data, reply in zip(payloads, out):
        rows, _ = collect(StreamRunner(PipeSource(io.BytesIO(data), FileFormat.COMPLEX_INT8, 21_000_000), model, cuda,
                                       chunk_samples=1 << 18, mesh=make_mesh(2, devices=[torch.device("cuda", 0)] * 2))
                          .run_search)
        want = [f"{w0 + j},{int(idx[j])},{float(val[j]):.9g}" for w0, (idx, val) in rows for j in range(len(idx))]
        lines = reply.decode().strip().splitlines()
        assert lines[0] == "window,bin,mag" and lines[1:-1] == want and len(want) > 100
    fsk = dict(mode="fsk", shift=0, lowpass=8_000, size=20, decimate=4, fft_width=64, stride=600,
               sample_rate="48k", format="cf32")
    tone = np.repeat(rng.integers(0, 2, (1 << 19) // 4096), 4096) * 2 - 1
    burst = _cf32(0.5 * np.exp(2j * np.pi * np.cumsum(tone * 3_000.0) / 48_000))
    replies = []
    for mesh in (None, (4, 1)):
        th, port, errors = _start_daemon(_serve_cmd(mesh=mesh, **fsk), cuda)
        replies.append(_client(port, burst))
        th.join(timeout=120)
        assert not th.is_alive() and not errors, errors
    assert replies[0] == replies[1] and len(replies[0]) > 100


def test_bench_quick_entries_launch_their_kernels(cuda, tmp_path):
    """The bench's headline and 64-stream waterfall at the ``quick`` scale
    (full shapes, 0.25 s windows): each launched its kernel while timed
    and held one step to the kernel's plain version."""
    from quadrs_tpu_torch import bench
    from quadrs_tpu_torch import bench_suite as bs

    lines = bench.run(["headline", "bench_waterfall"], bs.Scale("quick", cuda, str(tmp_path)))
    for line, kernel in zip(lines, ("frontend_fir", "waterfall_norms")):
        assert "error" not in line, line["error"]
        assert line["launches"].get(kernel, 0) > 0 and kernel in line["route"]
        assert line["max_err_over_scale"] <= (bs.FRONTEND_TOL if kernel == "frontend_fir" else 2 * bs.WATERFALL_RTOL)
        assert line["value"] > 0 and line["pct_hbm_peak"] <= 100 and line["linearity"] > 1.8
