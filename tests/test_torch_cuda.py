"""The CUDA kernels against their plain PyTorch versions on the card.

Marked ``cuda``: each test asks for the ``cuda`` fixture, which skips
where ``torch.cuda.is_available()`` is false (the CPU lanes).  On a
machine with a card and ``nvcc``, run them with
``python -m pytest --noconftest tests/test_torch_cuda.py`` (the
conftest imports jax, which such a machine need not have); the first
test builds the kernels.  Frontend tolerance ``5e-5 * scale``, the JAX
package's kernel-versus-chain bound; waterfall tolerances the JAX
package's waterfall ones (``tests/test_waterfall_pallas.py``)."""

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


@pytest.mark.parametrize("fmt", list(FileFormat))
@pytest.mark.parametrize(
    "width,stride,windowing,streams,nw",
    [
        (256, 256, "rectangular", 5, 301),
        (384, 96, "blackman-harris", 3, 203),
        (1024, 256, "rectangular", 8, 77),
        (2048, 2348, "blackman-harris", 2, 19),
        (8192, 2048, "rectangular", 2, 7),
    ],
)
def test_waterfall_kernels_match_plain(cuda, fmt, width, stride, windowing, streams, nw):
    spec = wf.WaterfallSpec(fmt, width, windowing)
    planes = torch.from_numpy(synth_planes(fmt, (nw - 1) * stride + width + 5, seed=width, n_streams=streams)).to(cuda)
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
        ((planes, wf.WaterfallTables(tables.twiddles, None), spec, 4, 256), "window"),
        ((planes, wf.WaterfallTables(tables.twiddles.cpu(), tables.window), spec, 4, 256), "twiddles"),
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
