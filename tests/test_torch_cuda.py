"""The CUDA kernels against their plain PyTorch version on the card.

Marked ``cuda``: each test asks for the ``cuda`` fixture, which skips
where ``torch.cuda.is_available()`` is false (the CPU lanes).  On a
machine with a card and ``nvcc``, run them with
``python -m pytest --noconftest tests/test_torch_cuda.py`` (the
conftest imports jax, which such a machine need not have); the first
test builds the kernels.  Tolerance ``5e-5 * scale``, the JAX package's
kernel-versus-chain bound."""

import pytest
import torch

torch.set_num_threads(1)

from quadrs_tpu_torch.formats import FileFormat, synth_planes  # noqa: E402
from quadrs_tpu_torch.models.receiver import PipelineConfig, PipelineModel  # noqa: E402
from quadrs_tpu_torch.ops import frontend as fe  # noqa: E402

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
