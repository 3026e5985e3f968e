"""The port's fused frontend (its plain PyTorch version, which CPU tensors
take) against quadrs_tpu's ``fused_frontend_t`` run as its own tests run
it here (``interpret=True``), with and without the STFT epilogue.

Tolerance ``2e-5 * scale`` (scale = max |JAX output|): the decode and mix
are bit-equal, the FIR and DFT sums are f32 in another order."""

import jax
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from quadrs_tpu.formats import FileFormat as JFormat  # noqa: E402
from quadrs_tpu.models.receiver import PipelineConfig as JConfig  # noqa: E402
from quadrs_tpu.models.receiver import PipelineModel as JModel  # noqa: E402
from quadrs_tpu.ops import frontend_pallas as jfp  # noqa: E402

from quadrs_tpu_torch.formats import FileFormat, synth_planes  # noqa: E402
from quadrs_tpu_torch.models.receiver import PipelineConfig, PipelineModel  # noqa: E402
from quadrs_tpu_torch.ops import frontend as fe  # noqa: E402

TOL = 2e-5

# (fmt, decimate, taps, n_out, stft width, zero-padded tail): D 3 and 32,
# two phase tiles, m_sub > 32 (the TPU kernel's multi-group path), n_valid
CASES = [
    ("cf32", 3, 40, 4096 + 192, 64, None),  # two cf32 tiles
    ("cs8", 3, 40, 8192 + 256, 64, None),  # two cs8 tiles
    ("cu8", 32, 400, 2048, 32, 5_000),  # masked tail: zero bytes decode to -127.5
    ("cs16", 32, 400, 1024, 8, 9_000),  # masked tail: zero bytes decode to -32767.5
    ("cs8", 8, 300, 4096 + 128, 128, 20_000),  # m_sub 38: two groups, halved tiles, two of them
    ("cf32", 32, 1100, 1024, 16, None),  # m_sub 35
]


def _specs(fmt, d, taps):
    h = JModel(JConfig(sample_rate=1_000_000, lp_freq=50_000, decimate=d, taps=taps)).taps
    args = dict(sample_rate=1_000_000, shift_freq=12_345, decimate=d, taps_bytes=h.tobytes())
    return jfp.FrontendSpec(fmt=JFormat(fmt), **args), fe.FrontendSpec(fmt=FileFormat(fmt), **args)


@pytest.mark.parametrize("fused_stft", [False, True], ids=["planes", "stft"])
@pytest.mark.parametrize("fmt,d,taps,n_out,width,tail", CASES)
def test_frontend_matches_jax(fmt, d, taps, n_out, width, tail, fused_stft):
    jspec, tspec = _specs(fmt, d, taps)
    n = n_out * d + taps
    raw = synth_planes(FileFormat(fmt), n, seed=d + taps)
    n_valid = None
    if tail is not None:
        n_valid = n - tail
        raw[:, n_valid:] = 0  # zero padding, as the stream runner pads
    bases = jfp.tile_bases_t(jspec, 999_999_937, n_out)
    w = width if fused_stft else None

    want = np.asarray(
        jax.jit(
            lambda p, b: jfp.fused_frontend_t(
                p, b, jspec, n_out, n_valid=n_valid, stft_width=w, interpret=True
            )
        )(raw, bases)
    )
    before = (fe.frontend_fir.launches, fe.frontend_fir_stft.launches)
    got = fe.fused_frontend_t(
        torch.from_numpy(raw), torch.from_numpy(bases), tspec, n_out, n_valid=n_valid, stft_width=w
    ).numpy()
    assert (fe.frontend_fir.launches, fe.frontend_fir_stft.launches) == before  # CPU: no kernel
    assert got.shape == want.shape and got.dtype == np.float32
    scale = max(np.abs(want).max(), 1e-6)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * scale)


def test_frontend_rejects_unsupported():
    _, spec = _specs("cs8", 32, 400)
    planes = torch.zeros((2, 40_000), dtype=torch.int8)
    bases = torch.zeros(1)
    with pytest.raises(ValueError, match="width dividing 128"):
        fe.fused_frontend_t(planes, bases, spec, 1024, stft_width=48)
    with pytest.raises(ValueError, match="whole number"):
        fe.fused_frontend_t(planes, bases, spec, 1000, stft_width=64)
    _, wide = _specs("cs8", 65, 400)
    with pytest.raises(ValueError, match="decimate <= 64"):
        fe.fused_frontend_t(planes, bases, wide, 100)
    with pytest.raises(ValueError, match="cuda or cpu"):
        fe.fused_frontend_t(planes.to("meta"), bases.to("meta"), spec, 1024)


def test_kernel_wrappers_refuse_cpu_tensors():
    """The kernel wrappers launch or raise: a CPU tensor is refused, it
    never falls back to the plain version."""
    _, spec = _specs("cs8", 32, 400)
    planes = torch.zeros((2, 40_000), dtype=torch.int8)
    tables = fe.frontend_tables(spec, 64)
    before = (fe.frontend_fir.launches, fe.frontend_fir_stft.launches)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fe.frontend_fir(planes, torch.zeros(1), tables, spec, 1024, 40_000)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fe.frontend_fir_stft(planes, torch.zeros(1), tables, spec, 1024, 40_000, 64)
    assert (fe.frontend_fir.launches, fe.frontend_fir_stft.launches) == before


def test_build_flags():
    """sm_90a, IEEE division and accurate trig (no fast math)."""
    from quadrs_tpu_torch.ops import _cuda

    flags = " ".join(_cuda.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "fast_math" not in flags and "fast-math" not in flags
    assert _cuda.BUILD_DIR.parts[-2:] == ("build", "quadrs_tpu_torch")
    assert all(src.exists() for src in _cuda._SOURCES)


JAX_PLAN_KEYS = ("hp", "cdm", "sdm", "cdh", "sdh")


@pytest.mark.parametrize("fmt,d,taps", [("cs8", 32, 400), ("cu8", 3, 40), ("cf32", 8, 300)])
def test_load_reference_arrays(fmt, d, taps):
    """The port's model built from its own planners and from the JAX
    model's taps and ``_plan_t`` tables holds the same buffers and
    computes the same thing."""
    args = dict(sample_rate=1_000_000, shift_freq=12_345, lp_freq=50_000, decimate=d, taps=taps, fft_width=64)
    jm = JModel(JConfig(fmt=JFormat(fmt), **args))
    own = PipelineModel(PipelineConfig(fmt=FileFormat(fmt), **args))
    loaded = PipelineModel(PipelineConfig(fmt=FileFormat(fmt), **args))
    plan = dict(zip(JAX_PLAN_KEYS, jfp._plan_t(jm.frontend_spec)[2:]))
    loaded.load_reference_arrays({"taps": jm.taps, **plan})
    taps_only = PipelineModel(PipelineConfig(fmt=FileFormat(fmt), **args))
    taps_only.load_reference_arrays({"taps": jm.taps})
    want = own.state_dict()
    assert set(want) == {"taps", "hp", "tab_cos", "tab_sin", "stft_cos", "stft_sin"}
    for model in (loaded, taps_only):
        got = model.state_dict()
        assert set(got) == set(want)
        for k in want:
            assert torch.equal(got[k], want[k]), k

    n = d * 64 * 5 + taps + 17
    raw = torch.from_numpy(own.synth_raw(n, seed=2))
    bases = torch.from_numpy(own.stream_bases(0, n))
    assert torch.equal(loaded.step_stream_fused(raw, bases), own.step_stream_fused(raw, bases))
    with pytest.raises(ValueError, match="hp must be"):
        loaded.load_reference_arrays({"taps": jm.taps, "hp": plan["hp"][:1]})


def test_model_buffers_follow_to():
    model = PipelineModel(PipelineConfig(fmt=FileFormat.COMPLEX_INT8))
    assert {k: v.dtype for k, v in model.named_buffers()} == {
        k: torch.float32 for k in ("taps", "hp", "tab_cos", "tab_sin", "stft_cos", "stft_sin")
    }
    moved = model.to("meta")
    assert all(b.device.type == "meta" for b in moved.buffers())
