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


# ---------------------------------------------------------------------------
# The CUDA kernel's summation order and launch plan, as far as the CPU sees
# them (csrc/frontend.cu itself runs only on the card).
# ---------------------------------------------------------------------------


def _hard_case(fmt, d, taps, n_out=1024):
    """One phase tile of the stream chain's config (21 Msps, shift 280k,
    lowpass 200k): the f32 mixed samples of both planes, the taps, the
    plain version's output and an f64 sum of the same mixed samples."""
    from quadrs_tpu_torch.ops.fir import lowpass_taps

    spec = fe.FrontendSpec(FileFormat(fmt), 21_000_000, 280_000, d, lowpass_taps(200e3 / 21e6, taps).tobytes())
    prefix = taps - taps // 2
    raw = torch.from_numpy(synth_planes(spec.fmt, (n_out + 128) * d + taps, seed=d + taps))
    planes = raw[:, prefix:]
    bases = torch.from_numpy(fe.tile_bases_t(spec, prefix, n_out))
    tables = fe.frontend_tables(spec)
    ref = fe.fused_frontend_t_reference(planes, bases, spec, n_out, planes.shape[1], tables).numpy()
    mixed = [m[0].numpy() for m in fe._mixed_t(planes, bases, spec, n_out, planes.shape[1], tables)]
    hp = np.zeros(spec.m_sub * d, np.float32)
    hp[:taps] = spec.taps
    hp = hp.reshape(spec.m_sub, d)
    exact = np.stack([
        sum(x[m : m + n_out].astype(np.float64) @ hp[m].astype(np.float64) for m in range(spec.m_sub)) for x in mixed
    ])
    return spec, mixed, hp, ref, exact


def _kernel_order(x, hp, n_out, chunk=fe._CHUNK):
    """The kernel's FIR order in f32: chunks of ``chunk`` subfilters (the
    last one shorter), each subfilter a run of D terms from zero in phase
    order, the subfilters added in order."""
    y = None
    for c0 in range(0, len(hp), chunk):
        part = []
        for m in range(c0, min(c0 + chunk, len(hp))):
            p = np.zeros(n_out, np.float32)
            for dd in range(hp.shape[1]):
                p = p + hp[m, dd] * x[m : m + n_out, dd]
            part.append(p)
        for p in part:
            y = p if y is None else y + p
    return y


def _per_phase_order(x, hp, n_out):
    """The sliding-window order that was weighed and not taken: per phase a
    run over the subfilters, then the D partials in order."""
    y = np.zeros(n_out, np.float32)
    for dd in range(hp.shape[1]):
        p = np.zeros(n_out, np.float32)
        for m in range(len(hp)):
            p = p + hp[m, dd] * x[m : m + n_out, dd]
        y = y + p
    return y


@pytest.mark.parametrize(
    "fmt,d,taps,hard",
    [("cu8", 64, 8192, True), ("cs16", 32, 4000, True), ("cu8", 32, 400, False), ("cs8", 32, 400, False)],
)
def test_fir_order(fmt, d, taps, hard):
    """The kernel keeps the plain version's order (per subfilter, then the
    subfilters).  At a few hundred taps it agrees with the plain version
    (a matmul, blocked otherwise) to 5e-5 of scale.  Past a few thousand
    taps of cu8 or cs16 the output is the residual of the decode's DC
    offset and f32 loses digits in any order: there the plain version
    itself lies further than 5e-5 from an f64 sum, the kernel's order no
    further than 1.5x that, and the per-phase order a sliding register
    window would need differs from the plain version by more than the
    tolerance, which is why the kernel does not take it (PERF.md has the
    readings; on the card the kernel's order is the matmul's own and the
    two are bit-equal)."""
    spec, mixed, hp, ref, exact = _hard_case(fmt, d, taps)
    n_out = ref.shape[1]
    scale = np.abs(ref).max()
    kern = np.stack([_kernel_order(x, hp, n_out) for x in mixed])
    phase = np.stack([_per_phase_order(x, hp, n_out) for x in mixed])
    err = {k: float(np.abs(v - exact).max() / scale) for k, v in (("plain", ref), ("kernel", kern), ("phase", phase))}
    to_plain = {k: float(np.abs(v - ref).max() / scale) for k, v in (("kernel", kern), ("phase", phase))}
    print(f"{fmt} D{d} {taps} taps: vs f64 {err}, vs plain {to_plain}")
    assert np.isfinite(kern).all()
    if hard:
        assert err["plain"] > 5e-5 and err["kernel"] <= 1.5 * err["plain"]
        assert to_plain["phase"] > 5e-5
    else:
        assert to_plain["kernel"] <= 5e-5 and err["kernel"] <= 5e-5


M_SUBS = (1, 2, 13, 32, 33, 64, 65, 125, 128)


def _spec_of(fmt, d, m_sub):
    taps = np.zeros((m_sub - 1) * d + 1, np.float32)
    return fe.FrontendSpec(FileFormat(fmt), 21_000_000, 280_000, d, taps.tobytes())


@pytest.mark.parametrize("width", [None, 2, 8, 64, 128])
@pytest.mark.parametrize("m_sub", M_SUBS)
@pytest.mark.parametrize("fmt", ["cf32", "cs8", "cu8", "cs16"])
def test_launch_plan_envelope(fmt, m_sub, width):
    """Every (D, m_sub) of the envelope has a launch the card can take."""
    for d in range(1, 65):
        spec = _spec_of(fmt, d, m_sub)
        assert spec.m_sub == m_sub
        plan, tout = fe.launch_plan(spec, width), fe._tout_t(spec)
        m_pad = -(-m_sub // plan.chunk) * plan.chunk
        assert plan.smem_bytes <= 232_448 and plan.blocks_per_sm >= 1
        assert tout % plan.bout == 0 and plan.bout % plan.outputs == 0
        assert width is None or plan.bout % width == 0  # whole windows
        # the last block of a tile stages columns up to tout - bout + cols - 1
        assert plan.cols == plan.bout + m_sub - 1 and tout - plan.bout + plan.cols <= tout + 128
        # rows: 16-byte aligned, 4 mod 8, and long enough for the vector loads
        assert plan.row % 8 == 4 and plan.row >= plan.bout + m_pad
        workers = 2 * (plan.bout // plan.outputs) * plan.groups
        assert plan.threads % 32 == 0 and workers <= plan.threads <= 256
        assert (plan.groups == 2) == (m_pad == 2 * plan.chunk)
        assert plan.inst == ("d32" if d == 32 else "any")
        elem = spec.fmt.torch_dtype.itemsize
        floats = 2 * d * plan.row + d * m_pad + (256 if elem == 1 else 0)
        floats += (2 * plan.bout if plan.groups == 2 or width else 0) + 2 * (width or 0)
        assert plan.smem_bytes == 4 * floats


@pytest.mark.parametrize("taps", [40, 400, 4000, 16_000, 40_000])
@pytest.mark.parametrize("d", [1, 2, 4, 8, 16, 32, 64])
@pytest.mark.parametrize("fmt", ["cf32", "cs8"])
def test_launch_plan_v1(fmt, d, taps):
    """The v1 kernel takes any filter whose staged span fits shared
    memory; the others raise."""
    spec = fe.FrontendSpec(FileFormat(fmt), 21_000_000, 280_000, d, np.zeros(taps, np.float32).tobytes())
    elem = spec.fmt.torch_dtype.itemsize
    groups = 2 if -(-spec.m_sub // 8) == 2 else 1
    fits = [b for b in (256, 128, 64, 32) if fe._layout(d, spec.m_sub, b, elem, groups == 2, 0)[1] <= 232_448]
    if not fits:
        with pytest.raises(ValueError, match="shared memory"):
            fe._banded_block_outputs(spec)
        return
    plan = fe.launch_plan(spec)
    assert plan.bout in fits and plan.bout == fe._banded_block_outputs(spec)
    assert plan.smem_bytes <= 232_448 and 2048 % plan.bout == 0
    assert (plan.bout + spec.m_sub - 1) * d <= len(fe._plan(spec)[2])  # the angle table covers the staged span
