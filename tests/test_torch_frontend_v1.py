"""The v1 fused frontend (``quadrs_tpu_torch.ops.frontend.fused_frontend``,
its plain version on the CPU) against quadrs_tpu's ``fused_frontend``,
run interpreted here, and its host planners against quadrs_tpu's,
bitwise.

Every case holds the port to ``1e-5 * max |want|``: both compute each
output as a 400-tap f32 sum, in different orders.  At 4000 taps of cu8
and cs16 f32 loses more than that in any order, and both are held to an
f64 sum instead."""

import jax
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from quadrs_tpu.formats import FileFormat as JFormat  # noqa: E402
from quadrs_tpu.ops import frontend_pallas as jfp  # noqa: E402
from quadrs_tpu.ops.fir import lowpass_taps  # noqa: E402

from quadrs_tpu_torch.formats import FileFormat, decode_plane, synth_planes  # noqa: E402
from quadrs_tpu_torch.ops import frontend as tfp  # noqa: E402

TOL = 1e-5
TAPS = 400


def specs(fmt: str, d: int, taps: int = TAPS):
    h = lowpass_taps(50_000 / 1_000_000, taps)
    args = dict(sample_rate=1_000_000, shift_freq=12_500, decimate=d, taps_bytes=h.tobytes())
    return jfp.FrontendSpec(fmt=JFormat(fmt), **args), tfp.FrontendSpec(fmt=FileFormat(fmt), **args)


def run_both(fmt: str, d: int, n_out: int, planes: np.ndarray, start: int):
    js, ts = specs(fmt, d)
    tiles = -(-n_out // 2048)
    jb, tb = jfp.tile_bases(js, start, tiles), tfp.tile_bases(ts, start, tiles)
    assert tb.tobytes() == jb.tobytes()
    want = np.asarray(jax.jit(lambda p, t: jfp.fused_frontend(p, t, js, n_out, interpret=True))(planes, jb))
    got = tfp.fused_frontend(torch.from_numpy(planes), torch.from_numpy(tb), ts, n_out)
    return got.numpy(), want


# (fmt, decimate, raw samples as a fraction of what the tiles need, start offset)
CASES = [(fmt, d, 1, TAPS // 2) for fmt in ("cf32", "cs8", "cu8", "cs16") for d in (8, 32)]
CASES += [
    ("cu8", 32, 0.5, TAPS // 2),  # raw planes shorter than the tiles need
    ("cs16", 8, 0.4, TAPS // 2),
    ("cs8", 32, 1, 999_999_937 + TAPS // 2),  # an absolute offset near 1e9
]


@pytest.mark.parametrize("fmt,d,frac,start", CASES)
def test_fused_frontend_matches_jax(fmt, d, frac, start):
    n_out = 3000  # not a multiple of the 2048-output tile: the last is partial
    n_in = int((n_out * d + TAPS) * frac)
    raw = synth_planes(FileFormat(fmt), n_in, seed=d + len(fmt))
    planes = raw[:, TAPS // 2 :]  # the caller drops the group delay
    got, want = run_both(fmt, d, n_out, planes, start)
    assert got.shape == want.shape == (2, n_out) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * np.abs(want).max())


@pytest.mark.parametrize("fmt,d", [("cu8", 8), ("cu8", 32), ("cs16", 8), ("cs16", 32), ("cs8", 32)])
def test_long_filter_against_f64(fmt, d):
    """4000 taps at the stream chain's config (21 Msps, shift 280k,
    lowpass 200k), one 2048-output tile.  cu8's and cs16's decode DC
    (-127.5, -32767.5) lands in the stopband, so the output is mostly its
    residual and f32 loses digits in any summation order.  Against an f64
    sum of the same f32-angle mix, the port's per-subfilter sums lie no
    further off than quadrs_tpu's banded sum (readings in PERF.md); cs8,
    which decodes without a DC, stays within the file's tolerance."""
    taps, n_out = 4000, 2048
    h = lowpass_taps(200e3 / 21e6, taps)
    args = dict(sample_rate=21_000_000, shift_freq=280_000, decimate=d, taps_bytes=h.tobytes())
    js, ts = jfp.FrontendSpec(fmt=JFormat(fmt), **args), tfp.FrontendSpec(fmt=FileFormat(fmt), **args)
    raw = synth_planes(FileFormat(fmt), n_out * d + taps, seed=d)
    bases = jfp.tile_bases(js, 0, 1)
    want = np.asarray(jax.jit(lambda p, t: jfp.fused_frontend(p, t, js, n_out, interpret=True))(raw, bases))
    got = tfp.fused_frontend(torch.from_numpy(raw), torch.from_numpy(bases), ts, n_out).numpy()

    theta = (bases[0] + tfp._plan(ts)[2][: n_out * d + taps]).astype(np.float64)  # the f32 angle sums
    x = [decode_plane(p, FileFormat(fmt)).astype(np.float64) for p in raw]
    mixed = (x[0] + 1j * x[1]) * np.exp(1j * theta)
    y = np.lib.stride_tricks.sliding_window_view(mixed, taps)[: n_out * d : d] @ h.astype(np.float64)
    exact = np.stack([y.real, y.imag])
    port, jax_err = (float(np.abs(a - exact).max()) for a in (got, want))
    assert port <= jax_err
    if fmt == "cs8":
        assert port <= TOL * np.abs(exact).max()


@pytest.mark.parametrize("fmt,d,taps", [("cs8", 32, 400), ("cu8", 1, 40), ("cf32", 64, 4000), ("cs16", 8, 77)])
def test_planners_bitwise(fmt, d, taps):
    js, ts = specs(fmt, d, taps)
    l_in, r_in, span_p, halo_p, r_halo, w, delta_main, delta_halo = jfp._plan(js)
    t_l_in, t_halo_p, delta = tfp._plan(ts)
    assert (t_l_in, t_halo_p) == (l_in, halo_p)
    want = np.concatenate([delta_main.reshape(-1), delta_halo.reshape(-1)])
    assert delta.dtype == want.dtype and delta[: len(want)].tobytes() == want.tobytes()
    assert len(delta) == max(l_in + halo_p, (2048 + ts.m_sub - 1) * d)
    for start in (0, 200, 999_999_937):
        for tiles in (1, 3):
            assert tfp.tile_bases(ts, start, tiles).tobytes() == jfp.tile_bases(js, start, tiles).tobytes()


def test_supported_matches_jax():
    for d in range(0, 130):
        assert tfp.supported(d) == jfp.supported(d)
    _, ts = specs("cs8", 24)
    with pytest.raises(ValueError, match="decimate"):
        tfp.fused_frontend(torch.zeros((2, 10_000), dtype=torch.int8), torch.zeros(1), ts, 100)


def test_kernel_wrapper_takes_cuda_tensors_only():
    """The kernel's wrapper refuses a CPU tensor (the entry point gives
    those to the plain version) and counts nothing."""
    _, ts = specs("cs8", 32)
    planes = torch.zeros((2, 3000 * 32), dtype=torch.int8)
    before = tfp.frontend_banded.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        tfp.frontend_banded(planes, torch.zeros(2), tfp.banded_tables(ts), ts, 3000)
    assert tfp.frontend_banded.launches == before
    got = tfp.fused_frontend(planes, torch.zeros(2), ts, 3000)
    assert tfp.frontend_banded.launches == before and bool((got == 0).all())


def test_block_outputs_fit_shared_memory():
    """The kernel's block size: 256 outputs up to D 32, 128 past it, and
    smaller blocks for spans that would not fit; none fits raises."""
    assert tfp._banded_block_outputs(specs("cs8", 32)[1]) == 256
    assert tfp._banded_block_outputs(specs("cs8", 64)[1]) == 128
    assert tfp._banded_block_outputs(specs("cs8", 64, 16_000)[1]) == 64
    with pytest.raises(ValueError, match="shared memory"):
        tfp._banded_block_outputs(specs("cs8", 64, 40_000)[1])
