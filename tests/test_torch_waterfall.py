"""The port's waterfall bank on the CPU against quadrs_tpu.

The plain versions of the three kernels (``fused_waterfall*`` on CPU
tensors) against the JAX package's Pallas kernels run interpreted; the
model against the JAX model's XLA route; ``WaterfallRunner`` against the
JAX runner over the same bank.  Tolerances are the JAX package's own
(``tests/test_waterfall_pallas.py``): norms ``rtol=2e-5, atol=2e-5·max``;
peak bins exact except near-ties, magnitudes ``rtol=2e-5``; scan sums
``atol=nw·2e-5·max``, maxima ``2e-5·max``, counts exact except for norms
within ``2e-5·max`` of the threshold.  Peaks follow the kernel contract:
the lowest fftshifted bin holding the maximum, and bin ``width-1`` with a
NaN magnitude where a window's norms hold a NaN."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from quadrs_tpu.formats import FileFormat as JFormat  # noqa: E402
from quadrs_tpu.models.waterfall import WaterfallConfig as JConfig  # noqa: E402
from quadrs_tpu.models.waterfall import WaterfallModel as JModel  # noqa: E402
from quadrs_tpu.ops import waterfall_pallas as jw  # noqa: E402

from quadrs_tpu_torch.formats import FileFormat, synth_planes  # noqa: E402
from quadrs_tpu_torch.models.waterfall import WaterfallConfig, WaterfallModel  # noqa: E402
from quadrs_tpu_torch.ops import waterfall as wf  # noqa: E402

RTOL = 2e-5
BH = "blackman-harris"


def specs(fmt: str, width: int, windowing: str):
    return wf.WaterfallSpec(FileFormat(fmt), width, windowing), jw.WaterfallSpec(JFormat(fmt), width, windowing)


def mid_gap_threshold(norms: np.ndarray) -> float:
    """A threshold in the widest gap between norms near the median, as
    the JAX package's scan tests pick it."""
    flat = np.unique(np.sort(norms.ravel()))
    k = len(flat) // 2
    lo = max(0, k - 200)
    j = int(np.argmax(np.diff(flat[lo : k + 200]))) + lo
    return float((flat[j] + flat[j + 1]) / 2)


def assert_peaks(idx, val, norms):
    """Bins exact except where the picked bin's norm is within 2e-5 of
    the window's top; magnitudes to rtol 2e-5."""
    top = norms.max(axis=-1)
    picked = np.take_along_axis(norms, idx[..., None].astype(np.int64), axis=-1)[..., 0]
    same = idx == np.argmax(norms, axis=-1)
    assert np.all(same | (np.abs(picked - top) <= RTOL * np.maximum(top, 1e-9)))
    np.testing.assert_allclose(val, top, rtol=RTOL)


def assert_scan(got, want_norms, thr):
    """(sum, max, count) against the (S, nw, W) norms they reduce."""
    nw, peak = want_norms.shape[1], want_norms.max()
    s, mx, cnt = (np.asarray(a) for a in got)
    np.testing.assert_allclose(s, want_norms.astype(np.float64).sum(axis=1), rtol=0, atol=nw * RTOL * peak)
    np.testing.assert_allclose(mx, want_norms.max(axis=1), rtol=0, atol=RTOL * peak)
    noise = RTOL * peak
    lo = (want_norms > thr + noise).sum(axis=1)
    hi = (want_norms > thr - noise).sum(axis=1)
    assert cnt.dtype == np.float32 and np.all((cnt >= lo) & (cnt <= hi))


# (width, stride, format, windowing, streams, windows): widths 256 and 384
# (b = 3); strides tiled, overlapped 128, not 128-multiples (96, 769) and
# skipping (width + 300); window counts crossing the JAX 128-window tile
CASES = [
    (256, 256, "cs8", "rectangular", 3, 150),
    (384, 384, "cu8", BH, 2, 140),
    (256, 128, "cs16", BH, 2, 200),
    (384, 128, "cf32", "rectangular", 2, 150),
    (256, 96, "cu8", "rectangular", 2, 150),
    (384, 96, "cs8", BH, 2, 130),
    (384, 769, "cs16", "rectangular", 2, 60),
    (256, 556, "cf32", BH, 3, 80),
    (384, 684, "cu8", "rectangular", 2, 50),
]


@pytest.mark.parametrize("width,stride,fmt,windowing,streams,nw", CASES)
def test_plain_versions_match_jax_kernels(width, stride, fmt, windowing, streams, nw):
    spec, jspec = specs(fmt, width, windowing)
    raw = synth_planes(FileFormat(fmt), (nw - 1) * stride + width + 7, seed=width + stride, n_streams=streams)
    planes = torch.from_numpy(raw)

    want = np.asarray(jw.fused_waterfall(jnp.asarray(raw), jspec, nw, stride=stride, interpret=True))
    got = wf.fused_waterfall(planes, spec, nw, stride=stride)
    assert got.dtype == torch.float32 and got.shape == want.shape == (streams, nw, width)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=RTOL * want.max())

    idx, val = wf.fused_waterfall_search(planes, spec, nw, stride=stride)
    j_idx, j_val = (np.asarray(a) for a in jw.fused_waterfall_search(
        jnp.asarray(raw), jspec, nw, stride=stride, interpret=True))
    assert idx.dtype == torch.int32 and idx.shape == (streams, nw)
    assert_peaks(idx.numpy(), val.numpy(), want)
    assert_peaks(j_idx, j_val, want)

    thr = mid_gap_threshold(want)
    got_scan = wf.fused_waterfall_scan(planes, spec, nw, thr, stride=stride)
    j_scan = jw.fused_waterfall_scan(jnp.asarray(raw), jspec, nw, jnp.float32(thr), stride=stride, interpret=True)
    assert all(a.shape == (streams, width) and a.dtype == torch.float32 for a in got_scan)
    assert_scan(got_scan, want, thr)
    assert_scan(j_scan, want, thr)


def test_peak_ties_and_nan_follow_the_kernel():
    """Ties go to the lowest fftshifted bin; a NaN in a cf32 window gives
    bin width-1 and a NaN magnitude — both as
    ``fused_waterfall_search(interpret=True)`` returns them."""
    width = 256
    raw = np.zeros((2, 2, 5 * width), np.float32)
    raw[0, 0, 1 * width] = 1.0  # window 1: a delta, every bin exactly 1
    raw[0, :, 2 * width : 3 * width] = 0.25  # window 2: DC only
    raw[1, 0, 3 * width + 17] = np.nan  # stream 1, window 3: a NaN sample
    raw[1, :, 4 * width :] = np.nan  # stream 1, window 4: all NaN
    spec, jspec = specs("cf32", width, "rectangular")
    j_idx, j_val = (np.asarray(a) for a in jw.fused_waterfall_search(jnp.asarray(raw), jspec, 5, interpret=True))
    idx, val = (a.numpy() for a in wf.fused_waterfall_search(torch.from_numpy(raw), spec, 5))
    np.testing.assert_array_equal(idx, j_idx)
    np.testing.assert_array_equal(val, j_val)  # NaN positions compare equal
    assert list(idx[0]) == [0, 0, width // 2, 0, 0]  # zero windows and the delta tie at bin 0
    assert list(idx[1, 3:]) == [width - 1, width - 1] and np.isnan(val[1, 3:]).all()
    model = WaterfallModel(WaterfallConfig(n_streams=2, fft_width=width, stride=width, fmt=FileFormat.COMPLEX_FLOAT32))
    m_idx, m_val = model.search(torch.from_numpy(raw))
    np.testing.assert_array_equal(m_idx.numpy(), idx)
    # the JAX XLA route disagrees on NaN: jnp.argmax returns the NaN's own index
    x_idx, _ = JModel(JConfig(n_streams=2, fft_width=width, stride=width, fmt=JFormat.COMPLEX_FLOAT32,
                              frontend="xla")).search(jnp.asarray(raw))
    assert list(np.asarray(x_idx)[1, 3:]) != [width - 1, width - 1]


@pytest.mark.parametrize("width,stride,fmt,windowing", [(1024, 256, "cs8", "rectangular"), (512, 700, "cu8", BH)])
def test_model_matches_jax_xla_route(width, stride, fmt, windowing):
    args = dict(n_streams=2, fft_width=width, stride=stride, windowing=windowing)
    jm = JModel(JConfig(fmt=JFormat(fmt), frontend="xla", **args))
    tm = WaterfallModel(WaterfallConfig(fmt=FileFormat(fmt), **args))
    raw = jm.synth_raw(9 * stride + width + 3, seed=3)
    assert raw.shape == (2, 2, 9 * stride + width + 3)
    np.testing.assert_array_equal(tm.synth_raw(raw.shape[-1], seed=3), raw)
    want = np.asarray(jm.jit_step()(jnp.asarray(raw)))
    planes = torch.from_numpy(raw)
    got = tm.step(planes).numpy()
    assert got.shape == want.shape == (2, 10, width)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * want.max())

    idx, val = tm.search(planes)
    j_idx, j_val = (np.asarray(a) for a in jm.search(jnp.asarray(raw)))
    assert_peaks(idx.numpy(), val.numpy(), want)
    np.testing.assert_allclose(val.numpy(), j_val, rtol=RTOL)

    thr = mid_gap_threshold(want)
    got_scan = tm.scan(planes, thr)
    assert_scan(got_scan, want, thr)
    assert_scan(jm.jit_scan()(jnp.asarray(raw), jnp.float32(thr)), want, thr)


def test_window_table_and_reference_arrays():
    from quadrs_tpu.ops.stft import blackman_harris_window as j_bh

    width = 384
    jm = JModel(JConfig(n_streams=1, fft_width=width, stride=width, windowing=BH, frontend="xla"))
    tm = WaterfallModel(WaterfallConfig(n_streams=1, fft_width=width, stride=width, windowing=BH))
    assert tm.window.dtype == torch.float32
    np.testing.assert_array_equal(tm.window.numpy(), j_bh(width))
    np.testing.assert_array_equal(tm.window.numpy(), jm.window)

    raw = tm.synth_raw(4 * width, seed=2)
    before = tm.step(torch.from_numpy(raw))
    tm.load_reference_arrays({"window": np.ones(width, np.float32)})
    flat = tm.step(torch.from_numpy(raw))
    assert not torch.equal(before, flat)
    tm.load_reference_arrays({"window": jm.window})  # round trip
    np.testing.assert_array_equal(tm.window.numpy(), jm.window)
    assert torch.equal(tm.step(torch.from_numpy(raw)), before)

    rect = WaterfallModel(WaterfallConfig(n_streams=1, fft_width=width, stride=width))
    assert rect.window is None
    rect.load_reference_arrays({"window": JModel(JConfig(n_streams=1, fft_width=width)).window})
    with pytest.raises(ValueError, match="window"):
        rect.load_reference_arrays({"window": jm.window})
    with pytest.raises(ValueError, match="window"):
        tm.load_reference_arrays({"window": np.ones(width + 1, np.float32)})


def test_frontend_selection_and_errors():
    planes = torch.zeros((1, 2, 1024), dtype=torch.int8)
    # CPU tensors take the plain chain; the kernel only on CUDA tensors
    assert not WaterfallModel(WaterfallConfig(n_streams=1))._use_kernel(planes)
    # widths outside 128*b run on the plain chain, and the kernel entry points refuse them
    odd = WaterfallModel(WaterfallConfig(n_streams=1, fft_width=96, stride=96))
    assert not odd.kernel_supported()
    assert odd.step(torch.zeros((1, 2, 960), dtype=torch.int8)).shape == (1, 10, 96)
    assert wf.supported(256) and wf.supported(8192) and not wf.supported(128) and not wf.supported(128 * 65)
    spec = wf.WaterfallSpec(FileFormat.COMPLEX_INT8, 96)
    with pytest.raises(ValueError, match="128\\*b"):
        wf.fused_waterfall(torch.zeros((1, 2, 96), dtype=torch.int8), spec, 1)
    spec = wf.WaterfallSpec(FileFormat.COMPLEX_INT8, 256)
    with pytest.raises(ValueError, match="stride"):
        wf.fused_waterfall(planes, spec, 1, stride=0)
    tables = wf.waterfall_tables(spec)
    launches = wf.waterfall_norms.launches, wf.waterfall_search.launches, wf.waterfall_scan.launches
    for kernel in (wf.waterfall_norms, wf.waterfall_search):
        with pytest.raises(ValueError, match="CUDA tensors"):
            kernel(planes, tables, spec, 4, 256)
    with pytest.raises(ValueError, match="CUDA tensors"):
        wf.waterfall_scan(planes, tables, spec, 4, 256, 1.0)
    assert (wf.waterfall_norms.launches, wf.waterfall_search.launches, wf.waterfall_scan.launches) == launches


def test_tables_and_grid():
    """The packed DFT tables against their definitions (f64, then f32),
    and the kernel grid covering every window tile."""
    for width in (256, 384, 8192):
        radices, m = wf.fft_plan(width)
        t = wf.plan_twiddles(width)
        assert t.dtype == np.float32 and t.shape == (wf.twiddles_len(width),)
        z = t.reshape(-1, 2)
        # the second pass (ns 8, radix 8): W_64^{j*r} at (r-1)*8 + j
        r, j = np.meshgrid(np.arange(1, 8), np.arange(8), indexing="ij")
        np.testing.assert_array_equal(z[:56, 0], np.cos(-2 * np.pi * r * j / 64).astype(np.float32).ravel())
        np.testing.assert_array_equal(z[:56, 1], np.sin(-2 * np.pi * r * j / 64).astype(np.float32).ravel())
        if m > 1:  # W_m^k, then the last pass's W_N^{(i mod P) (i div P)}
            i, p = np.arange(width), width // m
            np.testing.assert_array_equal(z[-width - m : -width, 1], np.sin(-2 * np.pi * np.arange(m) / m).astype(np.float32))
            np.testing.assert_array_equal(z[-width:, 0], np.cos(-2 * np.pi * (i % p) * (i // p) / width).astype(np.float32))
    assert [wf.window_tile(w) for w in (256, 384, 1024, 2048, 8192)] == [8, 5, 2, 1, 1]
    # a block's threads (its windows' width/8 each) stay within 1024
    assert [wf.window_tile(w) * w // wf._POINTS for w in (256, 384, 1024, 2048, 8192)] == [256, 240, 256, 256, 1024]
    for s, nw, w in ((64, 2000, 1024), (1, 7, 256), (3, 301, 384), (64, 1, 8192)):
        for blocks in (wf._GRID_BLOCKS, wf._SCAN_GRID_BLOCKS):
            per, groups = wf.kernel_grid(s, nw, w, blocks)
            tiles = -(-nw // wf.window_tile(w))
            assert groups * per >= tiles > (groups - 1) * per
            assert s * groups < blocks + s


def kernel_passes(x: torch.Tensor, width: int) -> torch.Tensor:
    """The kernel's factorization in plain torch, with its host tables:
    radix-R Stockham passes over the power-of-two part (item j's points
    j + r*N/R, twiddled by the pass table, an R-point DFT, stored at
    (j / ns)*ns*R + r*ns + j % ns), then for an odd part m of b the last
    pass's twiddle and a direct m-point DFT.  (rows, N) complex64."""
    radices, m = wf.fft_plan(width)
    pairs = torch.from_numpy(wf.plan_twiddles(width)).view(-1, 2)
    tw = torch.complex(pairs[:, 0], pairs[:, 1])
    data, ns, at = x, 1, 0
    for r in radices:
        j = torch.arange(width // r)
        v = data[:, j[None, :] + (torch.arange(r) * (width // r))[:, None]]  # (rows, r, items)
        if ns > 1:
            w = tw[at : at + (r - 1) * ns].view(r - 1, ns)[:, j % ns]
            v = torch.cat([v[:, :1], v[:, 1:] * w], 1)
            at += (r - 1) * ns
        k = torch.arange(r, dtype=torch.float64)
        v = torch.einsum("kr,brj->bkj", torch.exp(-2j * np.pi * torch.outer(k, k) / r).to(torch.complex64), v)
        dst = ((j // ns) * ns * r + j % ns)[None, :] + (torch.arange(r) * ns)[:, None]
        data = torch.empty_like(data).index_copy_(1, dst.reshape(-1), v.reshape(v.shape[0], -1))
        ns *= r
    if m > 1:
        wm, p, o = tw[at : at + m], width // m, torch.arange(width)
        data = data * tw[at + m : at + m + width]
        idx = (o % p)[:, None] + (torch.arange(m) * p)[None, :]
        data = (data[:, idx] * wm[(torch.arange(m)[None, :] * (o // p)[:, None]) % m]).sum(-1)
    return data


@pytest.mark.parametrize("width", [256, 384, 640, 1024, 2048, 8192])
def test_kernel_factorization_matches_fft(width):
    """The kernel's passes with its f32 tables, in f32, against
    ``torch.fft.fft`` within 1e-5 of the largest bin (f32 rounding over
    log2 N passes; b = 2, 3, 5, 8, 16, 64)."""
    rng = np.random.default_rng(width)
    x = torch.from_numpy((rng.normal(size=(4, width)) + 1j * rng.normal(size=(4, width))).astype(np.complex64))
    want = torch.fft.fft(x)
    got = kernel_passes(x, width)
    assert got.dtype == torch.complex64
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


@pytest.mark.parametrize("fmt", ["cs8", "cu8", "cs16", "cf32"])
def test_decode_tables(fmt):
    """The kernel's 256-entry decode tables, indexed by the byte's unsigned
    value, are bitwise the port's decode of every code, and that decode is
    the reference formula in IEEE f32; cs16 and cf32 take no table."""
    from quadrs_tpu_torch.formats import decode_plane

    fmt = FileFormat(fmt)
    table = wf.decode_table(fmt)
    if fmt in (FileFormat.COMPLEX_INT16, FileFormat.COMPLEX_FLOAT32):
        assert table is None and wf.waterfall_tables(wf.WaterfallSpec(fmt, 256)).decode is None
        return
    codes = np.arange(256, dtype=np.uint8).view(np.int8 if fmt is FileFormat.COMPLEX_INT8 else np.uint8)
    assert table.dtype == np.float32 and table.shape == (256,)
    np.testing.assert_array_equal(table.view(np.uint32), decode_plane(codes, fmt).view(np.uint32))
    np.testing.assert_array_equal(
        table.view(np.uint32), decode_plane(torch.from_numpy(codes), fmt).numpy().view(np.uint32))
    if fmt is FileFormat.COMPLEX_INT8:
        want = codes.astype(np.float32) / np.float32(127.0)
    else:
        want = codes.astype(np.float32) / np.float32(255.0) - np.float32(127.5)
    np.testing.assert_array_equal(table.view(np.uint32), want.view(np.uint32))
    assert torch.equal(wf.waterfall_tables(wf.WaterfallSpec(fmt, 256)).decode, torch.from_numpy(table))


def test_overlapped_frames_match_jax():
    from quadrs_tpu.ops.fir import _overlapped_frames

    from quadrs_tpu_torch.ops.fir import overlapped_frames

    x = np.random.default_rng(5).normal(size=(3, 1000)).astype(np.float32)
    for hop, m, n in ((64, 256, 12), (96, 256, 8), (300, 256, 4), (256, 256, 3)):
        want = np.asarray(_overlapped_frames(jnp.asarray(x), hop, m, n))
        got = overlapped_frames(torch.from_numpy(x), hop, m, n).numpy()
        np.testing.assert_array_equal(got, want)


RUN_CASES = [
    # (width, stride, chunk windows, start window): overlapped, not a
    # 128-multiple, chunks not dividing the window count; skipping
    (256, 96, 7, 0),
    (256, 96, 7, 5),
    (384, 500, 4, 3),
]


@pytest.mark.parametrize("width,stride,chunk,start", RUN_CASES)
def test_runner_matches_jax_runner(width, stride, chunk, start):
    from quadrs_tpu.sources import SampleSource as JSource
    from quadrs_tpu.stream_runner import WaterfallRunner as JRunner

    from quadrs_tpu_torch.sources import SampleSource
    from quadrs_tpu_torch.stream_runner import WaterfallRunner

    args = dict(n_streams=3, fft_width=width, stride=stride)
    jm = JModel(JConfig(fmt=JFormat.COMPLEX_UINT8, frontend="xla", **args))
    tm = WaterfallModel(WaterfallConfig(fmt=FileFormat.COMPLEX_UINT8, **args))
    n = 30 * stride + width + 41  # 31 windows, a ragged last chunk
    data = [np.ascontiguousarray(p.T).reshape(-1) for p in jm.synth_raw(n, seed=7)]

    def both():
        return (
            JRunner([JSource(d, JFormat.COMPLEX_UINT8, 48_000) for d in data], jm, chunk_windows=chunk),
            WaterfallRunner([SampleSource(d, FileFormat.COMPLEX_UINT8, 48_000) for d in data], tm, "cpu",
                            chunk_windows=chunk),
        )

    def collect(run):
        rows = []
        stats = run(lambda w0, out: rows.append((w0, out)), start_window=start)
        return stats, rows

    (jr, tr) = both()
    (js, jrows), (ts, trows) = collect(jr.run), collect(tr.run)
    assert [w for w, _ in trows] == [w for w, _ in jrows] and len(trows) > 2
    want = np.concatenate([r for _, r in jrows], axis=1)
    np.testing.assert_allclose(np.concatenate([r for _, r in trows], axis=1), want, rtol=RTOL, atol=RTOL * want.max())
    assert (ts.samples_in, ts.windows_out) == (js.samples_in, js.windows_out)

    (js, jrows), (ts, trows) = collect(jr.run_search), collect(tr.run_search)
    assert [w for w, _ in trows] == [w for w, _ in jrows]
    idx = np.concatenate([o[0] for _, o in trows], axis=1)
    val = np.concatenate([o[1] for _, o in trows], axis=1)
    assert_peaks(idx, val, want)
    assert (ts.samples_in, ts.windows_out) == (js.samples_in, js.windows_out)

    thr = mid_gap_threshold(want)
    j_res = jr.run_scan(thr, start_window=start)
    t_res = tr.run_scan(thr, start_window=start)
    assert t_res.windows == j_res.windows == want.shape[1]
    assert (t_res.stats.samples_in, t_res.stats.windows_out) == (j_res.stats.samples_in, j_res.stats.windows_out)
    assert t_res.sum_norms.dtype == np.float64 and t_res.above.dtype == np.int64
    assert_scan((t_res.sum_norms, t_res.max_norms, t_res.above.astype(np.float32)), want, thr)
    np.testing.assert_allclose(t_res.avg, j_res.avg, rtol=RTOL, atol=RTOL * want.max())
    assert t_res.threshold == j_res.threshold

    first = []
    assert tr.run(lambda w0, r: first.append(r), start_window=start, max_chunks=1).windows_out == 3 * min(chunk, 31 - start)
    assert len(first) == 1


def test_runner_checks_its_bank():
    from quadrs_tpu_torch.sources import SampleSource
    from quadrs_tpu_torch.stream_runner import WaterfallRunner

    model = WaterfallModel(WaterfallConfig(n_streams=2, fft_width=256, stride=256))
    src = SampleSource(np.zeros(4096, np.uint8), FileFormat.COMPLEX_INT8, 48_000)
    with pytest.raises(ValueError, match="2-stream bank"):
        WaterfallRunner([src], model, "cpu")
    with pytest.raises(ValueError, match="equal lengths"):
        WaterfallRunner([src, SampleSource(np.zeros(4000, np.uint8), FileFormat.COMPLEX_INT8, 48_000)], model, "cpu")
    with pytest.raises(ValueError, match="bank format"):
        WaterfallRunner([src, SampleSource(np.zeros(4096, np.uint8), FileFormat.COMPLEX_UINT8, 48_000)], model, "cpu")
    short = SampleSource(np.zeros(200, np.uint8), FileFormat.COMPLEX_INT8, 48_000)
    res = WaterfallRunner([short, short], model, "cpu").run_scan(1.0)
    assert res.windows == 0 and res.stats.windows_out == 0 and np.all(res.max_norms == 0)
