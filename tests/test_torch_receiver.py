"""The port's receiver chain on the CPU against quadrs_tpu's: the fused
route (``step_stream_fused`` and its search variant) against the JAX
package's XLA chain ``jit_step_stream`` and its Pallas chain
``jit_step_stream_pallas`` (interpreted here); the chain of torch ops
(``step_windows``, ``step_stream``, ``step_stream_search``) against the
XLA chains; and ``StreamRunner`` on both routes against the JAX runner.

Norms agree to ``5e-5 * scale`` (the JAX package's kernel-versus-chain
bound).  Peak bins are exact wherever a window's top two magnitudes
differ by more than that tolerance; ties go to the lowest fftshifted bin
and a NaN wins, as with ``jnp.argmax``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from quadrs_tpu.formats import FileFormat as JFormat  # noqa: E402
from quadrs_tpu.models.receiver import PipelineConfig as JConfig  # noqa: E402
from quadrs_tpu.models.receiver import PipelineModel as JModel  # noqa: E402

from quadrs_tpu_torch.formats import FileFormat  # noqa: E402
from quadrs_tpu_torch.models.receiver import PipelineConfig, PipelineModel  # noqa: E402

TOL = 5e-5


def models(fmt, d, taps, width, fir_impl="auto"):
    args = dict(sample_rate=1_000_000, shift_freq=12_345, lp_freq=50_000, decimate=d, taps=taps, fft_width=width,
                fir_impl=fir_impl)
    return JModel(JConfig(fmt=JFormat(fmt), **args)), PipelineModel(PipelineConfig(fmt=FileFormat(fmt), **args))


def assert_peaks_match(idx, val, want_norms, tol):
    """Bins exact where the window's top two magnitudes are apart by more
    than ``tol``; magnitudes within ``tol``."""
    top2 = np.sort(want_norms, axis=-1)[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > tol
    assert clear.mean() > 0.5
    np.testing.assert_array_equal(idx[clear], np.argmax(want_norms, axis=-1)[clear])
    np.testing.assert_allclose(val, want_norms.max(axis=-1), rtol=0, atol=tol)


# (fmt, decimate, taps, width, absolute offset, zero-padded tail)
CASES = [
    ("cs8", 32, 400, 64, 0, None),
    ("cf32", 3, 40, 64, 999_999_937, None),
    ("cu8", 5, 77, 32, 4096, 3 * 5 * 32),
    ("cs16", 12, 200, 8, 999_999_937, 2 * 12 * 8 + 5),
    ("cu8", 32, 4000, 128, 0, 777),  # m_sub 125: quartered phase tiles
]


@pytest.mark.parametrize("fuse_stft", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("fmt,d,taps,width,offset,tail", CASES)
def test_step_stream_matches_jax(fmt, d, taps, width, offset, tail, fuse_stft):
    jm, tm = models(fmt, d, taps, width)
    n = d * width * 6 + taps + 29
    raw = jm.synth_raw(n, seed=d + width)
    n_valid = None
    if tail is not None:
        raw = np.pad(raw, ((0, 0), (0, tail)))  # zero bytes past the capture
        n_valid = n
    bases = jm.stream_bases(offset, raw.shape[1])
    theta0 = jm.theta0(np.asarray([offset]))[0]

    xla = np.asarray(jm.jit_step_stream(raw, theta0, np.int32(n)))
    pallas = np.asarray(jm.jit_step_stream_pallas(raw, bases, n_valid=n_valid))
    got = tm.step_stream_fused(
        torch.from_numpy(raw), torch.from_numpy(bases), n_valid=n_valid, fuse_stft=fuse_stft
    ).numpy()
    scale = max(np.abs(xla).max(), 1e-6)
    for want in (xla, pallas):
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL * scale)

    idx, val = tm.step_stream_fused_search(
        torch.from_numpy(raw), torch.from_numpy(bases), n_valid=n_valid, fuse_stft=fuse_stft
    )
    assert idx.dtype == torch.int32 and val.dtype == torch.float32
    j_idx, j_val = (np.asarray(a) for a in jm.jit_step_stream_search(raw, theta0, np.int32(n)))
    assert_peaks_match(idx.numpy(), val.numpy(), xla, TOL * scale)
    clear = np.diff(np.sort(xla, axis=-1)[:, -2:], axis=-1)[:, 0] > TOL * scale
    np.testing.assert_array_equal(idx.numpy()[clear], j_idx[clear])
    np.testing.assert_allclose(val.numpy(), j_val, rtol=0, atol=TOL * scale)


def test_peak_reduce_ties_and_nan():
    rng = np.random.default_rng(4)
    norms = rng.uniform(0, 1, (6, 16)).astype(np.float32)
    norms[1, [3, 9]] = 2.0  # a tie: the lowest shifted bin wins
    norms[2, :] = 0.5  # all tied
    norms[3, 7] = np.nan  # a NaN wins
    norms[4, [2, 11]] = np.nan  # the first NaN wins
    norms[5, :] = np.nan
    j_idx, j_val = (np.asarray(a) for a in JModel._peak_reduce(jnp.asarray(norms)))
    t_idx, t_val = PipelineModel._peak_reduce(torch.from_numpy(norms))
    assert t_idx.dtype == torch.int32
    np.testing.assert_array_equal(t_idx.numpy(), j_idx)
    np.testing.assert_array_equal(t_val.numpy(), j_val)  # NaN positions compare equal
    assert list(t_idx.numpy()[1:]) == [3, 0, 7, 2, 0]


def test_nan_capture_row():
    """A NaN sample in a cf32 capture poisons the windows its taps reach:
    their peak is the NaN, at the bin jnp.argmax picks."""
    jm, tm = models("cf32", 8, 40, 32)
    n = 8 * 32 * 6 + 40 + 3
    raw = jm.synth_raw(n, seed=1)
    raw[0, 700] = np.nan
    bases = jm.stream_bases(0, n)
    want = np.asarray(jm.jit_step_stream(raw, jm.theta0(np.asarray([0]))[0], np.int32(n)))
    j_idx, j_val = (np.asarray(a) for a in JModel._peak_reduce(jnp.asarray(want)))
    idx, val = tm.step_stream_fused_search(torch.from_numpy(raw), torch.from_numpy(bases))
    nan_rows = np.isnan(want).any(axis=-1)
    assert nan_rows.any() and not nan_rows.all()
    np.testing.assert_array_equal(np.isnan(val.numpy()), np.isnan(j_val))
    np.testing.assert_array_equal(idx.numpy()[nan_rows], j_idx[nan_rows])


RUNNER_WIN = 8 * 32  # raw samples per window of the runner tests' model


def runner_case():
    """(port model, interleaved cu8 capture of 10 windows and a ragged
    tail, quadrs_tpu's runner's (first window, rows) per 3-window chunk)."""
    from quadrs_tpu.sources import SampleSource as JSource
    from quadrs_tpu.stream_runner import StreamRunner as JRunner

    jm, tm = models("cu8", 8, 60, 32)
    n = 10 * RUNNER_WIN + 77
    data = np.ascontiguousarray(jm.synth_raw(n, seed=9).T).reshape(-1)
    want_rows = []
    JRunner(JSource(data, JFormat.COMPLEX_UINT8, 1_000_000), jm, chunk_samples=3 * RUNNER_WIN).run(
        lambda w0, r: want_rows.append((w0, r))
    )
    return tm, data, want_rows


def test_runner_matches_jax_runner():
    """StreamRunner over an in-memory cu8 capture, 3-window chunks and a
    ragged tail, against quadrs_tpu's runner: the same windows, the same
    norms and peaks, exact resume, ``max_chunks``."""
    check_runner("auto")


def test_runner_chain_route_matches_jax_runner():
    """The same through the chain of torch ops inside the fused envelope."""
    check_runner("chain")


def check_runner(frontend):
    from quadrs_tpu_torch.sources import SampleSource
    from quadrs_tpu_torch.stream_runner import StreamRunner

    tm, data, want_rows = runner_case()
    want = np.concatenate([r for _, r in want_rows])
    tol = TOL * want.max()

    def runner():
        src = SampleSource(data, FileFormat.COMPLEX_UINT8, 1_000_000)
        return StreamRunner(src, tm, "cpu", chunk_samples=3 * RUNNER_WIN + 5, frontend=frontend)

    assert runner().fused == (frontend == "auto")

    rows = []
    stats = runner().run(lambda w0, r: rows.append((w0, r)))
    assert [w0 for w0, _ in rows] == [w0 for w0, _ in want_rows]
    got = np.concatenate([r for _, r in rows])
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    assert stats.windows_out == len(want) and stats.samples_in > 0 and stats.msps > 0

    peaks = []
    runner().run_search(lambda w0, p: peaks.append(p))
    idx = np.concatenate([p[0] for p in peaks])
    val = np.concatenate([p[1] for p in peaks])
    assert_peaks_match(idx, val, want, tol)

    tail = []
    runner().run(lambda w0, r: tail.append(r), start_window=4)
    np.testing.assert_allclose(np.concatenate(tail), want[4:], rtol=0, atol=tol)
    first = []
    assert runner().run(lambda w0, r: first.append(r), max_chunks=1).windows_out == 3
    np.testing.assert_array_equal(first[0], got[:3])


def test_fused_stft_over_runner_chunks_matches_jax_runner():
    """``step_stream_fused(fuse_stft=True)`` over the runner's staged
    chunks, the zero-padded ragged tail included, gives quadrs_tpu's
    runner's windows and norms."""
    from quadrs_tpu_torch.sources import SampleSource
    from quadrs_tpu_torch.stream_runner import StreamRunner

    tm, data, want_rows = runner_case()
    runner = StreamRunner(SampleSource(data, FileFormat.COMPLEX_UINT8, 1_000_000), tm, "cpu",
                          chunk_samples=3 * RUNNER_WIN)
    rows = []
    for off, planes, valid in runner._chunks():
        nv = None if valid == planes.shape[1] else valid
        bases = torch.from_numpy(tm.stream_bases(off, planes.shape[1]))
        rows.append((off // RUNNER_WIN, tm.step_stream_fused(torch.from_numpy(planes), bases, nv, fuse_stft=True)))
    assert any(valid < planes.shape[1] for _, planes, valid in runner._chunks())
    assert [w0 for w0, _ in rows] == [w0 for w0, _ in want_rows]
    want = np.concatenate([r for _, r in want_rows])
    got = torch.cat([r for _, r in rows]).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * want.max())


def test_outside_envelope_raises():
    """The fused route refuses configurations outside its envelope
    (decimate above 64, more than 128 subfilters); the runner's ``auto``
    takes the chain there, and ``fused`` raises."""
    _, tm = models("cs8", 65, 400, 64)
    assert not tm.fused_supported()
    raw = torch.zeros((2, 65 * 64 * 2 + 400), dtype=torch.int8)
    with pytest.raises(ValueError, match="outside the fused"):
        tm.step_stream_fused(raw, torch.zeros(1))
    _, long = models("cs8", 8, 1100, 128)  # m_sub 138
    assert not long.fused_supported()

    from quadrs_tpu_torch.sources import SampleSource
    from quadrs_tpu_torch.stream_runner import StreamRunner

    src = SampleSource(np.zeros(100_000, np.uint8), FileFormat.COMPLEX_INT8, 1_000_000)
    with pytest.raises(ValueError, match="outside the fused"):
        StreamRunner(src, long, "cpu", frontend="fused")
    assert not StreamRunner(src, long, "cpu").fused
    assert StreamRunner(src, models("cs8", 8, 400, 64)[1], "cpu").fused
    with pytest.raises(ValueError, match="frontend must be"):
        StreamRunner(src, long, "cpu", frontend="pallas")
    _, cu8 = models("cu8", 8, 40, 64)
    with pytest.raises(ValueError, match="source format"):
        StreamRunner(src, cu8, "cpu")


# (fmt, decimate, taps, width, absolute offset, zero-padded tail, fir impl)
CHAIN_CASES = [
    ("cs8", 32, 400, 64, 0, None, "auto"),
    ("cf32", 3, 40, 64, 999_999_937, 5, "auto"),
    ("cu8", 100, 400, 32, 4096, 3 * 100 * 32, "auto"),  # outside the fused envelope
    ("cs16", 8, 1100, 64, 999_999_937, 777, "auto"),  # m_sub 138 > 64: premixed taps, os_poly
    ("cu8", 8, 400, 32, 0, 100, "banded"),
    ("cf32", 4, 96, 16, 12_345, None, "overlap_save"),  # premixed taps at m_sub 24
]


@pytest.mark.parametrize("fmt,d,taps,width,offset,tail,impl", CHAIN_CASES)
def test_chain_matches_jax(fmt, d, taps, width, offset, tail, impl):
    """``step_stream`` (with ``valid`` masking), ``step_stream_search`` and
    ``step_windows`` against the JAX package's XLA chains."""
    jm, tm = models(fmt, d, taps, width, impl)
    assert tm._spectral_fir == jm._spectral_fir
    n = d * width * 6 + taps + 29
    raw = jm.synth_raw(n, seed=d + width)
    if tail is not None:
        raw = np.pad(raw, ((0, 0), (0, tail)))  # zero bytes past the capture
    theta0 = jm.theta0(np.asarray([offset]))[0]
    want = np.asarray(jm.jit_step_stream(raw, theta0, np.int32(n)))
    got = tm.step_stream(torch.from_numpy(raw), theta0, n).numpy()
    scale = max(np.abs(want).max(), 1e-6)
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * scale)

    idx, val = tm.step_stream_search(torch.from_numpy(raw), theta0, n)
    assert idx.dtype == torch.int32
    assert_peaks_match(idx.numpy(), val.numpy(), want, TOL * scale)

    b = 5
    windows = jm.synth_raw(b * jm.cfg.window_raw, seed=width).reshape(2, b, -1).transpose(1, 0, 2).copy()
    thetas = jm.theta0(offset + 977 * np.arange(b, dtype=np.int64))
    want = np.asarray(jm.jit_step_windows(windows, thetas))
    got = tm.step_windows(torch.from_numpy(windows), thetas).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * max(np.abs(want).max(), 1e-6))


def test_load_reference_arrays_chain_route():
    """Taps loaded from the JAX package's model drive the chain route,
    the spectral chain's premixed taps included."""
    for d, taps in [(100, 400), (8, 1100)]:
        jm, tm = models("cs16", d, taps, 32)
        jm.taps = (jm.taps * np.float32(1.5)).astype(np.float32)  # not the default taps
        tm.load_reference_arrays({"taps": jm.taps})
        assert tm.taps.numpy().tobytes() == jm.taps.tobytes()
        assert tm._premixed_taps.tobytes() == jm._premixed_taps.tobytes()
        n = d * 32 * 4 + taps
        raw = jm.synth_raw(n, seed=2)
        theta0 = jm.theta0(np.asarray([77]))[0]
        want = np.asarray(jm.jit_step_stream(raw, theta0, np.int32(n)))
        got = tm.step_stream(torch.from_numpy(raw), theta0).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL * np.abs(want).max())
    with pytest.raises(ValueError, match="taps must have shape"):
        tm.load_reference_arrays({"taps": np.zeros(3, np.float32)})


def test_runner_outside_envelope_matches_jax_runner():
    """StreamRunner at decimate 100 (outside the fused envelope) takes the
    chain and gives the JAX runner's windows, norms and peaks over an
    in-memory cu8 capture with a ragged tail; resuming is exact."""
    from quadrs_tpu.sources import SampleSource as JSource
    from quadrs_tpu.stream_runner import StreamRunner as JRunner

    from quadrs_tpu_torch.sources import SampleSource
    from quadrs_tpu_torch.stream_runner import StreamRunner

    jm, tm = models("cu8", 100, 400, 16)
    win = 100 * 16
    n = 9 * win + 333
    data = np.ascontiguousarray(jm.synth_raw(n, seed=4).T).reshape(-1)
    want_rows = []
    JRunner(JSource(data, JFormat.COMPLEX_UINT8, 1_000_000), jm, chunk_samples=3 * win).run(
        lambda w0, r: want_rows.append((w0, r))
    )
    want = np.concatenate([r for _, r in want_rows])
    tol = TOL * want.max()

    def runner():
        return StreamRunner(SampleSource(data, FileFormat.COMPLEX_UINT8, 1_000_000), tm, "cpu", chunk_samples=3 * win)

    assert not runner().fused
    rows = []
    stats = runner().run(lambda w0, r: rows.append((w0, r)))
    assert [w0 for w0, _ in rows] == [w0 for w0, _ in want_rows]
    np.testing.assert_allclose(np.concatenate([r for _, r in rows]), want, rtol=0, atol=tol)
    assert stats.windows_out == len(want)

    peaks = []
    runner().run_search(lambda w0, p: peaks.append(p))
    assert_peaks_match(np.concatenate([p[0] for p in peaks]), np.concatenate([p[1] for p in peaks]), want, tol)
    tail = []
    runner().run(lambda w0, r: tail.append(r), start_window=4)
    np.testing.assert_allclose(np.concatenate(tail), want[4:], rtol=0, atol=tol)
    survey = runner().run_scan(threshold=float(np.median(want)))
    assert survey.windows == len(want)
    np.testing.assert_allclose(survey.sum_norms[0], want.astype(np.float64).sum(0), rtol=1e-5, atol=len(want) * tol)
