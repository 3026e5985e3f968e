"""The port's mesh execution (``quadrs_tpu_torch.parallel.sharding`` and
the runners' ``mesh=``) on the CPU against quadrs_tpu's, case for case
with ``tests/test_model_and_sharding.py``, ``tests/test_stream_runner.py``,
``tests/test_scan.py``, ``tests/test_waterfall_pallas.py``,
``tests/test_pipe_source.py``, ``tests/test_find.py`` and
``tests/test_channelizer.py``.

The JAX side runs its own mesh on the 8 virtual CPU devices of
``tests/conftest.py``, on its XLA route; the port's side runs
``make_mesh(T, S, devices=[cpu] * (T * S))``: the CPU standing for every
device of the mesh.  Each sharded result is held to the JAX package's
sharded result and to the port's single-device run: bit-exact where the
single-device run is (peak bins, survey counts, ``find`` offsets and
``which``), norms within ``5e-5 * scale`` of the JAX package's (the
receiver chain's bound; the port plans each shard's fused bases exactly
from its absolute offset where the JAX package adds a delta table in f32)
and within ``1e-5 * scale`` of the port's single-device run, waterfall
norms to the bank's ``rtol 2e-5``, ``find`` scores within ``2e-4``,
channels within ``2e-6`` of their block's scale."""

import io

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from quadrs_tpu import sinks as jsinks  # noqa: E402
from quadrs_tpu import sources as jsources  # noqa: E402
from quadrs_tpu import stream as jstream  # noqa: E402
from quadrs_tpu import stream_runner as jrunner  # noqa: E402
from quadrs_tpu.formats import FileFormat as JFormat  # noqa: E402
from quadrs_tpu.models import channelizer as jchan  # noqa: E402
from quadrs_tpu.models.receiver import PipelineConfig as JConfig  # noqa: E402
from quadrs_tpu.models.receiver import PipelineModel as JModel  # noqa: E402
from quadrs_tpu.models.waterfall import WaterfallConfig as JWConfig  # noqa: E402
from quadrs_tpu.models.waterfall import WaterfallModel as JWModel  # noqa: E402
from quadrs_tpu.parallel import sharding as jsh  # noqa: E402

from quadrs_tpu_torch import sinks as tsinks  # noqa: E402
from quadrs_tpu_torch import stream as tstream  # noqa: E402
from quadrs_tpu_torch.formats import FileFormat  # noqa: E402
from quadrs_tpu_torch.models import channelizer as tchan  # noqa: E402
from quadrs_tpu_torch.models.receiver import PipelineConfig, PipelineModel  # noqa: E402
from quadrs_tpu_torch.models.waterfall import WaterfallConfig, WaterfallModel  # noqa: E402
from quadrs_tpu_torch.parallel import sharding as tsh  # noqa: E402
from quadrs_tpu_torch.sources import PipeSource, SampleSource  # noqa: E402
from quadrs_tpu_torch.stream_runner import StreamRunner, WaterfallRunner  # noqa: E402

CPU = torch.device("cpu")
TOL = 5e-5  # the port against the JAX package, of the largest norm
SELF_TOL = 1e-5  # the port's mesh against its single-device run
WF_RTOL = 2e-5
CFG = dict(sample_rate=1_000_000, shift_freq=12_500, lp_freq=50_000, decimate=8, taps=64, fft_width=32)


def models(fmt="cf32", **over):
    args = {**CFG, **over}
    return JModel(JConfig(fmt=JFormat(fmt), **args)), PipelineModel(PipelineConfig(fmt=FileFormat(fmt), **args))


def tmesh(n_time, n_stream=1):
    return tsh.make_mesh(n_time, n_stream, devices=[CPU] * (n_time * n_stream))


def jmesh(n_time, n_stream=1):
    return jsh.make_mesh(n_time, n_stream)


def blocks_of(raw, mesh, tail=None):
    """A chunk ``raw`` and its continuation ``tail`` on the mesh, as the
    JAX package's ``shard_chunk`` and ``replicate_tail`` place them: the
    last shard's halo is ``tail``; no tail, no halo."""
    if tail is None:
        return tsh.shard_span(raw, mesh, 0)
    return tsh.shard_span(np.concatenate([raw, tail], axis=-1), mesh, tail.shape[-1])


def bases_of(model, mesh, off, n_local, cols):
    """Each shard's fused NCO bases on its device, as the runner stages
    them (:func:`shard_bases`)."""
    return [[torch.from_numpy(tsh.shard_bases(model, off, n_local, cols, t)).to(d) for t, d in enumerate(row)]
            for row in mesh.devices]


def joined(outs):
    """Shard outputs joined along the window axis, on the host."""
    out = tsh.join(outs, 1)
    return tuple(o.numpy() for o in out) if isinstance(out, tuple) else out.numpy()


def cf32_bytes(data: np.ndarray) -> np.ndarray:
    inter = np.empty((len(data), 2), dtype=np.float32)
    inter[:, 0], inter[:, 1] = data.real, data.imag
    return inter.reshape(-1).view(np.uint8)


def sources(data: np.ndarray, fmt="cf32", sr=CFG["sample_rate"]):
    """The same bytes as a JAX and a port source (``data``: complex
    samples for cf32, else raw bytes)."""
    raw = cf32_bytes(data) if fmt == "cf32" else data
    return jsources.SampleSource(raw, JFormat(fmt), sr), SampleSource(raw, FileFormat(fmt), sr)


def noise(rng, n):
    return (rng.normal(size=n) + 1j * rng.normal(size=n)).astype(np.complex64)


def rows_of(run, **kw):
    """``{window: row}`` (or ``{window: (S, W) rows}`` of a bank) from a
    runner's ``run``, with its stats."""
    rows: dict[int, np.ndarray] = {}

    def on(w0, norms):
        for i in range(norms.shape[-2]):
            rows[w0 + i] = norms[..., i, :]

    return rows, run(on, **kw)


def peaks_of(run, **kw):
    got: dict[int, tuple[int, float]] = {}

    def on(w0, out):
        for i in range(len(out[0])):
            got[w0 + i] = (int(out[0][i]), float(out[1][i]))

    run(on, **kw)
    return got


def assert_counts(got: np.ndarray, want: np.ndarray, rows: dict, thr: float):
    """Survey counts of a mesh run against the single-device run's: equal
    but for windows whose norm lies within the mesh's tolerance of the
    threshold (the shards' phase tiles start elsewhere, so norms differ
    in the last bits)."""
    norms = np.stack(list(rows.values()))
    band = SELF_TOL * float(norms.max())
    near = (np.abs(norms - np.float32(thr)) <= band).sum(axis=0)
    assert np.all(np.abs(got - want) <= near)


def assert_rows(got: dict, want: dict, tol: float):
    assert set(got) == set(want) and got
    scale = max(float(np.abs(v).max()) for v in want.values())
    for w in want:
        np.testing.assert_allclose(got[w], want[w], rtol=0, atol=tol * scale, err_msg=f"window {w}")


# -- the halo helpers --------------------------------------------------------


@pytest.mark.parametrize("decimate", [1, 2, 3, 8, 32, 64, 100])
@pytest.mark.parametrize("taps", [1, 2, 7, 40, 64, 65, 400, 4001])
def test_halo_helpers_equal_their_originals(decimate, taps):
    from types import SimpleNamespace

    cfg = SimpleNamespace(taps=taps, decimate=decimate, fft_width=taps + 64, stride=decimate * 64)
    assert tsh.halo_samples(cfg) == jsh.halo_samples(cfg)
    assert tsh.waterfall_halo(cfg) == jsh.waterfall_halo(cfg)
    assert tsh.find_halo(taps + 1) == jsh.find_halo(taps + 1)
    assert tsh.channelize_halo(taps) == jsh.channelize_halo(taps)


def test_make_mesh():
    mesh = tsh.make_mesh(4, 2, devices=[CPU] * 8)
    assert mesh.shape == {"stream": 2, "time": 4} and mesh.distinct == [CPU]
    assert mesh == tmesh(4, 2) and hash(mesh) == hash(tmesh(4, 2)) and mesh != tmesh(2, 4)
    with pytest.raises(ValueError, match="need 8 devices, have 4"):
        tsh.make_mesh(4, 2, devices=[CPU] * 4)
    with pytest.raises(ValueError) as want:
        jsh.make_mesh(16, 1)
    with pytest.raises(ValueError) as got:
        tsh.make_mesh(16, 1, devices=[CPU] * 8)
    assert str(got.value) == str(want.value)


def test_default_devices(monkeypatch):
    """The CPU platform's default mesh is the CPU 8 times over (the JAX
    tests' 8 virtual devices); otherwise every CUDA card by its index, none
    on a machine without one."""
    monkeypatch.setenv("QUADRS_PLATFORM", "cpu")
    assert tsh.make_mesh(8).devices == ((CPU,) * 8,)
    with pytest.raises(ValueError, match="need 9 devices, have 8"):
        tsh.make_mesh(9)
    monkeypatch.delenv("QUADRS_PLATFORM")
    devs = tsh.default_devices()
    assert devs == [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    assert all(d.index is not None for d in devs)


# -- the sharded steps (tests/test_model_and_sharding.py) --------------------


def sharded_step_case(fmt, taps, n_time, n_stream, offset, frontend="auto", seed=0):
    jm, tm = models(fmt, taps=taps)
    cfg = tm.cfg
    halo = tsh.halo_samples(cfg)
    n_local = cfg.decimate * cfg.fft_width * 2
    total = n_time * n_local
    raws = np.stack([jm.synth_raw(total + halo, seed=seed + s) for s in range(n_stream)])
    tm_mesh = tmesh(n_time, n_stream)
    got = joined(tsh.make_sharded_stream_step(tm, tm_mesh, frontend=frontend)(
        blocks_of(raws[:, :, :total], tm_mesh, tail=raws[:, :, total:]), offset,
        bases_of(tm, tm_mesh, offset, n_local, n_local + halo)))
    mesh = jmesh(n_time, n_stream)
    theta0 = jm.theta0(offset + np.arange(n_time, dtype=np.int64) * n_local)
    jax_mesh = np.asarray(jsh.make_sharded_stream_step(jm, mesh)(
        jsh.shard_chunk(raws[:, :, :total], mesh),
        jsh.shard_chunk(np.broadcast_to(theta0[None], (n_stream, n_time)).copy(), mesh),
        jsh.replicate_tail(raws[:, :, total:], mesh),
    ))
    # the port's single-device step over the same span (chunk + true tail)
    single = np.stack([
        tm.step_stream_fused(torch.from_numpy(raws[s]), torch.from_numpy(tm.stream_bases(offset, total + halo))).numpy()
        if tm.fused_supported() and frontend != "chain" else
        tm.step_stream(torch.from_numpy(raws[s]), tm.theta0(np.asarray([offset]))[0]).numpy()
        for s in range(n_stream)
    ])
    return got, jax_mesh, single


@pytest.mark.parametrize("fmt", ["cs8", "cf32"])
def test_sharded_step_matches_single_device(fmt):
    """A 4x2 mesh: every window equals the single-device step over the
    same samples, the last shard's included (its halo is the fed tail)."""
    got, jax_mesh, single = sharded_step_case(fmt, 64, 4, 2, 0)
    assert got.shape == jax_mesh.shape == single.shape == (2, 8, 32)
    np.testing.assert_allclose(got, jax_mesh, rtol=0, atol=TOL * jax_mesh.max())
    np.testing.assert_allclose(got, single, rtol=0, atol=SELF_TOL * single.max())


@pytest.mark.parametrize("offset", [0, 999_999_937, 4_294_967_291])
@pytest.mark.parametrize("fmt", ["cs8", "cu8", "cs16", "cf32"])
def test_sharded_step_phases_at_large_offsets(fmt, offset):
    """Each shard's phase is planned from its absolute offset, far from
    zero too: the mesh equals the single-device step started at the same
    offset, and the JAX package's mesh."""
    got, jax_mesh, single = sharded_step_case(fmt, 64, 4, 1, offset, seed=3)
    np.testing.assert_allclose(got, jax_mesh, rtol=0, atol=TOL * jax_mesh.max())
    np.testing.assert_allclose(got, single, rtol=0, atol=SELF_TOL * single.max())


def test_sharded_fused_route_matches_sharded_chain_route():
    """The fused route sharded against the chain of torch ops sharded
    (the JAX package's pallas-against-xla case)."""
    fused, jax_mesh, _ = sharded_step_case("cs8", 64, 4, 1, 12_345, frontend="fused")
    chain, _, _ = sharded_step_case("cs8", 64, 4, 1, 12_345, frontend="chain")
    np.testing.assert_allclose(fused, chain, rtol=0, atol=TOL * chain.max())
    np.testing.assert_allclose(chain, jax_mesh, rtol=0, atol=TOL * jax_mesh.max())


def test_sharded_odd_taps_matches_single_device():
    got, jax_mesh, single = sharded_step_case("cs8", 65, 4, 1, 0, seed=20)
    np.testing.assert_allclose(got, jax_mesh, rtol=0, atol=TOL * jax_mesh.max())
    np.testing.assert_allclose(got, single, rtol=0, atol=SELF_TOL * single.max())


def test_sharded_search_step_matches_norms():
    """``search=True`` reduces each shard's windows to their peak: the
    argmax and max of the sharded norms."""
    jm, tm = models("cs8")
    halo = tsh.halo_samples(tm.cfg)
    total = 4 * 8 * 32 * 3
    raw = jm.synth_raw(total + halo, seed=5)[None]
    blocks = blocks_of(raw[:, :, :total], tmesh(4), tail=raw[:, :, total:])
    bases = bases_of(tm, tmesh(4), 77, total // 4, total // 4 + halo)
    norms = joined(tsh.make_sharded_stream_step(tm, tmesh(4))(blocks, 77, bases))
    idx, val = joined(tsh.make_sharded_stream_step(tm, tmesh(4), search=True)(blocks, 77, bases))
    np.testing.assert_array_equal(idx, np.argmax(norms, axis=-1))
    np.testing.assert_array_equal(val, norms.max(axis=-1))


def test_sharded_steps_are_memoized_and_validate():
    _, tm = models("cs8")
    step = tsh.make_sharded_stream_step(tm, tmesh(4))
    assert tsh.make_sharded_stream_step(tm, tmesh(4)) is step
    assert tsh.make_sharded_stream_step(tm, tmesh(4), search=True) is not step
    halo = tsh.halo_samples(tm.cfg)
    short = blocks_of(np.zeros((1, 2, 4 * 32), np.int8), tmesh(4), tail=np.zeros((1, 2, halo), np.int8))
    with pytest.raises(ValueError, match="shorter than the 88-sample halo"):
        step(short, 0)
    with pytest.raises(ValueError, match="2 x 4 grid"):
        tsh.make_sharded_stream_step(tm, tmesh(4, 2))(short, 0)
    with pytest.raises(ValueError, match="group delay"):
        tsh.make_sharded_stream_step(models("cs8", taps=4000)[1], tmesh(2))
    with pytest.raises(ValueError, match="equal time shards"):
        blocks_of(np.zeros((1, 2, 30), np.int8), tmesh(4))
    whole = blocks_of(np.zeros((1, 2, 4 * 256), np.int8), tmesh(4), tail=np.zeros((1, 2, halo), np.int8))
    with pytest.raises(ValueError, match="NCO bases"):
        step(whole, 0)


# -- the sharded waterfall step (tests/test_waterfall_pallas.py) --------------


def wf_models(n_streams, width, stride, fmt="cs8", windowing="rectangular"):
    kw = dict(n_streams=n_streams, fft_width=width, stride=stride, windowing=windowing)
    return (JWModel(JWConfig(fmt=JFormat(fmt), frontend="xla", **kw)),
            WaterfallModel(WaterfallConfig(fmt=FileFormat(fmt), **kw)))


@pytest.mark.parametrize("stride", [256, 128, 384])
def test_sharded_waterfall_strided(stride):
    """Tiled, overlapped (a halo of width - stride) and skipping strides
    (no halo): the 4x2 mesh equals the single-device step over the same
    span and the JAX package's mesh; peaks too."""
    jm, tm = wf_models(2, 256, stride)
    halo = tsh.waterfall_halo(tm.cfg)
    n = 4 * 3 * stride
    full = jm.synth_raw(n + halo, seed=15)
    raw, tail = full[:, :, :n], full[:, :, n:]
    mesh = tmesh(4, 2)
    got = joined(tsh.make_sharded_waterfall_step(tm, mesh)(blocks_of(raw, mesh, tail=tail if halo else None)))
    single = tm.step(torch.from_numpy(full)).numpy()[:, : n // stride]
    j = jmesh(4, 2)
    jstep = jsh.make_sharded_waterfall_step(jm, j)
    jax_mesh = np.asarray(jstep(jsh.shard_chunk(raw, j), jsh.replicate_tail(tail, j)) if halo else jstep(jsh.shard_chunk(raw, j)))
    assert got.shape == single.shape == jax_mesh.shape
    np.testing.assert_array_equal(got, single)
    np.testing.assert_allclose(got, jax_mesh, rtol=WF_RTOL, atol=WF_RTOL * jax_mesh.max())
    idx, val = joined(tsh.make_sharded_waterfall_step(tm, mesh, search=True)(
        blocks_of(raw, mesh, tail=tail if halo else None)))
    np.testing.assert_array_equal(idx, np.argmax(single, axis=-1))
    np.testing.assert_array_equal(val, single.max(axis=-1))


def test_sharded_waterfall_rejects_ragged_shards():
    _, tm = wf_models(2, 1024, 1024)
    step = tsh.make_sharded_waterfall_step(tm, tmesh(4, 2))
    bad = tm.synth_raw(4 * (1024 + 512), seed=3)  # shards not whole strides
    with pytest.raises(ValueError, match="stride"):
        step(blocks_of(bad, tmesh(4, 2)))
    with pytest.raises(ValueError, match="'stream' mesh rows"):
        blocks_of(tm.synth_raw(4 * 1024, seed=3)[:1], tmesh(4, 2))


def test_sharded_waterfall_wide_blackman_harris():
    """A wide width (2048) with an overlapped stride and the
    Blackman-Harris window on a 4x1 mesh."""
    jm, tm = wf_models(1, 2048, 1024, windowing="blackman-harris")
    halo = tsh.waterfall_halo(tm.cfg)
    n = 4 * 2 * 1024
    full = jm.synth_raw(n + halo, seed=21)
    got = joined(tsh.make_sharded_waterfall_step(tm, tmesh(4))(
        blocks_of(full[:, :, :n], tmesh(4), tail=full[:, :, n:])))
    j = jmesh(4)
    want = np.asarray(jsh.make_sharded_waterfall_step(jm, j)(jsh.shard_chunk(full[:, :, :n], j),
                                                              jsh.replicate_tail(full[:, :, n:], j)))
    np.testing.assert_allclose(got, want, rtol=3e-5, atol=3e-5 * want.max())
    np.testing.assert_array_equal(got, tm.step(torch.from_numpy(full)).numpy()[:, : n // 1024])


# -- StreamRunner on a mesh (tests/test_stream_runner.py) ---------------------


def runner_pair(jsrc, tsrc, jm, tm, chunk, n_time=None, n_stream=1):
    """The JAX and the port's runner over the same source(s); a mesh when
    ``n_time`` is given."""
    if n_time is None:
        return jrunner.StreamRunner(jsrc, jm, chunk_samples=chunk), StreamRunner(tsrc, tm, CPU, chunk_samples=chunk)
    return (jrunner.StreamRunner(jsrc, jm, chunk_samples=chunk, mesh=jmesh(n_time, n_stream)),
            StreamRunner(tsrc, tm, CPU, chunk_samples=chunk, mesh=tmesh(n_time, n_stream)))


def test_sharded_runner_matches_single_device():
    rng = np.random.default_rng(23)
    jm, tm = models()
    win = 8 * 32
    jsrc, tsrc = sources(noise(rng, win * 40 + 64 * 2))
    single, _ = rows_of(runner_pair(jsrc, tsrc, jm, tm, win * 8)[1].run)
    jr, tr = runner_pair(jsrc, tsrc, jm, tm, win * 16, n_time=4)
    got, stats = rows_of(tr.run)
    want, jstats = rows_of(jr.run)
    assert_rows(got, single, SELF_TOL)
    assert_rows(got, want, TOL)
    assert (stats.samples_in, stats.windows_out) == (jstats.samples_in, jstats.windows_out)


def test_sharded_resume_matches_full_sharded_run():
    rng = np.random.default_rng(31)
    jm, tm = models()
    win = 8 * 32
    jsrc, tsrc = sources(noise(rng, win * 40 + 64 * 3))
    full, _ = rows_of(runner_pair(jsrc, tsrc, jm, tm, win * 8, n_time=4)[1].run)
    jr, tr = runner_pair(jsrc, tsrc, jm, tm, win * 8, n_time=4)
    resumed, _ = rows_of(tr.run, start_window=16)
    assert min(resumed) == 16 and max(resumed) == max(full)
    assert_rows(resumed, {w: full[w] for w in resumed}, SELF_TOL)
    assert_rows(resumed, rows_of(jr.run, start_window=16)[0], TOL)


def test_sharded_bank_n_stream_2():
    """Two captures as a bank over a (2, 2) mesh: each stream's rows equal
    its own single-device run, and the JAX bank's."""
    rng = np.random.default_rng(37)
    jm, tm = models()
    win = 8 * 32
    pairs = [sources(noise(rng, win * 24 + 64 * 2)) for _ in range(2)]
    jr, tr = runner_pair([p[0] for p in pairs], [p[1] for p in pairs], jm, tm, win * 8, n_time=2, n_stream=2)
    bank, stats = rows_of(tr.run)
    jbank, _ = rows_of(jr.run)
    assert stats.windows_out == 2 * len(bank)
    assert_rows(bank, jbank, TOL)
    for s, (_, tsrc) in enumerate(pairs):
        single, _ = rows_of(StreamRunner(tsrc, tm, CPU, chunk_samples=win * 8).run)
        assert_rows({w: r[s] for w, r in bank.items()}, single, SELF_TOL)


def test_sharded_bank_search_and_scan():
    """A bank's peaks and survey on a (2, 2) mesh: each stream's its own
    single-device run's (bins and counts equal, sums within f32 order)."""
    rng = np.random.default_rng(38)
    _, tm = models()
    win = 8 * 32
    pairs = [sources(noise(rng, win * 24 + 77)) for _ in range(2)]
    tr = StreamRunner([p[1] for p in pairs], tm, CPU, chunk_samples=win * 8, mesh=tmesh(2, 2))
    got: dict[int, tuple] = {}

    def on(w0, out):
        for i in range(out[0].shape[1]):
            got[w0 + i] = (out[0][:, i], out[1][:, i])

    tr.run_search(on)
    scan = tr.run_scan(threshold=2.0)
    for s, (_, tsrc) in enumerate(pairs):
        single = StreamRunner(tsrc, tm, CPU, chunk_samples=win * 8)
        want = peaks_of(single.run_search)
        assert set(got) == set(want)
        assert all(got[w][0][s] == want[w][0] for w in want)
        one = single.run_scan(threshold=2.0)
        assert scan.windows == one.windows
        assert_counts(scan.above[s], one.above[0], rows_of(single.run)[0], 2.0)
        np.testing.assert_allclose(scan.sum_norms[s], one.sum_norms[0], rtol=1e-5)
        np.testing.assert_allclose(scan.max_norms[s], one.max_norms[0], rtol=SELF_TOL)


def test_sharded_runner_halo_wider_than_window():
    """A halo spanning several STFT windows widens the chunk quantum so
    that every time shard covers it."""
    rng = np.random.default_rng(43)
    jm, tm = models(taps=192, fft_width=16)
    win = 8 * 16
    jsrc, tsrc = sources(noise(rng, win * 64 + 192 * 2))
    single, _ = rows_of(StreamRunner(tsrc, tm, CPU, chunk_samples=win * 8).run)
    jr, tr = runner_pair(jsrc, tsrc, jm, tm, win * 4, n_time=4)
    assert tr.chunk_samples // 4 >= 280 and tr.chunk_samples == jr.chunk_samples
    got, _ = rows_of(tr.run)
    assert_rows(got, single, SELF_TOL)
    assert_rows(got, rows_of(jr.run)[0], TOL)


def test_bank_requires_mesh_and_equal_lengths():
    _, tm = models()
    a = SampleSource(cf32_bytes(np.zeros(4096, np.complex64)), FileFormat.COMPLEX_FLOAT32, 1_000_000)
    b = SampleSource(cf32_bytes(np.zeros(8192, np.complex64)), FileFormat.COMPLEX_FLOAT32, 1_000_000)
    with pytest.raises(ValueError, match="needs a mesh"):
        StreamRunner([a, a], tm, CPU)
    with pytest.raises(ValueError, match="equal lengths"):
        StreamRunner([a, b], tm, CPU, mesh=tmesh(1, 2))
    with pytest.raises(ValueError, match="2 stream shards for 1 sources"):
        StreamRunner(a, tm, CPU, mesh=tmesh(1, 2))
    with pytest.raises(ValueError, match="'stream' mesh rows"):
        WaterfallRunner([a] * 3, WaterfallModel(WaterfallConfig(n_streams=3, fmt=FileFormat.COMPLEX_FLOAT32)), CPU,
                        mesh=tmesh(1, 2))


@pytest.mark.parametrize("trial", range(5))
def test_sharded_runner_fuzz_matches_single_device(trial):
    """Random (taps, decimate, fft_width, chunk, mesh) draws: the mesh run
    equals the single-device run, stream by stream, and the JAX mesh run
    (``tests/test_stream_runner.py``'s fuzz, one draw a case)."""
    rng = np.random.default_rng(0xF022 + trial)
    decimate = int(rng.choice([2, 3, 5, 8, 16]))
    taps = int(rng.integers(3, 40)) * decimate // 2 * 2 + 2
    fft_width = int(rng.choice([16, 32, 64]))
    while taps // 2 // decimate >= fft_width:
        fft_width *= 2
    n_stream, n_time = int(rng.choice([1, 2])), int(rng.choice([2, 4]))
    jm, tm = models(shift_freq=int(rng.integers(1_000, 400_000)), decimate=decimate, taps=taps, fft_width=fft_width)
    win = decimate * fft_width
    n = win * int(rng.integers(16, 40)) + int(rng.integers(0, 2 * taps))
    chunk = win * int(rng.integers(2, 10))
    pairs = [sources(noise(rng, n)) for _ in range(n_stream)]
    jsrcs, tsrcs = [p[0] for p in pairs], [p[1] for p in pairs]
    jr, tr = runner_pair(jsrcs if n_stream > 1 else jsrcs[0], tsrcs if n_stream > 1 else tsrcs[0], jm, tm, chunk,
                         n_time=n_time, n_stream=n_stream)
    got, _ = rows_of(tr.run)
    assert_rows(got, rows_of(jr.run)[0], TOL)
    for s in range(n_stream):
        single, _ = rows_of(StreamRunner(tsrcs[s], tm, CPU, chunk_samples=chunk).run)
        assert_rows({w: (r[s] if n_stream > 1 else r) for w, r in got.items()}, single, SELF_TOL)


def test_sharded_stream_runner_search_matches_single_device():
    rng = np.random.default_rng(78)
    jm, tm = models()
    win = 8 * 32
    jsrc, tsrc = sources(noise(rng, win * 40 + 64 * 2))
    single = peaks_of(StreamRunner(tsrc, tm, CPU, chunk_samples=win * 8).run_search)
    jr, tr = runner_pair(jsrc, tsrc, jm, tm, win * 16, n_time=4)
    got, jax_mesh = peaks_of(tr.run_search), peaks_of(jr.run_search)
    assert set(got) == set(single) == set(jax_mesh)
    assert all(got[w][0] == single[w][0] for w in single)
    for w, (i, v) in jax_mesh.items():
        np.testing.assert_allclose(got[w][1], v, rtol=2e-4)
        assert got[w][0] == i or abs(got[w][1] - v) <= 2e-4 * max(abs(v), 1e-9), w


def test_sharded_runner_bounded_run_stops_before_the_tail():
    rng = np.random.default_rng(79)
    _, tm = models()
    win = 8 * 32
    _, tsrc = sources(noise(rng, win * 40 + 64 * 2))
    r = StreamRunner(tsrc, tm, CPU, chunk_samples=win * 8, mesh=tmesh(4))
    full, _ = rows_of(r.run)
    got, stats = rows_of(r.run, max_chunks=2)
    assert sorted(got) == list(range(16)) and stats.windows_out == 16
    assert_rows(got, {w: full[w] for w in got}, 0.0)


# -- the stream survey on a mesh (tests/test_scan.py) -------------------------


def test_stream_run_scan_mesh_matches_single():
    rng = np.random.default_rng(14)
    iq = (rng.standard_normal(2 * 40_000) * 0.3).astype("<f4")
    cfg = dict(sample_rate=48_000, shift_freq=1_000, lp_freq=8_000, decimate=4, taps=40, fft_width=32)
    jm, tm = models(**cfg)
    raw = np.frombuffer(iq.tobytes(), dtype=np.uint8)
    jsrc = jsources.SampleSource(raw, JFormat.COMPLEX_FLOAT32, 48_000)
    tsrc = SampleSource(raw, FileFormat.COMPLEX_FLOAT32, 48_000)
    single = StreamRunner(tsrc, tm, CPU, chunk_samples=8_000)
    solo = single.run_scan(threshold=1.0)
    got = StreamRunner(tsrc, tm, CPU, chunk_samples=8_000, mesh=tmesh(4)).run_scan(threshold=1.0)
    want = jrunner.StreamRunner(jsrc, jm, chunk_samples=8_000, mesh=jmesh(4)).run_scan(threshold=1.0)
    assert got.windows == solo.windows == want.windows
    np.testing.assert_allclose(got.sum_norms, solo.sum_norms, rtol=1e-5)
    np.testing.assert_allclose(got.max_norms, solo.max_norms, rtol=SELF_TOL)
    assert_counts(got.above[0], solo.above[0], rows_of(single.run)[0], 1.0)
    np.testing.assert_allclose(got.sum_norms, want.sum_norms, rtol=1e-4)
    np.testing.assert_allclose(got.max_norms, want.max_norms, rtol=1e-4)
    assert np.abs(got.above - want.above).max() <= 1


# -- WaterfallRunner on a mesh ------------------------------------------------


def wf_sources(raw: np.ndarray):
    fmt = JFormat.COMPLEX_INT8
    out = []
    for s in range(raw.shape[0]):
        b = np.stack([raw[s][0], raw[s][1]], axis=1).astype(np.int8).reshape(-1).view(np.uint8)
        out.append((jsources.SampleSource(b, fmt, 400), SampleSource(b, FileFormat.COMPLEX_INT8, 400)))
    return [o[0] for o in out], [o[1] for o in out]


def collect(run, **kw):
    got = []
    stats = run(lambda w, out: got.append((w, out)), **kw)
    return got, stats


@pytest.mark.parametrize("stride", [256, 128])
def test_waterfall_runner_sharded_matches_single_device(stride):
    """The bank streamed over a 4x2 mesh: the single-device runner's rows
    and peaks, the JAX mesh runner's, resume included."""
    jm, tm = wf_models(2, 256, stride)
    jsrcs, tsrcs = wf_sources(tm.synth_raw(23 * 256 + 91, seed=77))
    single, sstats = collect(WaterfallRunner(tsrcs, tm, CPU, chunk_windows=8).run)
    want = np.concatenate([r for _, r in single], axis=1)
    mesh = tmesh(4, 2)
    sharded, stats = collect(WaterfallRunner(tsrcs, tm, CPU, chunk_windows=8, mesh=mesh).run)
    got = np.concatenate([r for _, r in sharded], axis=1)
    jax_mesh, jstats = collect(jrunner.WaterfallRunner(jsrcs, jm, chunk_windows=8, mesh=jmesh(4, 2)).run)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got, np.concatenate([r for _, r in jax_mesh], axis=1), rtol=WF_RTOL,
                               atol=WF_RTOL * want.max())
    assert [w for w, _ in sharded] == [w for w, _ in jax_mesh]
    assert (stats.samples_in, stats.windows_out) == (jstats.samples_in, jstats.windows_out)
    assert stats.windows_out == sstats.windows_out
    peaks = np.concatenate([o[0] for _, o in collect(WaterfallRunner(tsrcs, tm, CPU, chunk_windows=8, mesh=mesh)
                                                          .run_search)[0]], axis=1)
    np.testing.assert_array_equal(peaks, np.argmax(want, axis=-1))
    resumed, _ = collect(WaterfallRunner(tsrcs, tm, CPU, chunk_windows=8, mesh=mesh).run, start_window=8)
    assert resumed[0][0] == 8
    np.testing.assert_array_equal(np.concatenate([r for _, r in resumed], axis=1), want[:, 8:])


@pytest.mark.parametrize("stride", [256, 128, 300])
def test_waterfall_scan_sharded_matches_single_device(stride):
    """``run_scan`` on a mesh reduces the shards' norms masked to the
    chunk's valid windows: counts and maxima the single-device survey's,
    sums to f32 order; the JAX mesh survey's too."""
    jm, tm = wf_models(2, 256, stride)
    jsrcs, tsrcs = wf_sources(tm.synth_raw(23 * 256 + 91, seed=78))
    solo = WaterfallRunner(tsrcs, tm, CPU, chunk_windows=8).run_scan(threshold=8.0)
    got = WaterfallRunner(tsrcs, tm, CPU, chunk_windows=8, mesh=tmesh(4, 2)).run_scan(threshold=8.0)
    want = jrunner.WaterfallRunner(jsrcs, jm, chunk_windows=8, mesh=jmesh(4, 2)).run_scan(threshold=8.0)
    assert got.windows == solo.windows == want.windows
    np.testing.assert_array_equal(got.above, solo.above)
    np.testing.assert_array_equal(got.max_norms, solo.max_norms)
    np.testing.assert_allclose(got.sum_norms, solo.sum_norms, rtol=1e-5)
    np.testing.assert_allclose(got.sum_norms, want.sum_norms, rtol=1e-5)
    np.testing.assert_allclose(got.max_norms, want.max_norms, rtol=WF_RTOL)


# -- pipes on a mesh (tests/test_pipe_source.py) -------------------------------


def pipe_bytes(n: int, seed: int) -> bytes:
    return np.random.default_rng(seed).integers(0, 256, 2 * n, dtype=np.int64).astype(np.uint8).tobytes()


def test_pipe_mesh_stream_matches_file_mesh():
    """A live pipe shards over time through a ``LivePipeStream``: rows and
    peaks equal the file-mesh run's, a bounded run stops at its bound."""
    fmt = FileFormat.COMPLEX_INT8
    data = pipe_bytes(60_011, 26)
    cfg = dict(sample_rate=48_000, shift_freq=1_000, lp_freq=8_000, decimate=4, taps=40, fft_width=32)
    _, tm = models("cs8", **cfg)
    fsrc = SampleSource(np.frombuffer(data, dtype=np.uint8), fmt, 48_000)

    def runner(src):
        return StreamRunner(src, tm, CPU, chunk_samples=16_000, mesh=tmesh(4))

    frows, fstats = collect(runner(fsrc).run)
    prows, pstats = collect(runner(PipeSource(io.BytesIO(data), fmt, 48_000)).run)
    assert len(prows) == len(frows) > 1
    for (fw, fn), (pw, pn) in zip(frows, prows):
        assert fw == pw and fn.tobytes() == pn.tobytes()
    assert (pstats.samples_in, pstats.windows_out) == (fstats.samples_in, fstats.windows_out)
    fpk, _ = collect(runner(fsrc).run_search)
    ppk, _ = collect(runner(PipeSource(io.BytesIO(data), fmt, 48_000)).run_search)
    for (fw, (fi, fv)), (pw, (pi, pv)) in zip(fpk, ppk):
        assert fw == pw and fi.tobytes() == pi.tobytes() and fv.tobytes() == pv.tobytes()
    brows, bstats = collect(runner(PipeSource(io.BytesIO(data), fmt, 48_000)).run, max_chunks=2)
    assert [w for w, _ in brows] == [w for w, _ in frows[:2]]
    single, _ = collect(StreamRunner(fsrc, tm, CPU, chunk_samples=16_000).run)
    a, b = np.concatenate([r for _, r in frows]), np.concatenate([r for _, r in single])
    assert a.shape == b.shape
    assert float(np.abs(a - b).max()) <= SELF_TOL * float(b.max())


@pytest.mark.parametrize("width,stride,n_samples", [(128, 64, 40_000), (128, 128, 40_011), (128, 300, 60_000)])
def test_waterfall_pipe_mesh_matches_file_mesh(width, stride, n_samples):
    """A live pipe on the waterfall mesh: overlapped, tiled (ragged EOF)
    and skipping strides give the file-mesh run's rows and peaks, and the
    JAX pipe-mesh run's."""
    fmt = FileFormat.COMPLEX_INT8
    data = pipe_bytes(n_samples, 31)
    jm, tm = wf_models(1, width, stride)
    fsrc = SampleSource(np.frombuffer(data, dtype=np.uint8), fmt, 48_000)

    def runner(src):
        return WaterfallRunner([src], tm, CPU, chunk_windows=37, mesh=tmesh(4))

    frows, fstats = collect(runner(fsrc).run)
    prows, pstats = collect(runner(PipeSource(io.BytesIO(data), fmt, 48_000)).run)
    assert len(prows) == len(frows) > 1
    for (fw, fn), (pw, pn) in zip(frows, prows):
        assert fw == pw and fn.tobytes() == pn.tobytes()
    assert (pstats.samples_in, pstats.windows_out) == (fstats.samples_in, fstats.windows_out)
    jrows, jstats = collect(jrunner.WaterfallRunner([jsources.PipeSource(io.BytesIO(data), JFormat.COMPLEX_INT8, 48_000)],
                                                    jm, chunk_windows=37, mesh=jmesh(4)).run)
    assert [w for w, _ in jrows] == [w for w, _ in prows]
    assert (jstats.samples_in, jstats.windows_out) == (pstats.samples_in, pstats.windows_out)
    for (_, jn), (_, pn) in zip(jrows, prows):
        np.testing.assert_allclose(pn, jn, rtol=WF_RTOL, atol=WF_RTOL * max(jn.max(), 1e-6))
    fpk, _ = collect(runner(fsrc).run_search)
    ppk, _ = collect(runner(PipeSource(io.BytesIO(data), fmt, 48_000)).run_search)
    for (fw, (fi, _)), (pw, (pi, _)) in zip(fpk, ppk):
        assert fw == pw and fi.tobytes() == pi.tobytes()


# -- find on a mesh (tests/test_find.py) ---------------------------------------


@pytest.mark.parametrize("topk", [1024, 1])
def test_sharded_find_matches_single_device(topk, monkeypatch):
    """``find_pattern(mesh=4x1)``: several mesh dispatches of 4 shards x 1
    window and an unaligned remainder on the single-device path; plants
    straddling shard and dispatch boundaries, inside the tail and at the
    last lag; with a top-k of 1 every shard that holds a match overflows
    its device scan and feeds its full scores."""
    rng = np.random.default_rng(31)
    l, c = 512, 4096
    n_out = c - l + 1
    p = noise(rng, l)
    for mod in (jsinks, tsinks):
        monkeypatch.setattr(mod, "FIND_DISPATCH_BUDGET", 4 * c)
    monkeypatch.setattr(tsinks, "FIND_TOPK", topk)
    step_lags = 4 * n_out
    n = 3 * step_lags + 2 * n_out + 777
    x = 0.03 * noise(rng, n)
    plants = [5, n_out - 30, 2 * n_out, step_lags - 100, 3 * step_lags + 50, n - l]
    for i, o in enumerate(plants):
        x[o : o + l] += np.complex64(0.8 * np.exp(0.7j * i)) * p
    jsrc, tsrc = sources(x, sr=48_000)
    single = tsinks.find_pattern(tsrc, p, threshold=0.5, chunk=c, device=CPU)
    got = tsinks.find_pattern(tsrc, p, threshold=0.5, chunk=c, mesh=tmesh(4), device=CPU)
    want = jsinks.find_pattern(jsrc, p, threshold=0.5, chunk=c, mesh=jmesh(4))
    assert list(got.offsets) == list(single.offsets) == list(want.offsets) == sorted(plants)
    for other in (single, want):
        np.testing.assert_allclose(got.scores, other.scores, rtol=0, atol=2e-4)
        np.testing.assert_allclose(got.scales, other.scales, rtol=1e-4)
        assert np.array_equal(got.which, other.which)


def test_sharded_find_bank_grid(monkeypatch):
    rng = np.random.default_rng(32)
    sr, l, c = 48_000, 256, 2048
    pa, pb = noise(rng, l), noise(rng, l // 2)
    for mod in (jsinks, tsinks):
        monkeypatch.setattr(mod, "FIND_DISPATCH_BUDGET", 2 * c)
    n = 6 * 2 * (c - l + 1) + 123
    x = 0.03 * noise(rng, n)
    m = np.arange(l)
    x[4_000 : 4_000 + l] += 0.7 * pa * np.exp(2j * np.pi * 120.0 * m / sr).astype(np.complex64)
    x[15_000 : 15_000 + l // 2] += 0.9 * pb
    jsrc, tsrc = sources(x, sr=sr)
    kw = dict(threshold=0.4, chunk=c, freq_tol=300.0)
    single = tsinks.find_pattern(tsrc, [pa, pb], device=CPU, **kw)
    got = tsinks.find_pattern(tsrc, [pa, pb], mesh=tmesh(2), device=CPU, **kw)
    want = jsinks.find_pattern(jsrc, [pa, pb], mesh=jmesh(2), **kw)
    for other in (single, want):
        assert np.array_equal(got.offsets, other.offsets)
        np.testing.assert_allclose(got.scores, other.scores, rtol=0, atol=2e-4)
        assert np.array_equal(got.which, other.which) and np.array_equal(got.freqs, other.freqs)


def test_sharded_find_rejects_chained_stream():
    rng = np.random.default_rng(33)
    x = noise(rng, 9000)
    jsrc, tsrc = sources(x, sr=48_000)
    with pytest.raises(ValueError, match="raw capture") as want:
        jsinks.find_pattern(jstream.Shift(jsrc, 1000, 48_000), x[100:356].copy(), mesh=jmesh(2))
    with pytest.raises(ValueError, match="raw capture") as got:
        tsinks.find_pattern(tstream.Shift(tsrc, 1000, 48_000), x[100:356].copy(), mesh=tmesh(2), device=CPU)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="Tx1"):
        tsh.make_sharded_find_step(x[:256], 2048, FileFormat.COMPLEX_FLOAT32, tmesh(2, 2))


# -- channelize on a mesh (tests/test_channelizer.py) ---------------------------


def channels(chan_mod, src, k, size, chunk, mesh, **kw):
    return np.concatenate([c.data for c in chan_mod.run_channelize(chan_mod.Channelize(src, k, size=size),
                                                                     chunk=chunk, mesh=mesh, **kw)], axis=1)


def test_sharded_channelize_matches_single_device():
    """A 4x1 mesh with every shard pulling the full ``chunk``: the
    single-device output bit for bit, and the JAX mesh's."""
    rng = np.random.default_rng(21)
    x = noise(rng, 40_000)
    jsrc, tsrc = sources(x, sr=16_000)
    single = channels(tchan, tsrc, 8, 64, 512, None, device=CPU)
    got = channels(tchan, tsrc, 8, 64, 512, tmesh(4), device=CPU)
    want = channels(jchan, jsrc, 8, 64, 512, jmesh(4))
    assert got.shape == single.shape == want.shape
    np.testing.assert_array_equal(got, single)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6 * np.abs(want).max())


def test_sharded_channelize_cs8_odd_k():
    """An 8-way mesh, an integer format and a K that does not divide the
    filter length."""
    rng = np.random.default_rng(22)
    n = 40_000
    raw = np.frombuffer((np.clip(rng.standard_normal(2 * n), -1, 1) * 100).astype(np.int8).tobytes(), dtype=np.uint8)
    jsrc, tsrc = sources(raw, fmt="cs8", sr=16_000)
    single = channels(tchan, tsrc, 6, 50, 333, None, device=CPU)
    got = channels(tchan, tsrc, 6, 50, 333, tmesh(8), device=CPU)
    want = channels(jchan, jsrc, 6, 50, 333, jmesh(8))
    np.testing.assert_array_equal(got, single)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6 * np.abs(want).max())


def test_sharded_channelize_rejects_chained_stream():
    x = noise(np.random.default_rng(23), 9_000)
    jsrc, tsrc = sources(x, sr=16_000)
    with pytest.raises(ValueError, match="raw capture") as want:
        next(jchan.run_channelize(jchan.Channelize(jstream.Shift(jsrc, 1_000, 16_000), 4, size=40), mesh=jmesh(2)))
    with pytest.raises(ValueError, match="raw capture") as got:
        next(tchan.run_channelize(tchan.Channelize(tstream.Shift(tsrc, 1_000, 16_000), 4, size=40), mesh=tmesh(2),
                                  device=CPU))
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="Tx1"):
        tsh.make_sharded_channelize_step(np.ones(40, np.float32), 4, FileFormat.COMPLEX_FLOAT32, tmesh(2, 2))


# -- shards on several devices -----------------------------------------------------


def test_runners_join_shards_from_several_devices():
    """A mesh of two device names (``cpu`` and ``cpu:0``: two devices to
    the runners, one to torch): a ring and a stream each, and every
    shard's output moved to the first shard's device and joined there.
    It gives the rows, peaks and surveys of a mesh of one device, stream
    and bank."""
    two = [CPU, torch.device("cpu", 0)]
    rng = np.random.default_rng(90)
    _, tm = models()
    win = 8 * 32
    pairs = [sources(noise(rng, win * 24 + 99))[1] for _ in range(2)]
    for n_stream in (1, 2):
        srcs = pairs[:n_stream] if n_stream > 1 else pairs[0]
        runs = [StreamRunner(srcs, tm, CPU, chunk_samples=win * 8, mesh=tsh.make_mesh(2, n_stream, devices=d * n_stream))
                for d in ([CPU, CPU], two)]
        assert [len(r.mesh.distinct) for r in runs] == [1, 2]
        (a, _), (b, _) = (collect(r.run) for r in runs)
        assert [w for w, _ in a] == [w for w, _ in b]
        assert all(x.tobytes() == y.tobytes() for (_, x), (_, y) in zip(a, b))
        (a, _), (b, _) = (collect(r.run_search) for r in runs)
        assert all(x[0].tobytes() == y[0].tobytes() and x[1].tobytes() == y[1].tobytes() for (_, x), (_, y) in zip(a, b))
        sa, sb = (r.run_scan(threshold=2.0) for r in runs)
        assert sa.sum_norms.tobytes() == sb.sum_norms.tobytes() and sa.above.tobytes() == sb.above.tobytes()
    jm, wm = wf_models(4, 256, 128)
    _, tsrcs = wf_sources(wm.synth_raw(23 * 256 + 91, seed=91))
    runs = [WaterfallRunner(tsrcs, wm, CPU, chunk_windows=8, mesh=tsh.make_mesh(2, 2, devices=d * 2))
            for d in ([CPU, CPU], two)]
    for mode in ("run", "run_search"):
        (a, _), (b, _) = (collect(getattr(r, mode)) for r in runs)
        assert len(a) == len(b) > 1
        for (wa, x), (wb, y) in zip(a, b):
            assert wa == wb
            for p, q in zip(x if isinstance(x, tuple) else (x,), y if isinstance(y, tuple) else (y,)):
                assert p.shape == q.shape and p.tobytes() == q.tobytes()
    sa, sb = (r.run_scan(threshold=8.0) for r in runs)
    assert sa.windows == sb.windows and sa.above.tobytes() == sb.above.tobytes()
    assert sa.sum_norms.tobytes() == sb.sum_norms.tobytes()
