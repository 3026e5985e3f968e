"""The receivers' ``-mesh`` in the port, case for case with
``tests/test_demod_mesh.py``: every receiver's ``mesh=`` run against the
port's single-device run and against the JAX package's mesh run (its 8
virtual CPU devices), over the same seeded capture in each of the four
formats where the JAX test takes one cf32 file.

The port time-shards the streaming front end's window axis
(``models.demod._channel_step(mesh=)``): each shard is a single-device
step over its own windows, staged with its halo from the capture (the
last shard's halo the capture's continuation), on a mesh of the CPU
repeated.  Mesh dispatches cover full windows only, and the EOF tail
stitches through the single-device dispatches, so the captures are sized
to give both a sharded prefix and a stitched tail.

What holds: bits, FSK digits and OOK pulses exactly, against both; audio
and PSK baseband within ``rtol 1e-5, atol 1e-5`` (the JAX test's bound)
of both.  The FIR's ``auto`` impl is resolved once from the single-device
geometry, so every shard sums in the single-device order: a 1x1 mesh is
bit-equal to no mesh, and on the CPU the 2- and 4-way meshes are bit-equal
too (``test_mesh_shape_invariance`` holds 1x1 bitwise and the others to
the f32 bound).  The errors are the JAX package's, text for text."""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from quadrs_tpu import cli as jcli  # noqa: E402
from quadrs_tpu.models import demod as jdemod  # noqa: E402
from quadrs_tpu.parallel.sharding import make_mesh as jmake_mesh  # noqa: E402
from quadrs_tpu.sources import SampleSource as JSampleSource  # noqa: E402
from quadrs_tpu.stream import DcBlock as JDcBlock  # noqa: E402

from quadrs_tpu_torch import cli as tcli  # noqa: E402
from quadrs_tpu_torch.models import demod as tdemod  # noqa: E402
from quadrs_tpu_torch.parallel.sharding import make_mesh  # noqa: E402
from quadrs_tpu_torch.sources import open_capture  # noqa: E402
from quadrs_tpu_torch.stream import DcBlock  # noqa: E402

CPU = torch.device("cpu")
FORMATS = ["cf32", "cs8", "cu8", "cs16"]
RTOL = ATOL = 1e-5


def tmesh(n_time: int, n_stream: int = 1):
    """A port mesh of the CPU repeated."""
    return make_mesh(n_time, n_stream, devices=[CPU] * (n_time * n_stream))


def quantized(x: np.ndarray, fmt: str) -> bytes:
    """``x`` interleaved in ``fmt``'s codes."""
    iq = np.stack([x.real, x.imag], axis=1)
    if fmt == "cf32":
        return iq.astype("<f4").tobytes()
    if fmt == "cs8":
        return np.clip(np.rint(iq * 120), -127, 127).astype(np.int8).tobytes()
    if fmt == "cu8":
        return np.clip(np.rint(iq * 120 + 127.5), 0, 255).astype(np.uint8).tobytes()
    return np.clip(np.rint(iq * 30_000), -32767, 32767).astype("<i2").tobytes()


@pytest.fixture(scope="module")
def captures(tmp_path_factory):
    """The JAX test's capture: an FM-ish tone at +280 kHz in noise at 21
    Msps, 2^17 samples, in each format."""
    rng = np.random.default_rng(3)
    n = 1 << 17
    t = np.arange(n) / 21e6
    phase = 2 * np.pi * 280e3 * t + 50.0 * np.sin(2 * np.pi * 1000 * t)
    x = (0.5 * np.exp(1j * phase) + 0.05 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))).astype(np.complex64)
    d = tmp_path_factory.mktemp("meshdemod")
    paths = {}
    for fmt in FORMATS:
        paths[fmt] = d / f"tone.sr21M.{fmt}"
        paths[fmt].write_bytes(quantized(x, fmt))
    return {k: str(v) for k, v in paths.items()}


def assert_engages(demod, path: str, c: int, lead: int, mesh, post=torch.real) -> None:
    """The parity is vacuous unless the sharded step covers windows: ``k``
    a positive multiple of the mesh, full windows for a dispatch."""
    step = tdemod._channel_step(demod.channel(open_capture(path)), c, lead, post, device=CPU, mesh=mesh)
    assert isinstance(step, tdemod._MeshChannelStep), "the sharded front end did not engage"
    assert step.k >= mesh.shape["time"] and step.k % mesh.shape["time"] == 0 and step.n_full >= step.k
    step.close()


def both(make, path: str, method: str, t_mesh, j_mesh, **kw):
    """``method`` of the port's receiver without and with ``t_mesh``, and of
    the JAX package's with ``j_mesh``."""
    t, j = make(tdemod), make(jdemod)
    single = getattr(t, method)(open_capture(path), device=CPU, **kw)
    meshed = getattr(t, method)(open_capture(path), device=CPU, mesh=t_mesh, **kw)
    jax = getattr(j, method)(JSampleSource.from_file(path), mesh=j_mesh, **kw)
    return single, meshed, jax


def jax_single(make, path: str, method: str):
    return getattr(make(jdemod), method)(JSampleSource.from_file(path))


def assert_close_to_jax(got: np.ndarray, want: np.ndarray, fmt: str, gap: float) -> None:
    """The port's mesh output against the JAX package's: within the JAX
    test's bound on cf32 and cs8.  On cu8 and cs16 the two packages'
    single-device runs of these wide filters already differ more (their
    decodes differ in the last ulp, and each window's last outputs, which
    see the FIR's per-read truncation, swing far on the discriminator), so
    there the mesh must add nothing to that gap (``gap``: the single-device
    runs' largest difference)."""
    if fmt in ("cf32", "cs8"):
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    else:
        assert float(np.abs(got - want).max()) <= gap


def assert_audio(single, meshed, jax, fmt: str, j_single) -> None:
    (r1, a1), (r2, a2), (r3, a3), (r4, a4) = single, meshed, jax, j_single
    assert r1 == r2 == r3 == r4
    a2 = np.asarray(a2)
    assert a2.shape == np.asarray(a1).shape == np.asarray(a3).shape and a2.size > 0
    np.testing.assert_allclose(a2, a1, rtol=RTOL, atol=ATOL)
    assert_close_to_jax(a2, np.asarray(a3), fmt, float(np.abs(a1 - np.asarray(a4)).max()))


@pytest.mark.parametrize("fmt", FORMATS)
def test_fm_mesh_matches_single_device(captures, fmt):
    def fm(m):
        return m.FmDemod(center=280_000, bandwidth=100_000, decimate=10, taps=400, audio_bandwidth=15_000,
                         audio_decimate=10, audio_taps=64, chunk=1024)

    assert_engages(fm(tdemod), captures[fmt], 1024, 1, tmesh(4))
    assert_audio(*both(fm, captures[fmt], "demodulate", tmesh(4), jmake_mesh(4, 1)), fmt,
                 jax_single(fm, captures[fmt], "demodulate"))


@pytest.mark.parametrize("fmt", FORMATS)
def test_am_mesh_matches_single_device(captures, fmt):
    def am(m):
        return m.AmDemod(center=280_000, bandwidth=10_000, decimate=20, taps=400, chunk=512)

    assert_engages(am(tdemod), captures[fmt], 512, 0, tmesh(4))
    assert_audio(*both(am, captures[fmt], "demodulate", tmesh(4), jmake_mesh(4, 1)), fmt,
                 jax_single(am, captures[fmt], "demodulate"))


@pytest.mark.parametrize("fmt", FORMATS)
def test_ssb_mesh_matches_single_device(captures, fmt):
    def ssb(m):
        return m.SsbDemod(center=-280_000, bandwidth=3000, decimate=20, taps=400, chunk=512)

    assert_engages(ssb(tdemod), captures[fmt], 512, 0, tmesh(4))
    assert_audio(*both(ssb, captures[fmt], "demodulate", tmesh(4), jmake_mesh(4, 1)), fmt,
                 jax_single(ssb, captures[fmt], "demodulate"))


@pytest.mark.parametrize("fmt", FORMATS)
def test_psk_baseband_mesh_matches_single_device(captures, fmt):
    def psk(m):
        return m.PskDemod(center=280_000, bandwidth=200_000, decimate=32, taps=400, symbol_rate=10_000, chunk=512)

    assert_engages(psk(tdemod), captures[fmt], 512, 0, tmesh(4))
    (r1, b1), (r2, b2), (r3, b3) = both(psk, captures[fmt], "baseband", tmesh(4), jmake_mesh(4, 1))
    assert r1 == r2 == r3 and b1.shape == b2.shape == b3.shape and b2.size > 0
    np.testing.assert_allclose(b2, b1, rtol=RTOL, atol=ATOL)
    gap = float(np.abs(b1 - jax_single(psk, captures[fmt], "baseband")[1]).max())
    assert_close_to_jax(b2, b3, fmt, gap)


@pytest.mark.parametrize("fmt", FORMATS)
def test_fsk_symbols_mesh_match(captures, fmt):
    def fsk(m):
        return m.FskDemod(center=280_000, bandwidth=200_000, decimate=32, taps=400, fft_width=64)

    s1, s2, s3 = both(fsk, captures[fmt], "symbols", tmesh(4), jmake_mesh(4, 1))
    assert s1 == s2 == s3 and len(s1) > 0


@pytest.mark.parametrize("fmt", FORMATS)
def test_fsk_gapped_stride_mesh_match(captures, fmt):
    """stride > width leaves gaps between windows (``n_in <= hop``): the
    shards need no halo there (the JAX package's regression for a negative
    halo slice)."""

    def fsk(m):
        return m.FskDemod(center=280_000, bandwidth=200_000, decimate=8, taps=40, fft_width=64, stride=600)

    step = tdemod._channel_step(fsk(tdemod).channel(open_capture(captures[fmt])), 64, 0, torch.real, device=CPU,
                                stride=600, mesh=tmesh(4))
    assert isinstance(step, tdemod._MeshChannelStep) and step.shards[0].n_in <= step.shards[0].hop
    step.close()
    s1, s2, s3 = both(fsk, captures[fmt], "symbols", tmesh(4), jmake_mesh(4, 1))
    assert s1 == s2 == s3 and len(s1) > 0


@pytest.mark.parametrize("fmt", FORMATS)
def test_ook_pulses_mesh_match(captures, fmt):
    """The chunk-level envelope of a bare capture shards 8 ways."""

    def ook(m):
        return m.OokDemod(width=4, stride=2, threshold=0.001)

    p1, p2, p3 = both(ook, captures[fmt], "pulses", tmesh(8), jmake_mesh(8, 1))
    assert np.array_equal(p2, p1) and np.array_equal(p2, np.asarray(p3)) and p1.size > 0


def test_mesh_requires_channel_chain(captures):
    """User-chained stages in front of a receiver cannot shard: the mesh
    request fails with the JAX package's text, never runs on one device.
    PSK too, where the JAX package's ``baseband`` runs the chain on one
    device without a word (a difference the port records: its PSK takes
    the analog receivers' chunk loop, which refuses)."""
    path = captures["cf32"]
    cases = [
        ("FmDemod", dict(center=280_000, decimate=10, chunk=1024), "demodulate"),
        ("OokDemod", {}, "pulses"),
        ("FskDemod", dict(center=280_000), "symbols"),
        ("AmDemod", dict(center=280_000), "demodulate"),
        ("PskDemod", dict(center=280_000, symbol_rate=10_000), "baseband"),
    ]
    for cls, kw, method in cases:
        with pytest.raises(ValueError, match="-mesh") as t_err:
            getattr(getattr(tdemod, cls)(**kw), method)(DcBlock(open_capture(path), 1024), device=CPU, mesh=tmesh(2))
        j_run = getattr(getattr(jdemod, cls)(**kw), method)
        if cls == "PskDemod":
            rate, x = j_run(JDcBlock(JSampleSource.from_file(path), 1024), mesh=jmake_mesh(2, 1))
            assert x.size > 0
            assert str(t_err.value) == tdemod._MESH_NEEDS_CHAIN
            continue
        with pytest.raises(ValueError) as j_err:
            j_run(JDcBlock(JSampleSource.from_file(path), 1024), mesh=jmake_mesh(2, 1))
        assert str(t_err.value) == str(j_err.value), cls


def test_mesh_stream_axis_refused_with_jax_text(captures):
    """A mesh with a ``stream`` axis over one capture: the JAX package's
    ValueError."""
    fm_t = tdemod.FmDemod(center=280_000, decimate=10, chunk=1024)
    fm_j = jdemod.FmDemod(center=280_000, decimate=10, chunk=1024)
    with pytest.raises(ValueError) as t_err:
        fm_t.demodulate(open_capture(captures["cf32"]), device=CPU, mesh=tmesh(2, 2))
    with pytest.raises(ValueError) as j_err:
        fm_j.demodulate(JSampleSource.from_file(captures["cf32"]), mesh=jmake_mesh(2, 2))
    assert str(t_err.value) == str(j_err.value) == "demod -mesh shards one capture over 'time'; use a Tx1 mesh"


@pytest.mark.parametrize("fmt", FORMATS)
def test_mesh_short_capture_falls_back(tmp_path, fmt):
    """A capture too short to give every shard a full window demodulates
    through the single-device stitch alone, equal to the unmeshed run and
    the JAX package's mesh run."""
    rng = np.random.default_rng(5)
    x = (0.3 * (rng.standard_normal(6000) + 1j * rng.standard_normal(6000))).astype(np.complex64)
    path = tmp_path / f"short.sr1M.{fmt}"
    path.write_bytes(quantized(x, fmt))
    am = tdemod.AmDemod(center=100_000, bandwidth=10_000, decimate=20, taps=400)
    chan = am.channel(open_capture(str(path)))
    assert tdemod._channel_step(chan, min(am.chunk, chan.length), 0, torch.abs, device=CPU, mesh=tmesh(8)) is None
    r1, a1 = am.demodulate(open_capture(str(path)), device=CPU)
    r2, a2 = am.demodulate(open_capture(str(path)), device=CPU, mesh=tmesh(8))
    r3, a3 = jdemod.AmDemod(center=100_000, bandwidth=10_000, decimate=20, taps=400).demodulate(
        JSampleSource.from_file(str(path)), mesh=jmake_mesh(8, 1))
    assert r1 == r2 == r3
    np.testing.assert_array_equal(a1, a2)
    r4, a4 = jdemod.AmDemod(center=100_000, bandwidth=10_000, decimate=20, taps=400).demodulate(
        JSampleSource.from_file(str(path)))
    assert_close_to_jax(a2, np.asarray(a3), fmt, float(np.abs(a1 - np.asarray(a4)).max()))


RECEIVERS = {
    "fm": (lambda: tdemod.FmDemod(center=280_000, bandwidth=100_000, decimate=10, taps=400, chunk=1024),
           "demodulate"),
    "am": (lambda: tdemod.AmDemod(center=280_000, bandwidth=10_000, decimate=20, taps=400, chunk=512), "demodulate"),
    "ssb": (lambda: tdemod.SsbDemod(center=-280_000, bandwidth=3000, decimate=20, taps=400, chunk=512), "demodulate"),
    "psk": (lambda: tdemod.PskDemod(center=280_000, bandwidth=200_000, decimate=32, taps=400, symbol_rate=10_000,
                                    chunk=512), "baseband"),
    "fsk": (lambda: tdemod.FskDemod(center=280_000, bandwidth=200_000, decimate=32, taps=400, fft_width=64),
            "symbols"),
    "ook": (lambda: tdemod.OokDemod(width=4, stride=2, threshold=0.001), "pulses"),
}


def _flat(out) -> list[np.ndarray]:
    return [np.asarray(o) for o in out] if isinstance(out, tuple) else [np.asarray(out)]


@pytest.mark.parametrize("name", sorted(RECEIVERS))
def test_mesh_shape_invariance(captures, name):
    """The output does not depend on the mesh's shape: ``-mesh 1`` is bit
    for bit the unmeshed run, 2 and 4 shards within the f32 bound (on the
    CPU bit for bit too: every shard sums in the single-device order)."""
    make, method = RECEIVERS[name]
    path = captures["cs8"]
    want = _flat(getattr(make(), method)(open_capture(path), device=CPU))
    for n_time in (1, 2, 4):
        got = _flat(getattr(make(), method)(open_capture(path), device=CPU, mesh=tmesh(n_time)))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            if n_time == 1:
                assert g.tobytes() == w.tobytes(), (name, n_time)
            else:
                np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", sorted(RECEIVERS))
def test_mesh_computes_each_window_once(captures, name, monkeypatch):
    """A mesh run computes each window once and none that lies wholly past
    the capture's end: the EOF tail after the sharded prefix goes through
    a single-device step of no more windows than are left."""
    make, method = RECEIVERS[name]
    seen = []
    call = tdemod._ChannelStep.__call__

    def counted(self, o):
        w_offs, valid_in, _ = self.valid_counts(o)
        seen.append((w_offs // self.stride, valid_in))
        return call(self, o)

    monkeypatch.setattr(tdemod._ChannelStep, "__call__", counted)
    getattr(make(), method)(open_capture(captures["cs8"]), device=CPU, mesh=tmesh(4))
    windows = np.concatenate([w for w, _ in seen])
    assert len(seen) > 4 and len(np.unique(windows)) == len(windows), name
    assert min(int(v.min()) for _, v in seen) > 0, name


class TestCli:
    @staticmethod
    def _run(main, argv, capsys):
        rc = main(argv)
        out = capsys.readouterr()
        return rc, out.out, out.err

    @pytest.fixture(autouse=True)
    def _cpu(self, monkeypatch):
        monkeypatch.setenv("QUADRS_PLATFORM", "cpu")

    @pytest.mark.parametrize("fmt", FORMATS)
    def test_fsk_mesh_cli_matches_single_device(self, captures, fmt, capsys):
        rc1, out1, _ = self._run(tcli.main, ["fsk", "-shift", "280k", captures[fmt]], capsys)
        rc2, out2, _ = self._run(tcli.main, ["fsk", "-shift", "280k", "-mesh", "4", captures[fmt]], capsys)
        rc3, out3, _ = self._run(jcli.main, ["fsk", "-shift", "280k", "-mesh", "4", captures[fmt]], capsys)
        assert rc1 == rc2 == rc3 == 0
        assert out2 == out1 == out3 and len(out2.splitlines()[0]) > 0

    @pytest.mark.parametrize("fmt", FORMATS)
    def test_fm_mesh_cli_matches_single_device(self, captures, fmt, capsys):
        """The meter line of ``fm -mesh 4``: the single-device run's, its
        throughput aside; quadjax's count, rate and duration.  (Its peak and
        rms deviation come from each window's last outputs, which see the
        FIR's per-read truncation and swing on the discriminator: there the
        two packages' single-device runs differ already, by up to 3e-5
        here; the audio itself is held above.)"""
        argv = ["fm", "-shift", "280k", "-decimate", "10"]
        rc1, out1, _ = self._run(tcli.main, [*argv, captures[fmt]], capsys)
        rc2, out2, _ = self._run(tcli.main, [*argv, "-mesh", "4", captures[fmt]], capsys)
        rc3, out3, _ = self._run(jcli.main, [*argv, "-mesh", "4", captures[fmt]], capsys)
        assert rc1 == rc2 == rc3 == 0
        meter = [o.splitlines()[-1].rsplit(",", 1)[0] for o in (out1, out2, out3)]
        assert meter[1] == meter[0]
        assert meter[1].split(", peak")[0] == meter[2].split(", peak")[0]

    @pytest.mark.parametrize("cmd", ["fm", "ook", "fsk", "psk", "am", "ssb"])
    def test_mesh_stream_axis_rejected(self, captures, cmd, capsys):
        argv = [cmd, "-mesh", "2x2", captures["cf32"]]
        if cmd == "psk":
            argv[1:1] = ["-symbol-rate", "10k"]
        (t_rc, _, t_err), (j_rc, _, j_err) = (self._run(m, argv, capsys) for m in (tcli.main, jcli.main))
        assert t_rc == j_rc == 1 and t_err == j_err and t_err

    @pytest.mark.parametrize("cmd", ["ook", "fsk", "fm"])
    def test_mesh_stdin_rejected(self, cmd, capsys):
        argv = [cmd, "-mesh", "4", "-stdin", "yes", "-sr", "1M", "-format", "cf32"]
        (t_rc, _, t_err), (j_rc, _, j_err) = (self._run(m, argv, capsys) for m in (tcli.main, jcli.main))
        assert t_rc == j_rc == 1 and t_err == j_err and t_err
