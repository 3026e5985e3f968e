"""Pattern search (``quadrs_tpu_torch.ops.correlate``,
``sinks.find_pattern``, the ``find`` command) on the CPU, against the JAX
package's.

The template spectra are bitwise the JAX package's f32 planes.  Scores
and scales of one window batch agree within 2e-4 (the bound the JAX
package's tests hold its own transform engines to), the winning row
exactly outside near-ties; the device candidate scan's count and
candidates exactly.  ``PeakScan`` and ``suppress`` are bitwise the
originals.  Over planted captures, through several dispatches, top-k
overflow, clustered candidates, an aligned tail, a live pipe and the CLI,
offsets, ``which`` and ``freqs`` are exact, scores and scales within
2e-4."""

import inspect
import io
import pathlib
import sys
import types

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from quadrs_tpu import cli as jcli  # noqa: E402
from quadrs_tpu import sinks as jsinks  # noqa: E402
from quadrs_tpu import sources as jsources  # noqa: E402
from quadrs_tpu.formats import FileFormat as JFormat  # noqa: E402
from quadrs_tpu.ops import correlate as jcorr  # noqa: E402

from quadrs_tpu_torch import cli as tcli  # noqa: E402
from quadrs_tpu_torch import sinks as tsinks  # noqa: E402
from quadrs_tpu_torch import sources as tsources  # noqa: E402
from quadrs_tpu_torch.formats import FileFormat  # noqa: E402
from quadrs_tpu_torch.ops import correlate as tcorr  # noqa: E402

CPU = "cpu"
TOL = 2e-4


def noise(rng, n: int, sigma: float = 1.0) -> np.ndarray:
    return (sigma * (rng.standard_normal(n) + 1j * rng.standard_normal(n))).astype(np.complex64)


def cf32_bytes(x: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(x, dtype=np.complex64)).view(np.uint8)


def sources(x: np.ndarray, sr: int = 48_000):
    raw = cf32_bytes(x)
    return (jsources.SampleSource(raw, JFormat.COMPLEX_FLOAT32, sr),
            tsources.SampleSource(raw, FileFormat.COMPLEX_FLOAT32, sr))


# -- the device program, one window batch ----------------------------------


def templates(kind: str, rng):
    """(pattern, freqs in cycles a sample) of a search ``kind``."""
    a, b, c = noise(rng, 300), noise(rng, 180), noise(rng, 77)
    if kind == "single":
        return a, None
    if kind == "bank":
        return [a, b, c], None
    return [a, b], np.arange(-2, 3) * 0.4 / 300  # a 5-row grid over a 2-template bank


def batch(rng, pats, c: int, b: int) -> np.ndarray:
    """``b`` windows of noise with plants of every template, gains and
    phases arbitrary, one window of zeros (a zero-energy window scores 0)."""
    x = noise(rng, b * c, 0.3).reshape(b, c)
    pats = pats if isinstance(pats, list) else [pats]
    for i in range(b - 1):
        p = pats[i % len(pats)]
        o = int(rng.integers(0, c - len(p)))
        x[i, o : o + len(p)] += np.complex64(0.5 * (i + 1) * np.exp(1j * i)) * p
    x[b - 1] = 0
    return x


@pytest.mark.parametrize("kind", ["single", "bank", "grid"])
def test_template_planes_bitwise(kind):
    """The host-built f32 planes and per-row constants are bitwise the JAX
    package's (read from its program's closure)."""
    pats, freqs = templates(kind, np.random.default_rng(1))
    want = inspect.getclosurevars(jcorr.make_xcorr_post(pats, 1024, freqs, fft_impl="xla")).nonlocals
    got = tcorr.XCorr(pats, 1024, freqs)
    assert got.planes.dtype == want["pf_planes"].dtype == np.float32
    assert got.planes.tobytes() == want["pf_planes"].tobytes()
    assert got.inv_ep.tobytes() == want["inv_ep_r"].tobytes()
    assert got.inv_ep2.tobytes() == want["inv_ep2_r"].tobytes()
    assert got.row_len == want["row_len"]


@pytest.mark.parametrize("kind", ["single", "bank", "grid"])
def test_scores_match_jax(kind):
    rng = np.random.default_rng(2)
    pats, freqs = templates(kind, rng)
    c = 1024
    x = batch(rng, pats, c, 6)
    want = [np.asarray(a) for a in jcorr.make_xcorr_post(pats, c, freqs)(jnp.asarray(x))]
    xc = tcorr.XCorr(pats, c, freqs)
    got = [a.numpy() for a in tcorr.make_xcorr_post(pats, c, freqs)(torch.from_numpy(x))]
    assert [a.shape for a in got] == [a.shape for a in want] == [(6, c - 299)] * 3
    assert got[2].dtype == np.int32
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=TOL)
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=TOL)
    assert np.all(got[0][-1] == 0)  # the zero window
    # the winning row: exact unless the two rows' scores are a near-tie
    xf, me = xc.forward(torch.from_numpy(x)), xc.energy(torch.from_numpy(x))
    rows = xc._rows(xf, me, 0, xc.rows)[0].transpose(0, 1).numpy()
    differ = got[2] != want[2]
    s_got = np.take_along_axis(rows, got[2][None].astype(np.int64), 0)[0]
    s_want = np.take_along_axis(rows, want[2][None].astype(np.int64), 0)[0]
    assert np.all(np.abs(s_got - s_want)[differ] <= TOL)
    assert differ.mean() < 0.01


@pytest.mark.parametrize("group", [1, 2, 7, 1 << 24])
def test_row_groups_keep_the_sequential_rule(group, monkeypatch):
    """Rows in groups of any size pick what visiting them one by one in
    ascending order with strict ``>`` picks: the first of tied rows (a
    template twice in the bank), never a NaN score."""
    rng = np.random.default_rng(4)
    a, b = noise(rng, 200), noise(rng, 120)
    pats, freqs, c = [a, b, a], np.arange(-1, 2) * 0.4 / 200, 512
    x = batch(rng, pats, c, 5)
    x[1, 100:110] = np.nan
    xc = tcorr.XCorr(pats, c, freqs)
    xf, me = xc.forward(torch.from_numpy(x)), xc.energy(torch.from_numpy(x))
    rows, nums = (t.transpose(0, 1) for t in xc._rows(xf, me, 0, xc.rows))
    score = torch.full(rows[0].shape, -1.0)
    sc2, ridx = torch.zeros(rows[0].shape), torch.zeros(rows[0].shape, dtype=torch.int32)
    for r in range(xc.rows):
        better = rows[r] > score
        score = torch.where(better, rows[r], score)
        sc2 = torch.where(better, nums[r] * float(xc.inv_ep2[r]), sc2)
        ridx = torch.where(better, r, ridx)
    monkeypatch.setattr(tcorr, "ROW_GROUP", group * 5 * c)
    got = xc.scores(xf, me)
    assert torch.equal(got[0], score) and torch.equal(got[2], ridx) and torch.equal(got[1], torch.sqrt(sc2))
    assert set(got[2].unique().tolist()) <= {0, 1, 2, 3, 4, 5} and bool((score[1] == -1).any())


@pytest.mark.parametrize("kind", ["single", "bank", "grid"])
@pytest.mark.parametrize("k", [1024, 3])
def test_extract_matches_jax(kind, k):
    """The device candidate scan: the count and the candidate set exactly,
    the candidates' scores within 2e-4, with a carried left neighbour."""
    rng = np.random.default_rng(3)
    pats, freqs = templates(kind, rng)
    c = 1024
    x = batch(rng, pats, c, 6)
    thr = float(np.float32(0.3))
    for left in (-np.inf, 0.95):
        want = jcorr.make_xcorr_post(pats, c, freqs, extract=(thr, k))(jnp.asarray(x), jnp.float32(left))
        want = [np.asarray(a) for a in want]
        post = tcorr.make_xcorr_post(pats, c, freqs, extract=(thr, k))
        got = [a.numpy() for a in post(torch.from_numpy(x), torch.tensor(left, dtype=torch.float32))]
        n = int(want[4])
        assert int(got[4]) == n and n >= 5
        assert len(got[0]) == min(k, x.size - 6 * 299 - 1)
        m = min(n, k)
        assert set(got[1][:m].tolist()) == set(want[1][:m].tolist())
        order_g, order_w = np.argsort(got[1][:m]), np.argsort(want[1][:m])
        for i in (0, 2, 3):  # vals, scales, rows
            np.testing.assert_allclose(got[i][:m][order_g], want[i][:m][order_w], rtol=0, atol=TOL)
        assert np.all(got[0][m:] == -1) if n < k else True
        np.testing.assert_allclose([float(v) for v in got[5:]], [float(v) for v in want[5:]], rtol=0, atol=TOL)


# -- the host scan -----------------------------------------------------------


@pytest.mark.parametrize("seed", range(3))
def test_peakscan_bitwise(seed):
    """Ragged feeds and device-extracted dispatches through both scanners:
    the same offsets, scores and aux rows, bit for bit."""
    rng = np.random.default_rng(seed)
    s = np.round(rng.random(3000), 2).astype(np.float32)  # ties between neighbours
    aux = rng.random((3000, 2)).astype(np.float32)
    scans = [jcorr.PeakScan(0.6), tcorr.PeakScan(0.6)]
    o = 0
    while o < len(s):
        sz = int(rng.integers(1, 400))
        m = min(sz, len(s) - o)
        if rng.random() < 0.5 and m > 2:
            # a device dispatch, decided by the same comparisons on the host
            for sc in scans:
                left = sc.carry
                v, lefts = s[o : o + m - 1], np.concatenate([[left], s[o : o + m - 2]])
                mask = (v >= np.float32(0.6)) & (v >= lefts) & (v >= s[o + 1 : o + m])
                idx = np.nonzero(mask)[0][::-1]  # any order: feed_extract sorts
                res = (v[idx], idx, aux[o + idx, 0], aux[o + idx, 1], len(idx), s[o], s[o + m - 2], s[o + m - 1],
                       aux[o + m - 1, 0], aux[o + m - 1, 1])
                assert sc.feed_extract(o, m, res)
                assert not sc.feed_extract(o + m, 1, (np.zeros(0),) * 4 + (1,) + (0.0,) * 5)  # overflow
        else:
            for sc in scans:
                sc.feed(o, s[o : o + m], aux[o : o + m])
        o += m
    for sc in scans:
        sc.finish()
    j, t = scans
    assert t.offsets == j.offsets and t.scores == j.scores and len(t.offsets) > 50
    assert np.array_equal(np.asarray(t.aux), np.asarray(j.aux))
    with pytest.raises(ValueError, match="non-contiguous feed"):
        t.feed(5, s[:3], aux[:3])
        t.feed(9, s[:3], aux[:3])


@pytest.mark.parametrize("seed", range(4))
def test_suppress_bitwise(seed):
    rng = np.random.default_rng(seed)
    off = np.sort(rng.choice(5000, 400, replace=False))
    sc = np.round(rng.random(400), 1).astype(np.float32)  # many ties: the stable order decides
    for dist in (1, 7, 50):
        for top in (None, 0, 1, 25):
            assert np.array_equal(tcorr.suppress(off, sc, dist, top), jcorr.suppress(off, sc, dist, top))
    assert len(tcorr.suppress(off, sc, 5, 0)) == 0


# -- find_pattern ------------------------------------------------------------


def shrink(monkeypatch, budget: int | None = None, topk: int | None = None) -> None:
    for mod in (jsinks, tsinks):
        if budget is not None:
            monkeypatch.setattr(mod, "FIND_DISPATCH_BUDGET", budget)
        if topk is not None:
            monkeypatch.setattr(mod, "FIND_TOPK", topk)


def assert_same(got, want) -> None:
    assert np.array_equal(got.offsets, want.offsets)
    assert np.array_equal(got.which, want.which)
    assert np.array_equal(got.freqs, want.freqs)
    np.testing.assert_allclose(got.scores, want.scores, rtol=0, atol=TOL)
    np.testing.assert_allclose(got.scales, want.scales, rtol=0, atol=TOL)
    assert (got.pattern_len, got.scanned) == (want.pattern_len, want.scanned)


def planted(seed: int, n: int, l: int, offsets, sigma: float = 0.03):
    rng = np.random.default_rng(seed)
    p = noise(rng, l)
    x = noise(rng, n, sigma)
    for i, o in enumerate(offsets):
        x[o : o + l] += np.complex64(0.8 * np.exp(1j * i)) * p
    return x, p


def dispatches(fn):
    tsinks.find_pattern.dispatches.update(extract=0, overflow=0, full=0)
    out = fn()
    return out, dict(tsinks.find_pattern.dispatches)


@pytest.mark.parametrize("budget,topk,chunk", [(1 << 15, 1024, 8192), (1 << 15, 1, 8192), (1 << 22, 1024, 8192),
                                               (1 << 14, 1024, None)])
def test_find_pattern_across_dispatches(budget, topk, chunk, monkeypatch):
    """Several dispatches (the pending element handed over at each
    boundary), top-k overflow into the full-score path, one fat batch, the
    default block: the JAX package's matches."""
    plants = [100, 30_000, 59_777, 90_000, 119_000]
    x, p = planted(21, 120_000, 512, plants)
    j_src, t_src = sources(x)
    shrink(monkeypatch, budget, topk)
    want = jsinks.find_pattern(j_src, p, threshold=0.5, chunk=chunk)
    got, n = dispatches(lambda: tsinks.find_pattern(t_src, p, threshold=0.5, chunk=chunk, device=CPU))
    assert list(got.offsets) == plants
    assert_same(got, want)
    # one fat batch holds the ragged last window: the full-score path alone
    if budget == 1 << 22:
        assert n == {"extract": 0, "overflow": 0, "full": 1}
    elif topk == 1:
        assert n["overflow"] >= 1 and n["full"] == n["overflow"] + 1
    else:
        assert n["extract"] >= 3 and n["overflow"] == 0 and n["full"] == 1


@pytest.mark.parametrize("l", [200, 1024])
def test_block_does_not_change_matches(l):
    """Blocks of 2*l, the default and 32*l find the same offsets,
    templates and grid rows; scores within 2e-4
    (``tests/test_find.py::test_chunk_size_invariance``)."""
    n = 300_000
    x, p = planted(9, n, l, [0, 20_011, 150_001, n - l], sigma=0.02)
    _, t_src = sources(x)
    other = noise(np.random.default_rng(10), l // 2)
    runs = [tsinks.find_pattern(t_src, [p, other], threshold=0.5, chunk=c, freq_tol=100.0, device=CPU)
            for c in (None, 2 * l, 32 * l)]
    for got in runs[1:]:
        assert_same(got, runs[0])
    assert list(runs[0].offsets) == [0, 20_011, 150_001, n - l] and set(runs[0].which) == {0}


def test_find_block():
    assert [tsinks.find_block(l, 1 << 30) for l in (2, 100, 1024, 4096, 40_000)] == [4096, 4096, 4096, 16384, 262144]
    assert tsinks.find_block(1024, 1500) == 2048  # a short stream: at least 2l
    assert tsinks.find_block(100, 3000) == 4096  # else pow2(min(chunk, length))
    assert tsinks.find_block(1024, 5000, chunk=3000, live=True) == 4096  # a pipe: the chunk itself


def test_find_pattern_clustered_candidates(monkeypatch):
    """Two candidates three lags apart in one dispatch, both kept
    (min_distance 1), on the extract path and through top-k overflow."""
    rng = np.random.default_rng(24)
    p = noise(rng, 256)
    x = noise(rng, 40_000, 0.02)
    x[2048 : 2048 + 256] += np.complex64(0.9) * p
    x[2051 : 2051 + 256] += np.complex64(0.7 * np.exp(0.4j)) * p
    j_src, t_src = sources(x)
    shrink(monkeypatch, budget=1 << 15)
    for topk in (1024, 1):
        shrink(monkeypatch, topk=topk)
        kw = dict(threshold=0.2, chunk=8192, min_distance=1)
        got = tsinks.find_pattern(t_src, p, device=CPU, **kw)
        assert_same(got, jsinks.find_pattern(j_src, p, **kw))
        assert {2048, 2051} <= set(got.offsets.tolist())


def test_find_pattern_aligned_tail(monkeypatch):
    """A capture whose windows tile it exactly: the match at the very last
    lag is the pending element that ``finish`` decides."""
    l, c = 512, 8192
    n = 4 * (c - l + 1) + l - 1
    rng = np.random.default_rng(22)
    p = noise(rng, l)
    x = noise(rng, n, 0.03)
    x[n - l :] += 0.8 * p
    j_src, t_src = sources(x)
    shrink(monkeypatch, budget=1 << 15)
    got, counts = dispatches(lambda: tsinks.find_pattern(t_src, p, threshold=0.5, chunk=c, device=CPU))
    assert list(got.offsets) == [n - l] and counts == {"extract": 1, "overflow": 0, "full": 0}
    assert_same(got, jsinks.find_pattern(j_src, p, threshold=0.5, chunk=c))


def test_find_pattern_bank_and_grid(monkeypatch):
    """A two-template bank under a carrier-offset grid: offsets, which and
    freqs exact, on the extract path and through overflow."""
    sr, l = 48_000, 400
    rng = np.random.default_rng(23)
    pa, pb = noise(rng, l), noise(rng, l // 2)
    x = noise(rng, 60_000, 0.03)
    m = np.arange(l)
    x[5_000 : 5_000 + l] += 0.7 * pa * np.exp(2j * np.pi * 96.0 * m / sr).astype(np.complex64)
    x[40_000 : 40_000 + l // 2] += 0.9 * pb
    j_src, t_src = sources(x, sr)
    kw = dict(threshold=0.4, chunk=4096, freq_tol=300.0)
    shrink(monkeypatch, budget=1 << 14)
    for topk in (1024, 1):
        shrink(monkeypatch, topk=topk)
        got = tsinks.find_pattern(t_src, [pa, pb], device=CPU, **kw)
        assert_same(got, jsinks.find_pattern(j_src, [pa, pb], **kw))
        assert list(got.offsets) == [5_000, 40_000] and list(got.which) == [0, 1]
        assert got.freqs[0] == 96.0 and got.freqs[1] == 0.0


@pytest.mark.parametrize("top,distance", [(0, None), (1, None), (0, 1024)])
def test_find_pattern_top_and_distance(top, distance):
    x, p = planted(13, 30_000, 100, [2_000, 9_000, 9_400])
    j_src, t_src = sources(x)
    kw = dict(threshold=0.2, max_matches=top or None, min_distance=distance)
    assert_same(tsinks.find_pattern(t_src, p, device=CPU, **kw), jsinks.find_pattern(j_src, p, **kw))


def test_live_pipe_matches_file():
    """find over a live pipe (length unknown until EOF, the EOF batch run
    again) returns the file run's matches."""
    x, p = planted(51, 120_000, 400, [100, 60_000, 120_000 - 407], sigma=0.01)
    _, t_src = sources(x)
    want = tsinks.find_pattern(t_src, p, threshold=0.5, chunk=8_192, device=CPU)
    pipe = tsources.PipeSource(io.BytesIO(cf32_bytes(x).tobytes()), FileFormat.COMPLEX_FLOAT32, 48_000)
    got = tsinks.find_pattern(tsources.LivePipeStream(pipe), p, threshold=0.5, chunk=8_192, device=CPU)
    assert_same(got, want)
    np.testing.assert_array_equal(got.scores, want.scores)
    assert list(want.offsets) == [100, 60_000, 120_000 - 407]


def test_error_texts_match_jax(monkeypatch):
    rng = np.random.default_rng(1)
    x = noise(rng, 100)
    j_src, t_src = sources(x)
    j_short, t_short = sources(x[:10])
    cases = [
        ((j_src, t_src), x[:1], {}), ((j_short, t_short), x[:50], {}), ((j_src, t_src), x[:10], {"threshold": 0.0}),
        ((j_src, t_src), np.zeros(8, np.complex64), {}), ((j_src, t_src), x[:50], {"freq_tol": -1.0}),
        ((j_src, t_src), x[:50], {"freq_tol": 20_000.0, "freq_step": 1.0}),
        ((j_src, t_src), x[:50], {"freq_tol": 100.0, "freq_step": -1.0}),
    ]
    for (js, ts), pat, kw in cases:
        with pytest.raises(ValueError) as want:
            jsinks.find_pattern(js, pat, **kw)
        with pytest.raises(ValueError) as got:
            tsinks.find_pattern(ts, pat, device=CPU, **kw)
        assert str(got.value) == str(want.value)
    # the candidate cap
    tone = np.exp(2j * np.pi * 0.01 * np.arange(60_000)).astype(np.complex64)
    j_src, t_src = sources(tone)
    for mod in (jsinks, tsinks):
        monkeypatch.setattr(mod, "FIND_CANDIDATE_CAP", 1_000)
    with pytest.raises(ValueError) as want:
        jsinks.find_pattern(j_src, tone[:64], threshold=0.5, chunk=8_192)
    with pytest.raises(ValueError) as got:
        tsinks.find_pattern(t_src, tone[:64], threshold=0.5, chunk=8_192, device=CPU)
    assert str(got.value) == str(want.value) and "matches nearly everywhere" in str(got.value)


def test_mesh_names_roadmap_a13():
    x, p = planted(1, 5_000, 64, [100])
    with pytest.raises(NotImplementedError, match="ROADMAP A13"):
        tsinks.find_pattern(sources(x)[1], p, mesh=(2, 1), device=CPU)


# -- the CLI -----------------------------------------------------------------


def run(main, argv, capsys) -> tuple[int, str, str]:
    rc = main(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


@pytest.fixture
def cpu(monkeypatch, tmp_path):
    monkeypatch.setenv("QUADRS_PLATFORM", "cpu")
    monkeypatch.chdir(tmp_path)
    return tmp_path


def files(tmp: pathlib.Path, fmt: str = "cf32") -> tuple[str, str, str]:
    """A capture with three plants of ``p0`` (one under a 240 Hz carrier
    offset) and one of ``p1``, and the two templates."""
    rng = np.random.default_rng(31)
    n, sr = 40_000, 48_000
    p0, p1 = noise(rng, 400), noise(rng, 256)
    x = noise(rng, n, 0.01)
    m = np.arange(400)
    x[12_345 : 12_345 + 400] += 0.5 * p0
    x[20_000 : 20_000 + 400] += 0.3 * p0 * np.exp(2j * np.pi * 240.0 * m / sr).astype(np.complex64)
    x[30_001 : 30_001 + 256] += 2.0 * p1
    x[n - 400 :] += 0.2 * p0
    if fmt == "cs8":
        iq = np.clip(np.rint(np.stack([x.real, x.imag], -1) * 60), -127, 127).astype(np.int8)
        (tmp / "cap.sr48k.cs8").write_bytes(iq.tobytes())
    else:
        (tmp / "cap.sr48k.cf32").write_bytes(cf32_bytes(x).tobytes())
    for name, arr in (("p0", p0), ("p1", p1)):
        (tmp / f"{name}.sr48k.cf32").write_bytes(cf32_bytes(arr).tobytes())
    return f"cap.sr48k.{fmt}", "p0.sr48k.cf32", "p1.sr48k.cf32"


def same_lines(got: str, want: str) -> None:
    """Match lines equal but for f32 noise: offsets, freqs and which exact,
    scores and scales within 2e-4 (and the print's rounding)."""
    g, w = got.splitlines(), want.splitlines()
    assert len(g) == len(w) and g[-1] == w[-1] and w[-1].startswith("find: ")
    for gl, wl in zip(g[:-1], w[:-1]):
        if not wl[0].isdigit():
            assert gl == wl
            continue
        gf, wf = gl.split(","), wl.split(",")
        assert (gf[0], gf[3:]) == (wf[0], wf[3:])
        assert abs(float(gf[1]) - float(wf[1])) <= TOL + 5e-5
        assert abs(float(gf[2]) - float(wf[2])) <= TOL * max(1.0, abs(float(wf[2])))


@pytest.mark.parametrize(
    "extra",
    [[], ["-threshold", "0.8"], ["-pattern", "P1"], ["-pattern", "P1", "-freq-tol", "300", "-threshold", "0.6"],
     ["-top", "1"], ["-distance", "20k"]],
    ids=["single", "threshold", "bank", "bank-grid", "top", "distance"],
)
@pytest.mark.parametrize("fmt", ["cf32", "cs8"])
def test_cli_matches_jax(extra, fmt, cpu, capsys):
    cap, p0, p1 = files(cpu, fmt)
    argv = ["from", cap, "find", "-pattern", p0, *[p1 if a == "P1" else a for a in extra]]
    j_rc, j_out, j_err = run(jcli.main, argv, capsys)
    t_rc, t_out, t_err = run(tcli.main, argv, capsys)
    assert (t_rc, t_err) == (j_rc, j_err) == (0, "")
    same_lines(t_out, j_out)
    assert t_out.count("\n") >= 2


def test_cli_write_matches_jax(cpu, capsys):
    """-write behind a chain (its spans mapped through the filter's
    lookahead): the same file names, each a byte slice of the capture."""
    cap, p0, p1 = files(cpu, "cs8")
    def argv(tag: str) -> list[str]:
        return ["from", cap, "lowpass", "-decimate", "1", "20k", "find", "-pattern", p0, "-pattern", p1,
                "-threshold", "0.4", "-write", tag, "-pre", "100", "-post", "50"]

    for tag, main in (("j", jcli.main), ("t", tcli.main)):
        rc, out, err = run(main, argv(tag), capsys)
        assert (rc, err) == (0, "")
        outs = out if tag == "j" else (outs, out)
    same_lines(outs[1].replace(" t.m", " j.m"), outs[0])
    names = sorted(f.name for f in cpu.glob("j.m*"))
    assert len(names) == 3 and sorted(f.name for f in cpu.glob("t.m*")) == [n.replace("j.", "t.", 1) for n in names]
    raw = (cpu / cap).read_bytes()
    for name in names:
        data = (cpu / name.replace("j.", "t.", 1)).read_bytes()
        assert data == (cpu / name).read_bytes()
        s0 = int(name.split(".s")[1].split(".")[0])
        assert data == raw[2 * s0 : 2 * s0 + len(data)]
    # no clobber without -overwrite, as the JAX package
    assert run(tcli.main, argv("t"), capsys)[0] == run(jcli.main, argv("j"), capsys)[0] == 1
    assert run(tcli.main, [*argv("t"), "-overwrite", "yes"], capsys)[0] == 0


@pytest.mark.parametrize("bank", [False, True])
def test_cli_stdin_matches_jax(bank, cpu, capsys, monkeypatch):
    """``find -stdin yes`` over a pipe prints what the JAX package prints,
    and what the file run prints; the accumulator stays untouched."""
    cap, p0, p1 = files(cpu)
    pats = ["-pattern", p0] + (["-pattern", p1, "-freq-tol", "300"] if bank else [])
    argv = ["find", *pats, "-stdin", "yes", "-sr", "48k", "-format", "cf32"]
    outs = []
    for main in (jcli.main, tcli.main):
        monkeypatch.setattr(sys, "stdin", types.SimpleNamespace(buffer=io.BytesIO((cpu / cap).read_bytes())))
        outs.append(run(main, ["gen", "-cos", "1k", "-len", "0.01", "48k", *argv, "bucket", "-by", "freq", "2"], capsys))
    (j_rc, j_out, j_err), (t_rc, t_out, t_err) = outs
    assert (t_rc, t_err) == (j_rc, j_err) == (0, "")
    # the bucket digits of the generator follow the matches: the accumulator is the gen stream
    assert t_out.splitlines()[-1] == j_out.splitlines()[-1] and set(t_out.splitlines()[-1]) <= {"0", "1"}
    same_lines("\n".join(t_out.splitlines()[:-1]), "\n".join(j_out.splitlines()[:-1]))
    file_out = run(tcli.main, ["from", cap, "find", *pats], capsys)[1]
    same_lines("\n".join(t_out.splitlines()[:-1]), file_out.strip())


@pytest.mark.parametrize(
    "argv",
    [["from", "CAP", "find", "-pattern", "P0", "-sr", "96k"], ["find", "-pattern", "P0"],
     ["from", "CAP", "find", "-pattern", "nope.sr48k.cf32"], ["from", "CAP", "find", "-pattern", "P0", "-threshold", "2"],
     ["from", "CAP", "find", "-pattern", "P0", "-stdin", "yes"], ["from", "CAP", "find", "-pattern", "P0", "-mesh", "2x2"]],
    ids=["rate", "no-input", "missing", "threshold", "stdin-sr", "mesh-axis"],
)
def test_cli_errors_match_jax(argv, cpu, capsys):
    cap, p0, _ = files(cpu)
    argv = [{"CAP": cap, "P0": p0}.get(a, a) for a in argv]
    (t_rc, t_out, t_err), (j_rc, j_out, j_err) = run(tcli.main, argv, capsys), run(jcli.main, argv, capsys)
    assert (t_rc, t_err) == (j_rc, j_err) and t_rc == 1
    assert ("usage:" in t_out) == ("usage:" in j_out)


def test_cli_mesh_names_roadmap_a13(cpu, capsys):
    cap, p0, _ = files(cpu)
    rc, out, err = run(tcli.main, ["from", cap, "find", "-pattern", p0, "-mesh", "2"], capsys)
    assert rc == 1 and "ROADMAP A13" in err and "find:" not in out
