"""The reference command chain's stream graph and sinks
(``quadrs_tpu_torch.sources``, ``.stream``, ``.runtime``, ``.sinks``) on
the CPU, against quadrs_tpu's and the sequential numpy oracle
(``tests/oracle.py``).

Reads agree to the oracle's tolerances (``tests/test_shift.py``,
``tests/test_filter.py``, ``tests/test_gen.py``); decode is bit-exact.
Glyph rows and bucket digits are identical: on the bundled examples no
norm sits within f32 noise of a decision boundary (the margin checks of
``tests/test_sparkfft.py``)."""

import io
import pathlib

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from oracle import (  # noqa: E402
    OracleArray,
    OracleGen,
    OracleLowPass,
    OracleShift,
    oracle_freq_levels,
    oracle_spark_fft,
)
from quadrs_tpu import sinks as jsinks  # noqa: E402
from quadrs_tpu import sources as jsources  # noqa: E402
from quadrs_tpu import stream as jstream  # noqa: E402
from quadrs_tpu.formats import FileFormat as JFormat  # noqa: E402

from quadrs_tpu_torch import sinks as tsinks  # noqa: E402
from quadrs_tpu_torch import sources as tsources  # noqa: E402
from quadrs_tpu_torch import stream as tstream  # noqa: E402
from quadrs_tpu_torch.formats import FileFormat, decode_plane, planes_from_bytes  # noqa: E402
from quadrs_tpu_torch.runtime import Executor, root_step_of, window_batches  # noqa: E402

EXAMPLES = pathlib.Path(__file__).resolve().parent.parent / "examples"
CPU = "cpu"


def capture_bytes(fmt: str, n: int, seed: int) -> np.ndarray:
    """``n`` seeded samples of ``fmt`` as interleaved capture bytes."""
    rng = np.random.default_rng(seed)
    if fmt == "cf32":
        data = (rng.normal(size=n) + 1j * rng.normal(size=n)).astype(np.complex64)
        return np.ascontiguousarray(data).view(np.uint8)
    dtype = FileFormat(fmt).raw_dtype
    info = np.iinfo(dtype)
    return rng.integers(info.min, info.max + 1, 2 * n).astype(dtype).view(np.uint8)


def sources(fmt: str, n: int, seed: int = 3, sr: int = 48_000):
    raw = capture_bytes(fmt, n, seed)
    return (
        jsources.SampleSource(raw, JFormat(fmt), sr),
        tsources.SampleSource(raw, FileFormat(fmt), sr),
        OracleArray(decoded(raw, fmt), sr),
    )


def decoded(raw: np.ndarray, fmt: str) -> np.ndarray:
    planes = planes_from_bytes(raw, FileFormat(fmt))
    return decode_plane(planes[0], FileFormat(fmt)) + 1j * decode_plane(planes[1], FileFormat(fmt))


@pytest.mark.parametrize("fmt", ["cf32", "cs8", "cu8", "cs16"])
def test_sample_source_reads(fmt):
    """Decode is bit-exact with the reference formulas (the oracle's numpy
    decode) and within an ulp of the JAX package's jitted decode; reads
    past EOF come up short and are zero past their valid count."""
    j, t, o = sources(fmt, 3000, seed=len(fmt))
    for off, n in [(0, 256), (1234, 700), (2900, 512), (3000, 4)]:
        want, want_valid = j.read_at(off, n)
        got, valid = t.read_at(off, n, CPU)
        assert valid == want_valid == min(n, max(0, 3000 - off))
        assert got.dtype == np.complex64 and got.shape == (n,)
        np.testing.assert_allclose(got, np.asarray(want), rtol=2e-7, atol=0)
        assert not got[valid:].any()
        if valid:
            assert got[:valid].tobytes() == o.read_at(off, n)[:valid].tobytes()


def test_shift_reads_and_phase_coherence():
    j, t, o = sources("cf32", 4096)
    for f, off, n in [(1234, 0, 4096), (-9999, 100, 1000), (777, 4000, 200)]:
        want, _ = jstream.Shift(j, f, 48_000).read_at(off, n)
        got, valid = tstream.Shift(t, f, 48_000).read_at(off, n, CPU)
        np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=2e-6)
        np.testing.assert_allclose(got[:valid], OracleShift(o, f, 48_000).read_at(off, n), rtol=0, atol=2e-6)
    sh = tstream.Shift(t, 777, 48_000)
    whole, _ = sh.read_at(0, 2048, CPU)
    part, _ = sh.read_at(1500, 256, CPU)
    np.testing.assert_allclose(part, whole[1500:1756], rtol=0, atol=5e-6)
    with pytest.raises(ValueError, match="half the sample rate"):
        tstream.Shift(t, 24_000, 48_000)


def test_phase_coherent_at_huge_offsets():
    """A generator and a shift read far past f32's exact integers: the
    angles are exact integer reductions, so each sample is the exact
    rotation to f32 trig."""
    sr, off = 48_000, 3_000_000_000_017
    tg = tsources.ToneGen([333], sr, 1e8)
    jg = jsources.ToneGen([333], sr, 1e8)
    k = np.arange(8)
    for t_node, j_node, f in [(tg, jg, 333), (tstream.Shift(tg, -1234), jstream.Shift(jg, -1234), 333 - 1234)]:
        got, valid = t_node.read_at(off, 8, CPU)
        want = np.exp(2j * np.pi * ((f * (off + k)) % sr) / sr)
        assert valid == 8
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
        np.testing.assert_allclose(got, np.asarray(j_node.read_at(off, 8)[0]), rtol=0, atol=1e-6)


@pytest.mark.parametrize("impl", ["direct", "polyphase", "auto"])
def test_lowpass_reads(impl):
    """Shift -> LowPass reads against the JAX package and the oracle: whole
    reads, offset reads, the truncated tail at EOF and the per-read
    truncation at block edges."""
    j, t, o = sources("cf32", 8192, seed=5)
    jl = jstream.LowPass(jstream.Shift(j, 1500, 48_000), 2000, 8, 40, fir_impl=impl)
    tl = tstream.LowPass(tstream.Shift(t, 1500, 48_000), 2000, 8, 40, fir_impl=impl)
    ol = OracleLowPass(OracleShift(o, 1500, 48_000), 2000, 8, 40)
    assert (tl.length, tl.sample_rate) == (jl.length, jl.sample_rate) == (1 + (8192 - 40) // 8, 6000)
    for off, n in [(0, 64), (100, 128), (500, 32), (500 + 32, 32), (tl.length - 3, 8)]:
        got, valid = tl.read_at(off, n, CPU)
        want, want_valid = jl.read_at(off, n)
        assert valid == want_valid == len(ol.read_at(off, n))
        np.testing.assert_allclose(got[:valid], np.asarray(want)[:valid], rtol=0, atol=1e-5)
        np.testing.assert_allclose(got[:valid], ol.read_at(off, n), rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="shorter than the filter"):
        tstream.LowPass(sources("cf32", 30)[1], 2000, 8, 40)


def test_long_lowpass_reads():
    """4000 taps: auto takes the polyphase overlap-save."""
    j, t, o = sources("cf32", 16384, seed=6)
    got, valid = tstream.LowPass(t, 500, 8, 2000).read_at(0, 256, CPU)
    want = OracleLowPass(o, 500, 8, 2000).read_at(0, 256)
    assert valid == len(want)
    np.testing.assert_allclose(got[:valid], want, rtol=0, atol=5e-5 * np.abs(want).max())
    np.testing.assert_allclose(got, np.asarray(jstream.LowPass(j, 500, 8, 2000).read_at(0, 256)[0]),
                               rtol=0, atol=5e-5 * np.abs(want).max())


def test_tone_gen_reads():
    for cos, sr, secs, off, n in [([20], 400, 1.0, 0, 400), ([-7000, 1, 12_345], 48_000, 0.25, 777, 512)]:
        got, valid = tsources.ToneGen(cos, sr, secs).read_at(off, n, CPU)
        assert valid == n  # Gen always fills
        np.testing.assert_allclose(got, OracleGen(cos, sr, secs).read_at(off, n), rtol=0, atol=4e-6)
        np.testing.assert_allclose(got, np.asarray(jsources.ToneGen(cos, sr, secs).read_at(off, n)[0]),
                                   rtol=0, atol=4e-6)
    tg = tsources.ToneGen([100], 48_000, 0.1, noise=0.2, seed=7)
    jg = jsources.ToneGen([100], 48_000, 0.1, noise=0.2, seed=7)
    offs = np.asarray([0, 12_345, 3_000_000_000_017])
    for a, b in zip(tg._noise_planes(offs, 64), jg._noise_planes(offs, 64)):
        assert a.tobytes() == b.tobytes()  # the counter-based noise, bit for bit
    got, _ = tg.read_at(700, 300, CPU)
    np.testing.assert_allclose(got, np.asarray(jg.read_at(700, 300)[0]), rtol=0, atol=1e-6)
    assert tg.length == 4800 and tsources.ToneGen([1], 400, 0.9999).length == 399
    for bad in [([], 400, 1.0), ([1], 0, 1.0), ([1], 400, 0.0)]:
        with pytest.raises(ValueError):
            tsources.ToneGen(*bad)


def test_spark_fft_ook_rows_identical():
    """The verify skill's OOK flow: ``sparkfft -width 4 -stride 2 -range
    0.001:0.01`` over the bundled capture, row for row."""
    path = str(EXAMPLES / "ook-sim.sr400.cf32")
    got = tsinks.spark_fft(tsources.open_capture(path), width=4, stride=2, lo=0.001, hi=0.01, device=CPU)
    want = jsinks.spark_fft(jsources.open_capture(path), width=4, stride=2, lo=0.001, hi=0.01)
    assert got == want and got[0] == "sparkfft sample_rate=400" and len(got) > 600
    raw = np.fromfile(path, dtype=np.uint8)
    oracle = oracle_spark_fft(OracleArray(decoded(raw, "cf32"), 400), 4, 2, 0.001, 0.01)
    assert [r.strip("│") for r in got[1:]] == oracle


def test_spark_fft_chain_and_errors():
    j, t, _ = sources("cf32", 20_000, seed=8)
    jl = jstream.LowPass(jstream.Shift(j, 3000, 48_000), 4000, 4, 40)
    tl = tstream.LowPass(tstream.Shift(t, 3000, 48_000), 4000, 4, 40)
    lines = []
    assert tsinks.spark_fft(tl, width=32, stride=16, lo=0.5, hi=3.0, out=lines.append, device=CPU) is None
    assert lines == jsinks.spark_fft(jl, width=32, stride=16, lo=0.5, hi=3.0)
    short = tsources.ToneGen([5], 400, 0.1)  # 40 samples
    with pytest.raises(ValueError, match="shorter than fft width"):
        tsinks.spark_fft(short, width=64, device=CPU)
    assert tsinks.spark_fft(short, width=40, device=CPU) == ["sparkfft sample_rate=400"]


@pytest.mark.parametrize("width,stride", [(64, 2400), (128, None)])
def test_freq_levels_fsk_identical(width, stride):
    """``bucket -by freq 2`` over the bundled FSK capture, digit for digit
    (the JAX package takes its streaming route here, this port the
    per-window one)."""
    path = str(EXAMPLES / "fsk-sim.sr48k.cf32")
    got = tsinks.freq_levels(tsources.open_capture(path), width, stride, device=CPU).vals
    want = jsinks.freq_levels(jsources.open_capture(path), width, stride).vals
    assert got == want and {0, 1} == set(got)
    raw = np.fromfile(path, dtype=np.uint8)
    assert got == oracle_freq_levels(OracleArray(decoded(raw, "cf32"), 48_000), width, stride or width)


def test_freq_levels_chain_identical():
    """shift -> lowpass -> bucket over the FSK capture."""
    path = str(EXAMPLES / "fsk-sim.sr48k.cf32")
    t = tstream.LowPass(tstream.Shift(tsources.open_capture(path), 6000), 8000, 4, 40)
    j = jstream.LowPass(jstream.Shift(jsources.open_capture(path), 6000), 8000, 4, 40)
    got = tsinks.freq_levels(t, 64, 32, device=CPU).vals
    assert got == jsinks.freq_levels(j, 64, 32).vals and len(got) > 100
    raw = np.fromfile(path, dtype=np.uint8)
    o = OracleLowPass(OracleShift(OracleArray(decoded(raw, "cf32"), 48_000), 6000, 48_000), 8000, 4, 40)
    assert got == oracle_freq_levels(o, 64, 32)
    with pytest.raises(ValueError, match="two levels"):
        tsinks.freq_levels(t, 64, 32, levels=3, device=CPU)


def gen_chain(pkg_stream, pkg_sources):
    g = pkg_sources.ToneGen([200, -1200], 48_000, 2.1)
    return pkg_stream.LowPass(pkg_stream.Shift(g, 1000), 2000, 8, 40)


def test_write_cf32_and_integer_formats(tmp_path):
    """cf32 within ``1e-5`` of the JAX package's file; integer formats
    byte-equal to its files."""
    t_chain, j_chain = gen_chain(tstream, tsources), gen_chain(jstream, jsources)
    tp = tsinks.do_write(t_chain, False, "t", directory=str(tmp_path), device=CPU)
    jp = jsinks.do_write(j_chain, False, "j", directory=str(tmp_path))
    assert tp.endswith("t.sr6000.cf32")
    got, want = np.fromfile(tp, np.complex64), np.fromfile(jp, np.complex64)
    assert got.shape == want.shape == (-(-t_chain.length // 0x1000) * 0x1000,)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    for fmt in ("cs8", "cu8", "cs16"):
        # cu8 and cs16 from a capture of their own format: its DC offset fits
        raw = capture_bytes(fmt, 9000, seed=len(fmt))
        src = tsources.SampleSource(raw, FileFormat(fmt), 48_000)
        jsrc = jsources.SampleSource(raw, JFormat(fmt), 48_000)
        t_node, j_node = (src, jsrc) if fmt != "cs8" else (t_chain, j_chain)
        tp = tsinks.do_write(t_node, False, "t", directory=str(tmp_path), fmt=fmt, device=CPU)
        jp = jsinks.do_write(j_node, False, "j", directory=str(tmp_path), fmt=fmt)
        assert pathlib.Path(tp).read_bytes() == pathlib.Path(jp).read_bytes(), fmt
    assert pathlib.Path(tmp_path / "t.sr48000.cu8").read_bytes() == capture_bytes("cu8", 9000, seed=3).tobytes()


def test_write_batched_matches_sequential(tmp_path):
    """Many 0x1000-sample pulls per batch write the bytes of the
    reference's one-pull-per-iteration loop."""
    _, src, _ = sources("cf32", 0x1000 * 21 + 517, seed=21)
    for node in (src, gen_chain(tstream, tsources)):
        batches = window_batches(np.arange(0, node.length, 0x1000), 0x1000, root_step=root_step_of(node))[1]
        assert len(batches) < -(-node.length // 0x1000)  # several pulls per batch
        path = tsinks.do_write(node, True, "batched", directory=str(tmp_path), device=CPU)
        seq = io.BytesIO()
        tsinks._write_sequential(seq, node, 0, device=CPU)
        assert pathlib.Path(path).read_bytes() == seq.getvalue()


def test_write_decimated_file_tail_raises(tmp_path):
    """The reference's writer hits a zero-length read at the claimed but
    unreadable last output of a decimated file stream, after writing the
    rest; so do both packages, with the same bytes before it."""
    j, t, _ = sources("cf32", 0x1000 * 2 * 8 + 40 + 517, seed=21)
    with pytest.raises(RuntimeError, match="short read at offset") as err:
        tsinks.do_write(tstream.LowPass(t, 2000, 8, 40), False, "t", directory=str(tmp_path), device=CPU)
    with pytest.raises(RuntimeError, match="short read at offset") as jerr:
        jsinks.do_write(jstream.LowPass(j, 2000, 8, 40), False, "j", directory=str(tmp_path))
    assert str(err.value) == str(jerr.value)
    got = np.fromfile(tmp_path / "t.sr6000.cf32", np.complex64)
    want = np.fromfile(tmp_path / "j.sr6000.cf32", np.complex64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_write_no_clobber_and_overwrite_keeps_tail(tmp_path):
    g = tsources.ToneGen([20], 400, 0.1)  # one 0x1000 pull
    path = pathlib.Path(tmp_path / "x.sr400.cf32")
    path.write_bytes(b"\xab" * (0x1000 * 8 + 100))  # longer than what is written
    with pytest.raises(FileExistsError):
        tsinks.do_write(g, False, "x", directory=str(tmp_path), device=CPU)
    tsinks.do_write(g, True, "x", directory=str(tmp_path), device=CPU)
    data = path.read_bytes()
    assert len(data) == 0x1000 * 8 + 100 and data[-100:] == b"\xab" * 100  # not truncated
    assert data[: 0x1000 * 8] == tsources.ToneGen([20], 400, 0.1).read_at(0, 0x1000, CPU)[0].tobytes()
    with pytest.raises(NotImplementedError):
        tsinks.do_write(g, False, "-", device=CPU)


def test_executor_batches_and_checks():
    _, src, _ = sources("cs8", 5000, seed=2)
    ex = Executor(src, 64, CPU, batch=4)
    out, valid = ex.run(np.asarray([0, 100, 4990, 6000]))
    assert out.shape == (4, 64) and list(valid) == [64, 64, 10, 0]
    assert not out[3].any() and not out[2, 10:].any()
    with pytest.raises(ValueError, match="exceeds executor width"):
        ex.run(np.arange(5))
    with pytest.raises(ValueError, match="empty"):
        ex.run(np.asarray([], dtype=np.int64))
    # the budget and the span cap split batches as the JAX package's do
    from quadrs_tpu.runtime import window_batches as j_window_batches

    offs = np.arange(0, 1 << 22, 4096, dtype=np.int64)
    for args in [(64,), (64, 1 << 12), (64, 1 << 20, 1 << 14, 8)]:
        a, b = window_batches(offs, *args), j_window_batches(offs, *args)
        assert a[0] == b[0] and [list(x) for x in a[1]] == [list(x) for x in b[1]]
