"""The executor's batches (``quadrs_tpu_torch.runtime.window_batches``)
capped by the root samples their windows gather, and the helpers the API
documents (``formats.decode_bytes``, ``formats.decode_to_complex64``,
``utils.wav.read_wav_f32``), on the CPU against the JAX package's.

A trailing stage (``dcblock``, ``agc``) re-reads its whole lookback for
every window, and the source gathers each window's read apart.  At the
stages' default windows (32000 and 4000) after ``lowpass -decimate 32``
one window reads 1,154,384 root samples, so the JAX package's rule,
which sizes a batch by output samples alone, gathers 16,384 windows of
them at once under ``sparkfft -width 64``: far more than a card holds.

- **Planning only**: every call site of the port plans batches that
  gather at most the cap (2^26 root samples) over a 2^24-sample capture,
  or generate at most as many over 0.8 s of ``gen`` at 21 Msps (a
  generator stages nothing, but each window generates its whole read),
  and as few batches as that cap allows; each site is stopped before it
  computes anything.  ``span`` and the root step stay the JAX package's.
- **Unchanged where the cap does not bind**: chains with no trailing
  stage plan the JAX package's batches, over a capture or a generator.
- **Outputs unchanged**: with the cap forced low, so that a run splits
  into many batches, ``sparkfft`` rows, ``bucket`` digits, ``write``
  samples and ``take_fft`` norms through ``dcblock`` and ``agc`` are
  bit-equal to the uncapped run's, and equal to the JAX package's within
  the stage tests' tolerances, over captures and a ``gen`` root, with
  ``shift`` in the chain (its product no longer rounds by the row's place
  in the batch).  The chains are small enough that the CPU's
  FIR rule (which depends on a batch's total outputs) takes the same impl
  capped and uncapped.
- **The helpers**: bit-equal to the JAX package's.
"""

import pathlib

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from quadrs_tpu import formats as jformats  # noqa: E402
from quadrs_tpu.models import channelizer as jchannelizer  # noqa: E402
from quadrs_tpu import sinks as jsinks  # noqa: E402
from quadrs_tpu import sources as jsources  # noqa: E402
from quadrs_tpu import stream as jstream  # noqa: E402
from quadrs_tpu.runtime import root_step_of as j_root_step_of  # noqa: E402
from quadrs_tpu.runtime import window_batches as j_window_batches  # noqa: E402
from quadrs_tpu.utils import wav as jwav  # noqa: E402

from quadrs_tpu_torch import formats as tformats  # noqa: E402
from quadrs_tpu_torch import runtime  # noqa: E402
from quadrs_tpu_torch import sinks as tsinks  # noqa: E402
from quadrs_tpu_torch import sources as tsources  # noqa: E402
from quadrs_tpu_torch import stream as tstream  # noqa: E402
from quadrs_tpu_torch.models import channelizer as tchannelizer  # noqa: E402
from quadrs_tpu_torch.models import demod as tdemod  # noqa: E402
from quadrs_tpu_torch.utils import wav as twav  # noqa: E402
from quadrs_tpu_torch.viz import waterfall as tviz  # noqa: E402

CPU = "cpu"
CAP = 1 << 26  # the default cap: root samples one batch gathers
FORMATS = ["cf32", "cs8", "cu8", "cs16"]


# ------------------------------------------------------------ planning only


def big_source(n: int = 1 << 24, rate: int = 21_000_000) -> tsources.SampleSource:
    """A cs8 source of ``n`` samples backed by no memory (a zero-strided
    view): planning reads only its length."""
    return tsources.SampleSource(np.broadcast_to(np.uint8(0), (2 * n,)), tformats.FileFormat("cs8"), rate)


def gen_root(noise: float = 0.0) -> tsources.ToneGen:
    """``gen -cos 280k [-noise N -seed 7] -len 0.8 21M``: 16,800,000
    generated samples, which the executor gathers as it would a capture's."""
    return tsources.ToneGen([280_000], 21_000_000, 0.8, noise=noise, seed=7)


# the chain's root: a capture, or a generator (with its host-made noise)
ROOTS = {"file": big_source, "gen": gen_root, "gen -noise": lambda: gen_root(0.1)}


def fsk_chain(src, stages=True):
    """``shift 280k lowpass -power 200 -decimate 32 200k [dcblock agc]`` at
    the stages' default windows."""
    s = tstream.LowPass(tstream.Shift(src, 280_000), 200_000, 32, 400)
    return tstream.Agc(tstream.DcBlock(s, 32_000)) if stages else s


class Planned(Exception):
    """Raised by the spy once a call site has planned its batches."""


def plan_at(monkeypatch, module, call):
    """The ``(stream, offsets, width, batch, batches)`` that ``call`` plans
    through ``module.stream_batches``; the call stops there."""
    seen = {}

    def spy(stream, offsets, width, **kw):
        batch, batches = runtime.stream_batches(stream, offsets, width, **kw)
        seen.update(stream=stream, offsets=np.asarray(offsets), width=width, batch=batch, batches=batches)
        raise Planned

    monkeypatch.setattr(module, "stream_batches", spy)
    with pytest.raises(Planned):
        call()
    return seen


def _ook(s):
    return tdemod.OokDemod(width=4, stride=2).pulses(s, device=CPU)


def _chunked(s):
    return tdemod._chunked_signal_dev(s, 4096, 1, torch.abs, device=CPU)


def _channelize(s):
    return next(tchannelizer.run_channelize(tchannelizer.Channelize(s, 8, size=64), device=CPU))


def _ui(s):
    return tviz.ui_norms(s, tviz.UiParams(fft_width=64), device=CPU)


# (call site, module whose stream_batches it calls, the call over a stream)
SITES = {
    "sparkfft 64/16": (tsinks, lambda s, d: tsinks.spark_fft(s, 64, 16, device=CPU)),
    "sparkfft 128": (tsinks, lambda s, d: tsinks.spark_fft(s, 128, device=CPU)),
    "bucket freq 2/1": (tsinks, lambda s, d: tsinks.freq_levels(s, 2, 1, device=CPU)),
    "bucket freq 64/16": (tsinks, lambda s, d: tsinks.freq_levels(s, 64, 16, device=CPU)),
    "write": (tsinks, lambda s, d: tsinks.do_write(s, False, "w", directory=d, device=CPU)),
    "take_fft": (tsinks, lambda s, d: tsinks.take_fft(s, None, 256, 2048, device=CPU)),
    "ook": (tdemod, lambda s, d: _ook(s)),
    "audio chunks": (tdemod, lambda s, d: _chunked(s)),
    "channelize": (tchannelizer, lambda s, d: _channelize(s)),
    "ui": (tviz, lambda s, d: _ui(s)),
    "find": (tsinks, lambda s, d: tsinks.find_pattern(s, np.exp(0.3j * np.arange(64)), device=CPU)),
}


@pytest.mark.parametrize("site,root", [
    pytest.param(site, root, id=site if root == "file" else f"{site} {root}") for root in ROOTS for site in SITES])
def test_default_window_batches_gather_at_most_the_cap(site, root, monkeypatch, tmp_path):
    """Each call site over the default-window stage chain on 2^24 samples
    of a capture, or on 0.8 s of a generator at 21 Msps (with and without
    its noise): no batch gathers more than 2^26 root samples, the batch is
    the most windows that fit, and the batches are as few as it allows."""
    module, call = SITES[site]
    seen = plan_at(monkeypatch, module, lambda: call(fsk_chain(ROOTS[root]()), str(tmp_path)))
    read = runtime.root_read_of(seen["stream"], seen["width"])
    assert read >= 32_000 * 32  # every window re-reads the lookback
    n = len(seen["offsets"])
    assert seen["batch"] == max(1, min(n, (1 << 20) // seen["width"], CAP // read))
    assert all(len(b) * read <= max(CAP, read) for b in seen["batches"])
    assert len(seen["batches"]) == -(-n // seen["batch"])
    assert np.array_equal(np.concatenate(seen["batches"]), seen["offsets"])


def test_fsk_sparkfft_numbers():
    """The FSK chain's ``sparkfft -width 64 -stride 16`` over 2^24 samples:
    1,154,384 root samples a window; the JAX package's rule gathers 16,384
    such windows a batch, the cap 58."""
    s = fsk_chain(big_source())
    offs = np.arange(0, s.length - 64, 16, dtype=np.int64)
    assert runtime.root_read_of(s, 64) == 1_154_384
    assert j_window_batches(offs, 64, root_step=runtime.root_step_of(s))[0] == 16_384
    batch, batches = runtime.stream_batches(s, offs, 64)
    assert batch == 58 and len(batches) == -(-len(offs) // 58) == 565
    assert max(len(b) for b in batches) * 1_154_384 <= CAP


def test_gen_fsk_sparkfft_numbers():
    """The same chain over ``gen -cos 280k -len 0.8 21M``: each window
    generates its 1,154,384 root samples, so the cap takes 58 windows a
    batch, not 16,384; the generator stages nothing and its step stays 1."""
    s = fsk_chain(gen_root())
    offs = np.arange(0, s.length - 64, 16, dtype=np.int64)
    assert runtime.root_read_of(s, 64) == 1_154_384
    assert s.span(0, 64) == (0, 0) and runtime.root_step_of(s) == 1
    assert j_window_batches(offs, 64, root_step=runtime.root_step_of(s))[0] == 16_384
    batch, batches = runtime.stream_batches(s, offs, 64)
    assert len(offs) == 32_808 and batch == 58 and len(batches) == -(-len(offs) // 58) == 566


def test_bucket_after_agc_numbers():
    """``agc bucket -by freq 2`` (width 2, stride 1) after the FSK chain:
    the JAX package's rule puts every window in one batch."""
    s = fsk_chain(big_source())
    offs = np.arange((s.length - 2) // 1, dtype=np.int64)
    assert j_window_batches(offs, 2, root_step=runtime.root_step_of(s))[0] == len(offs) == 524_274
    batch, batches = runtime.stream_batches(s, offs, 2)
    read = runtime.root_read_of(s, 2)
    assert batch == CAP // read and len(batches) == -(-len(offs) // batch)
    assert all(len(b) * read <= CAP for b in batches)


def test_window_past_the_cap_runs_alone():
    offs = np.arange(0, 1000, 10, dtype=np.int64)
    batch, batches = runtime.window_batches(offs, 64, root_read=CAP + 1)
    assert batch == 1 and len(batches) == 100
    batch, batches = runtime.window_batches(offs, 64, root_read=1000, gather_cap=7000)
    assert batch == 7 and [len(b) for b in batches] == [7] * 14 + [2]


def test_root_read_is_the_block():
    """Every window reads its whole block: the lookback, clamped at the
    stream's start, moves the block and keeps its length, so the staged
    span holds all that the plan gathers."""
    s = tstream.Agc(tstream.DcBlock(big_source(), 300), window=50)
    assert runtime.root_read_of(s, 64) == 64 + 299 + 49
    assert s.span(0, 64) == (0, 412) and s.span(30, 64) == (0, 412) and s.span(10_000, 64) == (10_000 - 348, 412)
    plan = s.plan(np.asarray([0, 30, 10_000]), 64, 0)
    assert list(plan.prep["inner"]["inner"]["off_rel"]) == [0, 0, 10_000 - 348]
    gen = tsources.ToneGen([100], 48_000, 1.0)
    assert runtime.root_read_of(gen, 64) == 64 and gen.span(0, 64) == (0, 0)  # generated, not staged


def every_node(pkg: str, root: str):
    """Each kind of node over a small capture or generator of the port
    (``pkg`` "t") or the JAX package ("j"), and the FSK stage chain."""
    sources, stream, formats, chan = ((tsources, tstream, tformats, tchannelizer) if pkg == "t" else
                                      (jsources, jstream, jformats, jchannelizer))
    if root == "gen":
        src = sources.ToneGen([3_000], 48_000, 1.0)
    else:
        src = sources.SampleSource(capture("cs8", 48_000), formats.FileFormat("cs8"), 48_000)
    dev = {"device": CPU} if pkg == "t" else {}
    return {
        "source": src,
        "shift": stream.Shift(src, 5_000),
        "lowpass": stream.LowPass(src, 6_000, 4, 40),
        "dcblock": stream.DcBlock(src, 300),
        "agc": stream.Agc(src, window=50),
        "iqbal": stream.IqCorrect(src, c=0.01 - 0.02j, **dev),
        "resample": stream.Resample(src, 3, 2, size=48),
        "channelize": chan.Channelize(src, 8, size=40),
        "stages": stream.Agc(stream.DcBlock(stream.LowPass(stream.Shift(src, 5_000), 6_000, 4, 40), 300), window=50),
    }


@pytest.mark.parametrize("root", ["file", "gen"])
@pytest.mark.parametrize("node", ["source", "shift", "lowpass", "dcblock", "agc", "iqbal", "resample", "channelize",
                                  "stages"])
def test_span_and_step_unchanged_reads_count_the_root(node, root):
    """``span`` and ``root_step_of`` are the JAX package's for every node
    (the trailing stages' span names their whole block, so it is compared
    where the lookback does not clamp), ``(0, 0)`` and 1 over a generator;
    ``reads`` is the root count a capture's span gives, over either root."""
    t, j = every_node("t", root)[node], every_node("j", root)[node]
    t_file = every_node("t", "file")[node]
    assert runtime.root_step_of(t) == j_root_step_of(j)
    for off, n in ((0, 64), (7, 1), (1_000, 333), (30_000, 4096)):
        if node in ("dcblock", "agc", "stages") and off < 2_000:
            continue  # the lookback clamps: the port's span names the block (test_root_read_is_the_block)
        assert t.span(off, n) == j.span(off, n)
        assert t.reads(off, n) == t_file.span(off, n)[1]
        if root == "gen":
            assert t.span(off, n) == (0, 0)


# ------------------------------------------- unchanged where the cap does not bind


def plain_chain(pkg_stream, src, d: int, taps: int):
    return src if d == 1 else pkg_stream.LowPass(pkg_stream.Shift(src, 280_000), 200_000, d, taps)


@pytest.mark.parametrize("d,taps", [(1, 0), (4, 40), (8, 100), (32, 400)])
@pytest.mark.parametrize("width,stride", [(64, 16), (128, 128), (0x1000, 0x1000)])
def test_plain_chain_batches_equal_jax(d, taps, width, stride):
    """No trailing stage: the cap does not bind at these widths and
    decimations, and the batches are the JAX package's."""
    n = 1 << 24
    j_src = jsources.SampleSource(np.broadcast_to(np.uint8(0), (2 * n,)), jformats.FileFormat("cs8"), 21_000_000)
    t, j = plain_chain(tstream, big_source(n), d, taps), plain_chain(jstream, j_src, d, taps)
    offs = np.arange(0, t.length - width, stride, dtype=np.int64)
    got = runtime.stream_batches(t, offs, width)
    want = j_window_batches(offs, width, root_step=j_root_step_of(j))
    assert want[0] * runtime.root_read_of(t, width) <= CAP  # the cap does not bind
    assert got[0] == want[0] and len(got[1]) == len(want[1])
    assert all(np.array_equal(a, b) for a, b in zip(got[1], want[1]))


def plain_gen_chain(pkg_sources, pkg_stream, d: int, taps: int):
    gen = pkg_sources.ToneGen([280_000, -90_000], 21_000_000, 0.8, noise=0.1, seed=7)
    return gen if d == 1 else pkg_stream.LowPass(pkg_stream.Shift(gen, 280_000), 200_000, d, taps)


@pytest.mark.parametrize("d,taps", [(1, 0), (4, 40), (8, 100), (32, 400)])
@pytest.mark.parametrize("width,stride", [(64, 16), (128, 128), (0x1000, 0x1000)])
def test_plain_gen_chain_batches_equal_jax(d, taps, width, stride):
    """A generator root with no trailing stage: the cap, which now counts
    what it generates, does not bind, and the batches are the JAX
    package's."""
    t, j = plain_gen_chain(tsources, tstream, d, taps), plain_gen_chain(jsources, jstream, d, taps)
    offs = np.arange(0, t.length - width, stride, dtype=np.int64)
    got = runtime.stream_batches(t, offs, width)
    want = j_window_batches(offs, width, root_step=j_root_step_of(j))
    assert runtime.root_read_of(t, width) == width * d + taps and runtime.root_step_of(t) == j_root_step_of(j) == 1
    assert want[0] * runtime.root_read_of(t, width) <= CAP  # the cap does not bind
    assert got[0] == want[0] and len(got[1]) == len(want[1])
    assert all(np.array_equal(a, b) for a, b in zip(got[1], want[1]))


# ------------------------------------------------------ outputs unchanged


SCALE = {"cs8": 1.0, "cu8": 128.0, "gen": 1.0}


def capture(fmt: str, n: int, seed: int = 5) -> np.ndarray:
    """``n`` seeded samples: noise with a DC offset and a slow swell."""
    rng = np.random.default_rng(seed)
    swell = 0.2 + np.abs(np.sin(np.arange(n) * 3e-3))
    x = (rng.normal(size=n) + 1j * rng.normal(size=n)) * swell + (0.3 - 0.2j)
    iq = np.stack([x.real, x.imag], axis=-1) * 40
    if fmt == "cs8":
        return np.clip(np.rint(iq), -127, 127).astype(np.int8).view(np.uint8).reshape(-1)
    return np.clip(np.rint(iq + 127.5), 0, 255).astype(np.uint8).reshape(-1)


def stage_chains(fmt: str, n: int, decimate: bool = True):
    """(port chain, JAX chain): ``shift 5k [lowpass -decimate 4 6k]
    dcblock -window 500 agc -window 100`` over the same bytes, or over
    ``gen -cos 3k -cos -7k -noise 0.2 -seed 7 48k`` of ``n`` samples for
    ``fmt`` "gen"."""
    out = []
    for pkg_sources, pkg_stream, pkg_formats in ((tsources, tstream, tformats), (jsources, jstream, jformats)):
        if fmt == "gen":
            s = pkg_sources.ToneGen([3_000, -7_000], 48_000, n / 48_000, noise=0.2, seed=7)
        else:
            s = pkg_sources.SampleSource(capture(fmt, n), pkg_formats.FileFormat(fmt), 48_000)
        s = pkg_stream.Shift(s, 5_000)
        if decimate:
            s = pkg_stream.LowPass(s, 6_000, 4, 40)
        out.append(pkg_stream.Agc(pkg_stream.DcBlock(s, 500), window=100))
    return out


def capped_run(monkeypatch, module, call, windows_a_batch: int):
    """``call()`` with ``module``'s batches capped to ``windows_a_batch``
    windows through :func:`window_batches`' ``gather_cap``; returns its
    result and the number of batches it ran."""
    seen = []

    def capped(stream, offsets, width, **kw):
        cap = windows_a_batch * runtime.root_read_of(stream, width)
        batch, batches = runtime.stream_batches(stream, offsets, width, gather_cap=cap, **kw)
        seen.append(len(batches))
        return batch, batches

    with monkeypatch.context() as m:
        m.setattr(module, "stream_batches", capped)
        return call(), seen[0]


@pytest.mark.parametrize("fmt", ["cs8", "cu8", "gen"])
def test_sparkfft_rows_capped(fmt, monkeypatch):
    t, j = stage_chains(fmt, 12_000)

    def run():
        return tsinks.spark_fft(t, 32, 64, device=CPU)

    capped, n_batches = capped_run(monkeypatch, tsinks, run, 5)
    assert n_batches >= 9
    assert capped == run()
    assert capped == jsinks.spark_fft(j, 32, 64) and len(capped) > 40


@pytest.mark.parametrize("fmt", ["cs8", "cu8", "gen"])
def test_bucket_digits_capped(fmt, monkeypatch):
    t, j = stage_chains(fmt, 12_000)

    def run():
        return tsinks.freq_levels(t, 16, 64, device=CPU).vals

    capped, n_batches = capped_run(monkeypatch, tsinks, run, 4)
    assert n_batches >= 10
    assert capped == run()
    assert capped == jsinks.freq_levels(j, 16, 64).vals and len(capped) > 40


@pytest.mark.parametrize("fmt", ["cs8", "cu8"])
def test_write_samples_capped(fmt, monkeypatch, tmp_path):
    t, j = stage_chains(fmt, 40_000, decimate=False)
    capped_path, n_batches = capped_run(
        monkeypatch, tsinks, lambda: tsinks.do_write(t, False, "capped", directory=str(tmp_path), device=CPU), 1)
    assert n_batches == 10
    plain = tsinks.do_write(t, False, "plain", directory=str(tmp_path), device=CPU)
    assert pathlib.Path(capped_path).read_bytes() == pathlib.Path(plain).read_bytes()
    got = np.fromfile(capped_path, np.complex64)
    want = np.fromfile(jsinks.do_write(j, False, "j", directory=str(tmp_path)), np.complex64)
    assert got.shape == want.shape == (40_000,)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * SCALE[fmt] * np.abs(want).max())


@pytest.mark.parametrize("fmt", ["cs8", "cu8", "gen"])
def test_take_fft_norms_capped(fmt, monkeypatch):
    t, j = stage_chains(fmt, 12_000)

    def run():
        return tsinks.take_fft(t, None, 64, 40, device=CPU).norms

    capped, n_batches = capped_run(monkeypatch, tsinks, run, 3)
    assert n_batches == 14
    np.testing.assert_array_equal(capped, run())
    want = jsinks.take_fft(j, None, 64, 40).norms
    assert capped.shape == want.shape
    np.testing.assert_allclose(capped, want, rtol=1e-4, atol=1e-4 * SCALE[fmt] * np.abs(want).max())


# ------------------------------------------------------------------ helpers


def raw_bytes(fmt: str, n_bytes: int, seed: int = 3) -> bytes:
    """``n_bytes`` seeded bytes; cf32's are finite floats but for a NaN
    with a payload and an infinity."""
    rng = np.random.default_rng(seed)
    if fmt != "cf32":
        return rng.integers(0, 256, n_bytes, dtype=np.int64).astype(np.uint8).tobytes()
    vals = rng.normal(size=-(-n_bytes // 4)).astype(np.float32)
    vals[3:5] = np.array([0x7FC01234, 0x7F800000], dtype=np.uint32).view(np.float32)
    return vals.tobytes()[:n_bytes]


@pytest.mark.parametrize("partial", ["none", "one byte", "all but one byte"])
@pytest.mark.parametrize("fmt", FORMATS)
def test_decode_bytes_bitwise(fmt, partial):
    """Trailing partial pairs are truncated; bytes and numpy buffers."""
    pair = tformats.FileFormat(fmt).pair_bytes
    buf = raw_bytes(fmt, 100 * pair + {"none": 0, "one byte": 1, "all but one byte": pair - 1}[partial])
    want = jformats.decode_bytes(buf, jformats.FileFormat(fmt))
    for arg in (buf, np.frombuffer(buf, dtype=np.uint8)):
        got = tformats.decode_bytes(arg, tformats.FileFormat(fmt))
        assert got.dtype == np.complex64 and got.shape == want.shape == (100,)
        assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("fmt", FORMATS)
def test_decode_to_complex64_bitwise(fmt):
    """numpy arrays and torch tensors of any leading shape."""
    f = tformats.FileFormat(fmt)
    raw = np.frombuffer(raw_bytes(fmt, 2 * 3 * 50 * f.pair_bytes), dtype=f.raw_dtype).reshape(2, 3, 100)
    want = jformats.decode_to_complex64(raw, jformats.FileFormat(fmt), xp=np)
    got = tformats.decode_to_complex64(raw, f)
    assert got.dtype == np.complex64 and got.shape == want.shape == (2, 3, 50)
    assert got.tobytes() == want.tobytes()
    got_t = tformats.decode_to_complex64(torch.from_numpy(raw.copy()), f)
    assert got_t.dtype == torch.complex64 and got_t.numpy().tobytes() == want.tobytes()


@pytest.mark.parametrize("n", [0, 1, 4801])
def test_read_wav_f32_round_trip(n, tmp_path):
    samples = np.random.default_rng(n).normal(size=n).astype(np.float32)
    path = twav.write_wav(str(tmp_path / "a.wav"), 48_000, samples)
    rate, got = twav.read_wav_f32(path)
    j_rate, want = jwav.read_wav_f32(path)
    assert rate == j_rate == 48_000 and got.dtype == want.dtype
    assert got.tobytes() == want.tobytes() == samples.tobytes()


def test_read_wav_f32_refuses_what_jax_refuses(tmp_path):
    path = tmp_path / "bad.wav"
    for data in (b"RIFX" + bytes(8), twav.wav_bytes(8000, np.zeros(4, np.float32)).replace(b"\x03\x00\x01\x00", b"\x01\x00\x01\x00", 1)):
        path.write_bytes(data)
        with pytest.raises(ValueError) as err:
            twav.read_wav_f32(str(path))
        with pytest.raises(ValueError) as j_err:
            jwav.read_wav_f32(str(path))
        assert str(err.value) == str(j_err.value)
