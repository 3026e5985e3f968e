"""The JAX package's two conformance sweeps, run through the port:
``tests/test_fuzz_conformance.py``'s 32 seeds (random shift/lowpass
chains and pulls, random ``ToneGen``, ``sparkfft`` and ``bucket``
parameters) against ``tests/oracle.py`` and against quadrs_tpu on the
same draws, and ``tests/test_error_surface.py``'s argv lines (the lines
the reference rejects, the lines it accepts, the two pinned
divergences), which the port's parser must reject or accept as
quadjax's does, with the same message or the same commands.

The seeds and argv lists are imported from those files, and the random
chains are built by their own ``_random_chain`` over the port's classes;
each seed and each argv line is a case of its own.  Bounds are the JAX
sweep's: chain samples within ``5e-5`` of scale of the oracle's (and of
quadrs_tpu's), tones within ``1e-6`` a tone, at most 0.1% of the glyphs
and 0.2% of the bucket digits apart."""

import dataclasses
import types

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import test_error_surface as jerr  # noqa: E402
import test_fuzz_conformance as jfuzz  # noqa: E402
from oracle import OracleArray, OracleGen, oracle_freq_levels, oracle_spark_fft  # noqa: E402
from quadrs_tpu import args as jargs  # noqa: E402
from quadrs_tpu import sinks as jsinks  # noqa: E402
from quadrs_tpu import sources as jsources  # noqa: E402

from quadrs_tpu_torch import args as targs  # noqa: E402
from quadrs_tpu_torch import sinks as tsinks  # noqa: E402
from quadrs_tpu_torch import sources as tsources  # noqa: E402
from quadrs_tpu_torch import stream as tstream  # noqa: E402
from quadrs_tpu_torch.formats import FileFormat  # noqa: E402

CPU = "cpu"


def seeds(test) -> list[int]:
    """The seeds a JAX sweep test is parametrized over."""
    (mark,) = [m for m in test.pytestmark if m.name == "parametrize"]
    return list(mark.args[1])


# the JAX sweep's own ``_random_chain``, over the port's classes
_port_chain = types.FunctionType(
    jfuzz._random_chain.__code__,
    {**jfuzz.__dict__, "SampleSource": tsources.SampleSource, "Shift": tstream.Shift,
     "LowPass": tstream.LowPass, "FileFormat": FileFormat},
)


@pytest.mark.parametrize("seed", seeds(jfuzz.test_random_pipeline_matches_oracle))
def test_random_pipeline_matches_oracle(seed):
    rng = np.random.default_rng(1000 + seed)
    n = int(rng.integers(4000, 20000))
    sr = int(rng.choice([8_000, 44_100, 96_000, 1_000_000]))
    state = rng.bit_generator.state
    stream, oracle = _port_chain(rng, n, sr)
    rng.bit_generator.state = state
    jstream, _ = jfuzz._random_chain(rng, n, sr)
    for _ in range(3):
        off = int(rng.integers(0, max(1, stream.length - 16)))
        count = int(rng.integers(8, 200))
        got, valid = stream.read_at(off, count, CPU)
        jgot, jvalid = jstream.read_at(off, count)
        assert valid == jvalid, (off, count)
        try:
            want = oracle.read_at(off, count)
        except RuntimeError:
            continue  # the oracle would panic (reference behaviour): skip the pull
        assert valid == len(want), (off, count)
        if valid:
            scale = max(np.abs(want).max(), 1e-3)
            np.testing.assert_allclose(got[:valid], want, atol=5e-5 * scale, err_msg=f"off={off} n={count}")
            np.testing.assert_allclose(got[:valid], jgot[:valid], atol=5e-5 * scale, err_msg=f"off={off} n={count}")


@pytest.mark.parametrize("seed", seeds(jfuzz.test_random_gen_pipeline_matches_oracle))
def test_random_gen_pipeline_matches_oracle(seed):
    rng = np.random.default_rng(2000 + seed)
    sr = int(rng.choice([400, 4_000, 48_000]))
    tones = [int(rng.integers(-(sr // 2) + 1, sr // 2)) for _ in range(rng.integers(1, 4))]
    secs = float(rng.uniform(0.2, 1.5))
    stream = tsources.ToneGen(tones, sr, secs)
    jstream = jsources.ToneGen(tones, sr, secs)
    oracle = OracleGen(tones, sr, secs)
    for _ in range(3):
        off = int(rng.integers(0, max(1, stream.length)))
        count = int(rng.integers(8, 300))
        got, valid = stream.read_at(off, count, CPU)
        assert valid == count
        np.testing.assert_allclose(got, oracle.read_at(off, count), atol=len(tones) * 1e-6)
        np.testing.assert_allclose(got, jstream.read_at(off, count)[0], atol=len(tones) * 1e-6)


def _sources(data: np.ndarray, sr: int):
    raw = np.ascontiguousarray(data).view(np.uint8)
    return (tsources.SampleSource(raw, FileFormat.COMPLEX_FLOAT32, sr),
            jsources.SampleSource(raw, jsources.FileFormat.COMPLEX_FLOAT32, sr), OracleArray(data, sr))


@pytest.mark.parametrize("seed", seeds(jfuzz.test_random_sparkfft_params_match_oracle))
def test_random_sparkfft_params_match_oracle(seed):
    rng = np.random.default_rng(3000 + seed)
    n = int(rng.integers(1500, 8000))
    sr = int(rng.choice([400, 48_000]))
    data = (0.3 * (rng.normal(size=n) + 1j * rng.normal(size=n))).astype(np.complex64)
    stream, jstream, oracle = _sources(data, sr)
    width = int(rng.choice([4, 8, 16, 64, 128]))
    stride = int(rng.integers(1, 3 * width))
    lo = float(rng.uniform(0.01, 0.3))
    hi = lo + float(rng.uniform(0.5, 2.0))
    got = [r.strip("│") for r in tsinks.spark_fft(stream, width, stride, lo, hi, device=CPU)[1:]]
    for want in (oracle_spark_fft(oracle, width, stride, lo, hi),
                 [r.strip("│") for r in jsinks.spark_fft(jstream, width, stride, lo, hi)[1:]]):
        assert len(got) == len(want), (width, stride)
        mism = sum(sum(a != b for a, b in zip(ra, rb)) for ra, rb in zip(got, want))
        total = max(1, sum(len(r) for r in want))
        assert mism <= total * 0.001, f"{mism}/{total} glyphs (w={width}, s={stride})"


@pytest.mark.parametrize("seed", seeds(jfuzz.test_random_bucket_params_match_oracle))
def test_random_bucket_params_match_oracle(seed):
    rng = np.random.default_rng(4000 + seed)
    n = int(rng.integers(2000, 9000))
    data = (rng.normal(size=n) + 1j * rng.normal(size=n)).astype(np.complex64)
    stream, jstream, oracle = _sources(data, 48_000)
    width = int(rng.choice([8, 32, 64, 256]))
    stride = int(rng.integers(1, 2 * width))
    got = tsinks.freq_levels(stream, width, stride, device=CPU).vals
    for want in (oracle_freq_levels(oracle, width, stride), jsinks.freq_levels(jstream, width, stride).vals):
        assert len(got) == len(want)
        diffs = sum(a != b for a, b in zip(got, want))
        assert diffs <= max(1, len(want) // 500), (width, stride, diffs)


# -- the error surface -----------------------------------------------------------


@pytest.mark.parametrize("argv", [r[0] for r in jerr.REJECTED], ids=[" ".join(r[0]) or "<empty>" for r in jerr.REJECTED])
def test_reference_rejections_also_rejected(argv):
    with pytest.raises(ValueError) as want:
        jargs.parse(argv)
    with pytest.raises(ValueError) as got:
        targs.parse(argv)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("argv", jerr.ACCEPTED, ids=[" ".join(a) for a in jerr.ACCEPTED])
def test_reference_accepted_lines_parse(argv):
    got, want = targs.parse(argv), jargs.parse(argv)
    assert [type(c).__name__ for c in got] == [type(c).__name__ for c in want]
    assert [dataclasses.asdict(c) for c in got] == [dataclasses.asdict(c) for c in want]


def test_divergence_ui_accepts_render_knobs():
    """The first pinned divergence (PARITY.md): ui takes the render knobs
    as flags and rejects every other."""
    (cmd,) = targs.parse(["ui", "-fft", "16", "-stretch", "2", "-stride", "8", "-frames", "3"])
    assert cmd == targs.Ui(fft_width=16, stretch=2, stride=8, frames=3)
    assert dataclasses.asdict(cmd) == dataclasses.asdict(jargs.parse(["ui", "-fft", "16", "-stretch", "2", "-stride",
                                                                      "8", "-frames", "3"])[0])
    with pytest.raises(ValueError):
        targs.parse(["ui", "-width", "16"])


def test_divergence_eui_interprets_slider_flags():
    """The second (PARITY.md): eui reads -start/-end/-fft/-frames and
    drops any other flag silently."""
    (cmd,) = targs.parse(["eui", "-start", "10", "-end", "20", "-fft", "1024", "f.cf32"])
    assert isinstance(cmd, targs.Eui)
    assert (cmd.start_pct, cmd.end_pct, cmd.fft_width) == (10.0, 20.0, 1024)
    (dropped,) = targs.parse(["eui", "-whatever", "1"])
    assert dropped == targs.Eui(filename=None)
    assert dataclasses.asdict(dropped) == dataclasses.asdict(jargs.parse(["eui", "-whatever", "1"])[0])
