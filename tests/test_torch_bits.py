"""``quadrs_tpu_torch.bits`` (clock recovery of OOK pulse trains) against
``quadrs_tpu.bits``: bit for bit, the clock error to the last bit of the
f64, on the reference's cases, random jittered streams with glitches, a
stream that opens high and ``_rust_round`` at halves."""

import numpy as np
import pytest

from quadrs_tpu import bits as jbits

from quadrs_tpu_torch import bits as tbits


def parse(s: str) -> list[bool]:
    return [c == "1" for c in s if c in "01"]


@pytest.mark.parametrize(
    "data,scale,val",
    [("0000", 2, False), ("00001000111", 2, False), ("111100", 1, True), ("1", 2, False), ("", 2, False),
     ("0010", 0, False), ("0110110001", 2, True)],
)
def test_run_of(data, scale, val):
    assert tbits.run_of(parse(data), scale, val) == jbits.run_of(parse(data), scale, val)
    arr = np.asarray(parse(data), dtype=bool)
    assert tbits._run_of_fast(arr, 0, scale, val) == jbits._run_of_fast(arr, 0, scale, val)


def random_stream(rng, scale: float, n_bits: int, flips: int, start_high: bool) -> np.ndarray:
    samples, val = [], start_high
    for _ in range(n_bits):
        samples.extend([val] * (int(scale) + int(rng.integers(-1, 2))))
        val = not val
    noisy = np.array(samples)
    at = rng.integers(0, len(noisy), flips)
    noisy[at] = ~noisy[at]
    return noisy


@pytest.mark.parametrize("scale", [3.0, 4.0, 7.5, 8.0, 16.0])
@pytest.mark.parametrize("start_high", [False, True])
def test_scan_bitwise(scale, start_high):
    rng = np.random.default_rng(int(scale * 10) + start_high)
    for _ in range(4):
        data = random_stream(rng, scale, 60, 8, start_high)
        assert tbits.scan(data, scale) == jbits.scan(data, scale)
        assert tbits.scan(list(data), scale) == jbits.scan(list(data), scale)


def test_scan_opening_high_and_flip_flop():
    for data in ("1111111111111111" "00000000" "11111111", "10" * 40, "1" * 50, "0" * 3):
        got = tbits.scan(parse(data), 8.0)
        assert got == jbits.scan(parse(data), 8.0)
    assert tbits.scan(parse("1111111111111111" "00000000" "11111111"), 8.0)[1] == [True, True, False, True]


@pytest.mark.parametrize("x", [-2.5, -1.5, -0.5, 0.0, 0.5, 1.5, 2.5, 3.49999, 1e15 + 0.5, -7.0])
def test_rust_round_half_away_from_zero(x):
    assert tbits._rust_round(x) == jbits._rust_round(x)
    assert abs(tbits._rust_round(x)) == np.floor(abs(x) + 0.5)


@pytest.mark.parametrize("scale", [0.4, 7.0, 250.0])
def test_long_runs_past_the_search_blocks(scale):
    """Runs and contrary bursts far longer than ``_run_of_fast``'s first
    search block (4096 samples, each block twice the last), bursts
    straddling block edges and glitches one short of a burst: the same runs
    and bits as the JAX package's whole-rest search."""
    rng = np.random.default_rng(int(scale * 10))
    samples, val = [], False
    for _ in range(60):
        samples.extend([val] * int(rng.integers(1, 20_000)))
        val = not val
    data = np.array(samples)
    half = int(tbits._rust_round(scale / 2.0))
    at = rng.integers(0, len(data) - half, 40)
    for a in at:  # glitches of half samples: not a burst (more than half are)
        data[a : a + half] = ~data[a]
    for start in rng.integers(0, len(data), 30):
        for v in (False, True):
            assert tbits._run_of_fast(data, int(start), half, v) == jbits._run_of_fast(data, int(start), half, v)
    assert tbits.scan(data, scale) == jbits.scan(data, scale)
