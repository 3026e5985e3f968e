"""The port's decimating FIR (``quadrs_tpu_torch.ops.fir``) against
quadrs_tpu's, implementation by implementation, on the CPU.

Inputs are made with numpy from a seed and handed to both.  Tolerances
are ``tests/test_filter.py``'s: ``1e-5`` for the time-domain impls and
``3e-5 * scale`` for the spectral ones (their FFTs round differently
from a direct sum; the JAX package's are its MXU factorization, the
port's ``torch.fft``)."""

import jax
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from quadrs_tpu.ops import fir as jfir  # noqa: E402
from util import from_device_complex, to_device_complex  # noqa: E402

from quadrs_tpu_torch.ops import fir as tfir  # noqa: E402

SPECTRAL = ("overlap_save", "os_poly")


def jax_fir(x, taps, d, n_out, impl):
    fn = jax.jit(lambda xx: jfir.fir_decimate(xx, taps, d, n_out, impl=impl))
    return from_device_complex(fn(to_device_complex(x)))


def blocks(rng, b, n_in, valid=None):
    x = (rng.normal(size=(b, n_in)) + 1j * rng.normal(size=(b, n_in))).astype(np.complex64)
    if valid is not None:  # each block zeroed past its valid extent
        for row, v in enumerate(valid):
            x[row, v:] = 0
    return x


def taps_of(kind, size, cutoff, d):
    h = jfir.lowpass_taps(cutoff, size)
    if kind == "real":
        return h
    # a band-pass filter: the receiver's premixed taps
    return (h.astype(np.float64) * np.exp(2j * np.pi * 0.13 * np.arange(size))).astype(np.complex64)


# (d, size, n_out): a polyphase-class filter and a long (4000-tap) one
SHAPES = [(8, 96, 200), (32, 4000, 40)]


@pytest.mark.parametrize("kind", ["real", "complex"])
@pytest.mark.parametrize("impl", tfir.IMPLS)
@pytest.mark.parametrize("d,size,n_out", SHAPES)
def test_impl_matches_jax(impl, kind, d, size, n_out):
    rng = np.random.default_rng(size + len(impl) + len(kind))
    n_in = n_out * d + size
    x = blocks(rng, 3, n_in, valid=[n_in, n_in - 7 * d - 3, n_in // 2])
    taps = taps_of(kind, size, 0.02 if size > 100 else 0.05, d)
    want = jax_fir(x, taps, d, n_out, impl)
    got = tfir.fir_decimate(torch.from_numpy(x), taps, d, n_out, impl=impl)
    assert got.dtype == torch.complex64 and tuple(got.shape) == (3, n_out)
    atol = 3e-5 * max(np.abs(want).max(), 1.0) if impl in SPECTRAL else 1e-5
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=atol)


def test_short_blocks_and_odd_sizes():
    """Blocks shorter than ``n_out*d + size`` count as zero-padded; odd
    tap counts drop a ``ceil(size/2)`` group-delay prefix."""
    rng = np.random.default_rng(3)
    for d, size, n_out in [(3, 77, 65), (1, 5, 300), (16, 41, 129)]:
        x = blocks(rng, 2, n_out * d + size - 2 * d - 1)
        taps = jfir.lowpass_taps(0.07, size)
        for impl in tfir.IMPLS:
            want = jax_fir(x, taps, d, n_out, impl)
            got = tfir.fir_decimate(torch.from_numpy(x), taps, d, n_out, impl=impl).numpy()
            atol = 3e-5 * max(np.abs(want).max(), 1.0) if impl in SPECTRAL else 1e-5
            np.testing.assert_allclose(got, want, rtol=0, atol=atol, err_msg=f"{impl} d={d} size={size}")


# tests/test_filter.py::test_fir_auto_crossover_boundaries: (d, size, n_out, batch, the impl auto takes)
CROSSOVERS = [
    (8, 512, 64, 1, "polyphase"),
    (8, 528, 64, 1, "os_poly"),
    (8, 32, 1 << 17, 1, "banded"),
    (8, 32, (1 << 17) - 1, 1, "polyphase"),
    (4, 32, 1 << 13, 16, "banded"),
    (4, 32, 1 << 13, 15, "polyphase"),
    (2, 40, 128, 1, "direct"),
]


@pytest.mark.parametrize("d,size,n_out,batch,impl", CROSSOVERS)
def test_auto_takes_the_jax_packages_impl(d, size, n_out, batch, impl):
    """On the CPU ``auto`` resolves as the JAX package's does at each
    crossover, and its output is that impl's, bit for bit."""
    assert tfir.auto_impl(size, d, batch * n_out) == impl
    assert tfir.is_spectral(size, d) == jfir.is_spectral(size, d)
    if batch * n_out > 4096:
        return  # the big crossovers: the rule is enough, their FIRs are slow here
    rng = np.random.default_rng(d + size)
    x = torch.from_numpy(blocks(rng, batch, n_out * d + size))
    taps = jfir.lowpass_taps(0.02, size)
    got = tfir.fir_decimate(x, taps, d, n_out)
    assert torch.equal(got, tfir.fir_decimate(x, taps, d, n_out, impl=impl))
    want = jax_fir(x.numpy(), taps, d, n_out, "auto")
    np.testing.assert_allclose(want, jax_fir(x.numpy(), taps, d, n_out, impl), rtol=0, atol=1e-7)


# the card's rule (ops.fir._auto_impl_cuda, from chip_smoke.py's sweep): (size, d, n_out, batch, impl)
CUDA_RULE = [
    (400, 32, 64, 16384, "polyphase"),  # the sparkfft batch: the CPU rule takes banded there
    (400, 32, 4096, 256, "polyphase"),
    (400, 100, 40_000, 1, "polyphase"),
    (96, 8, 64, 16384, "polyphase"),
    (512, 8, 64, 1, "polyphase"),  # 64 subfilters: the last time-domain size
    (40, 4, 1_000_000, 1, "overlap_save"),  # below D 8
    (40, 2, 4096, 256, "overlap_save"),
    (5, 1, 300, 2, "overlap_save"),
    (528, 8, 64, 1, "os_poly"),  # 66 subfilters, a block shorter than overlap-save's frame
    (4000, 32, 64, 16384, "os_poly"),
    (4000, 32, 386, 1, "os_poly"),  # 386 * 32 + 4000 = 16352: one short of the 16384 frame
    (4000, 32, 387, 1, "overlap_save"),
    (4000, 32, 4096, 256, "overlap_save"),
    (1100, 8, 500_000, 1, "overlap_save"),
    (8192, 100, 40_000, 1, "overlap_save"),
]


@pytest.mark.parametrize("size,d,n_out,batch,impl", CUDA_RULE)
def test_auto_takes_the_cards_impl_on_cuda(size, d, n_out, batch, impl):
    """On a CUDA device ``auto`` follows the card's own rule; the side of
    ``is_spectral`` (the receiver's premixed taps hang on it) is the JAX
    package's on every device; the CPU's rule is untouched; and the impl
    the card takes computes the JAX package's ``auto`` result."""
    assert tfir.auto_impl(size, d, batch * n_out, "cuda", n_out) == impl
    assert tfir.is_spectral(size, d) == jfir.is_spectral(size, d)
    if tfir.is_spectral(size, d):
        assert impl in SPECTRAL and tfir.auto_impl(size, d, batch * n_out) in SPECTRAL
    assert tfir.auto_impl(size, d, batch * n_out, "cpu", n_out) == tfir.auto_impl(size, d, batch * n_out)
    if batch * n_out * (d + size // 64) > 1 << 16:
        return  # the big shapes: the rule is enough, their FIRs are slow here
    rng = np.random.default_rng(d + size)
    x = blocks(rng, batch, n_out * d + size)
    taps = taps_of("complex" if tfir.is_spectral(size, d) else "real", size, 0.02, d)
    got = tfir.fir_decimate(torch.from_numpy(x), taps, d, n_out, impl=impl).numpy()
    want = jax_fir(x, taps, d, n_out, "auto")
    np.testing.assert_allclose(got, want, rtol=0, atol=3e-5 * max(np.abs(want).max(), 1.0))


def test_complex_taps_split_after_auto():
    """Complex taps through a time-domain impl are two real passes: the
    imaginary part is kept (the JAX package splits after auto resolves)."""
    rng = np.random.default_rng(9)
    x = blocks(rng, 2, 64 * 8 + 96)
    taps = taps_of("complex", 96, 0.05, 8)
    got = tfir.fir_decimate(torch.from_numpy(x), taps, 8, 64)  # auto: polyphase
    want = jax_fir(x, taps, 8, 64, "auto")
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    real_only = tfir.fir_decimate(torch.from_numpy(x), taps.real.copy(), 8, 64)
    assert float((got - real_only).abs().max()) > 0.1


def test_banded_weights_bitwise():
    for d, size in [(8, 96), (32, 400), (1, 40), (64, 77)]:
        key = jfir.lowpass_taps(0.05, size).tobytes()
        assert tfir.banded_weights(key, d).tobytes() == jfir._banded_weights(key, d).tobytes()


def test_unknown_impl_raises():
    with pytest.raises(ValueError, match="unknown fir impl"):
        tfir.fir_decimate(torch.zeros((1, 100), dtype=torch.complex64), np.ones(4, np.float32), 2, 10, impl="fft")
