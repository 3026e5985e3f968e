"""FIR low-pass taps and the decimating convolution.

Tap math mirrors the reference exactly in f32 (``src/filter.rs:86-105``):
Blackman-windowed sinc, normalized to unit sum.  The decimating
convolution evaluates the reference's indexing

    y[i] = sum_{j=0}^{N-1} x[i*D + ceil(N/2) + j] * h[j]

(``convoluted[N + i*D]`` of ``src/filter.rs:78-80`` expressed directly).
Out-of-block taps contribute zero: callers pre-mask the block at its
valid extent, matching ``complex_convolve``'s bounds-skip
(``src/filter.rs:116``).

The counterpart of ``quadrs_tpu.ops.fir``, in plain torch ops (cuBLAS
and cuFFT on the card), with its five implementations:

* ``direct``: overlapping frames, one ``(B*n_out, N) @ (N,)`` product
  per real plane;
* ``polyphase``: ``M = ceil(N/D)`` phase subfilters, one ``(..., D) @
  (D, M)`` product, then ``M`` shifted adds;
* ``banded``: 128 outputs per row of one dense banded product;
* ``overlap_save``: blockwise FFT correlation at the full rate;
* ``os_poly``: polyphase overlap-save, every FFT at the decimated rate
  (on ``torch.fft``: the JAX package's MXU factorization of these FFTs is
  a TPU layout and is not ported).

Every impl's taps, matrix or tap spectrum is a table kept on the device
(:func:`~quadrs_tpu_torch.ops.tables.device_table`, keyed by the taps'
bytes and the impl's shape), uploaded on a filter's first call only.

The frame sizes and the ``auto`` thresholds are the JAX package's, which
were measured on a TPU v5e; they change outputs only by rounding, and
keeping them keeps the parity tests tight.  Matrix products run in full
f32: ``torch.backends.cuda.matmul.allow_tf32`` must stay False (the CLI
sets it so), and nothing here uses ``conv1d``, which cuDNN would run in
TF32 by default.
"""

from __future__ import annotations

import numpy as np
import torch

from quadrs_tpu_torch.ops.nco import rotate
from quadrs_tpu_torch.ops.tables import device_table

_PI32 = np.float32(np.pi)

IMPLS = ("direct", "polyphase", "banded", "overlap_save", "os_poly")
_SPECTRAL = ("overlap_save", "os_poly")

# rows of every transform call on the CPU: its FFT splits a lone transform
# across threads and rounds it otherwise than the same transform inside a
# batch, but a call of this many rows rounds each row alike at any batch
# and thread count
FFT_ROWS = 8


def fixed_row_calls(fn, x: torch.Tensor, lead: int) -> torch.Tensor:
    """``fn`` over the rows of ``x`` (its first ``lead`` dims are rows, each
    row what is left; ``fn`` takes and returns a stack of rows).  On the
    card one call, which cuFFT plans by batch; on the CPU calls of exactly
    :data:`FFT_ROWS` contiguous rows, the last padded with zero rows that
    are dropped after, so a row's output does not depend on its batch or
    the threads."""
    if x.device.type != "cpu" or x.numel() == 0:
        return fn(x)
    shape = x.shape[:lead]
    rows = x.reshape(-1, *x.shape[lead:])
    n = rows.shape[0]
    pad = -n % FFT_ROWS
    rows = torch.cat([rows, rows.new_zeros((pad, *rows.shape[1:]))]) if pad else rows.contiguous()
    out = torch.cat([fn(rows[i : i + FFT_ROWS]) for i in range(0, n + pad, FFT_ROWS)])
    return out[:n].reshape(*shape, *out.shape[1:])


def spectral_product(xf: torch.Tensor, hf: torch.Tensor) -> torch.Tensor:
    """``xf * hf``: the complex product on the card; on the CPU
    :func:`~quadrs_tpu_torch.ops.nco.rotate`'s real planes, which round
    each element alone (the CPU's complex product rounds its vector lanes
    and its scalar tail apart, and its threads split the batch anywhere)."""
    return xf * hf if xf.is_cuda else rotate(xf, hf.real, hf.imag)


def overlapped_frames(x: torch.Tensor, hop: int, m: int, n_frames: int) -> torch.Tensor:
    """(..., L) -> (..., n_frames, m) frames at stride ``hop``, a view
    through ``Tensor.unfold`` where ``x`` is long enough.  Like the JAX
    package's ``_overlapped_frames``, ``x`` is first zero-padded to
    ``(n_frames + ceil(m / hop) - 1) * hop`` samples: a skipping stride
    (``hop > m``) needs that pad for its last frame's row."""
    need = (n_frames + -(-m // hop) - 1) * hop
    if x.shape[-1] < need:
        x = torch.nn.functional.pad(x, (0, need - x.shape[-1]))
    return x[..., :need].unfold(-1, m, hop)[..., :n_frames, :]


def lowpass_taps(cutoff: float, size: int) -> np.ndarray:
    """Blackman-windowed sinc taps, f32, unit-sum normalized.

    ``cutoff`` is frequency / sample_rate (``src/filter.rs:126-128``);
    formulas and op order follow ``src/filter.rs:86-105`` in f32.

    Odd sizes diverge deliberately: the reference's ``sin(0)/0`` center
    tap is NaN there (its CLI only produces even sizes, 2*power or 40),
    while this defines sinc(0)=1 so odd sizes are usable.
    """
    if size < 2:
        raise ValueError("filter size must be at least 2")
    c = np.float32(cutoff)
    i = np.arange(size, dtype=np.float32)
    sz = np.float32(size)

    x = np.float32(2.0) * c * (i - (sz - np.float32(1.0)) / np.float32(2.0))
    xpi = x * _PI32
    safe = np.where(xpi == 0, np.float32(1.0), xpi)  # avoid a 0/0 warning
    sinc = np.where(xpi == 0, np.float32(1.0), np.sin(safe) / safe)

    t = np.float32(2.0) * _PI32 * i / (sz - np.float32(1.0))
    window = (
        np.float32(0.42)
        - np.float32(0.5) * np.cos(t)
        + np.float32(0.08) * np.cos(np.float32(2.0) * t)
    )

    taps = (sinc * window).astype(np.float32)
    return (taps / taps.sum(dtype=np.float32)).astype(np.float32)


def is_spectral(size: int, d: int) -> bool:
    """True when ``auto`` routes a (taps, decimate) pair to a
    frequency-domain impl: more than 64 polyphase subfilters.  The
    receiver premixes the NCO into complex taps exactly when this holds."""
    return -(-size // d) > 64


def auto_impl(size: int, d: int, total_out: int, device_type: str = "cpu", n_out: int | None = None) -> str:
    """The impl ``auto`` takes for ``size`` taps at decimation ``d`` and
    ``total_out`` outputs over the batch (``n_out`` a block), on a device
    of ``device_type``.

    The CPU keeps the JAX package's rule (measured on a TPU v5e; the CPU
    parity tests are pinned to it).  CUDA has its own.  Which side of
    :func:`is_spectral` a filter falls on is the same on every device: the
    receiver's premixed taps hang on it."""
    if device_type == "cuda":
        return _auto_impl_cuda(size, d, total_out if n_out is None else n_out)
    if is_spectral(size, d):
        return "os_poly"
    if d >= 4:
        return "banded" if total_out >= (1 << 17) else "polyphase"
    return "direct"


def _auto_impl_cuda(size: int, d: int, n_out: int) -> str:
    """The CUDA rule, from the sweep of ``chip_smoke.py`` phase 5 on an
    NVIDIA H100 80GB HBM3 at 700.00 W (ms; the fastest of the five first):

    - past 64 subfilters, a block that fills overlap-save's frame takes
      ``overlap_save`` (256 x 135072 samples, D 32, 4000 taps: 2.008 against
      os_poly 3.866; one 4M-sample row, D 100, 8192 taps: 1.049 against
      4.056), a shorter block ``os_poly`` (16384 x 6048, D 32, 4000 taps:
      4.705 against overlap_save 8.533);
    - up to 64 subfilters, ``polyphase`` from D 8 on (16384 x 2448, D 32,
      400 taps: 1.757 against os_poly 2.517 and banded, the v5e's choice,
      10.520; one 4M-sample row, D 100: 0.189), and ``overlap_save`` below
      (one 4M-sample row, D 4, 40 taps: 0.384 against polyphase 0.600;
      256 x 8232, D 2: 0.348 against banded 0.314 and polyphase 0.981).
    """
    if is_spectral(size, d):
        return "overlap_save" if n_out * d + size >= _overlap_save_frame(size) else "os_poly"
    return "polyphase" if d >= 8 else "overlap_save"


def _overlap_save_frame(size: int) -> int:
    """overlap_save's FFT frame: a power of two past ~4x the filter (the
    JAX package's)."""
    return 1 << max(size * 4 - 1, 4096).bit_length()


def _planes(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` on the real and imaginary planes of complex ``x``, real ``w``."""
    return torch.complex(torch.matmul(x.real, w), torch.matmul(x.imag, w))


def fir_decimate(
    x: torch.Tensor,
    taps: np.ndarray,
    decimate: int,
    n_out: int,
    *,
    impl: str = "auto",
) -> torch.Tensor:
    """Decimating FIR over a batch of blocks.

    ``x``: (B, n_in) complex64 with ``n_in = n_out*decimate + len(taps)``
    (shorter blocks count as zero-padded); entries past each block's
    valid extent must already be zero.  Returns (B, n_out) complex64 on
    ``x``'s device.  ``taps`` may be complex64 (a modulated band-pass
    filter): the spectral impls take it as it is, the time-domain impls
    as two real passes.
    """
    taps = np.asarray(taps)
    if not np.iscomplexobj(taps):
        taps = taps.astype(np.float32)
    size = len(taps)
    d = int(decimate)
    if impl == "auto":
        impl = auto_impl(size, d, int(x.shape[0]) * n_out, x.device.type, n_out)
    if impl not in IMPLS:
        raise ValueError(f"unknown fir impl: {impl}")

    if np.iscomplexobj(taps) and impl not in _SPECTRAL:
        # after auto resolves: a time-domain impl would otherwise drop the
        # imaginary part
        hr = np.ascontiguousarray(taps.real, dtype=np.float32)
        hi = np.ascontiguousarray(taps.imag, dtype=np.float32)
        return fir_decimate(x, hr, d, n_out, impl=impl) + 1j * fir_decimate(x, hi, d, n_out, impl=impl)

    # drop the group-delay prefix ceil(N/2) and cover the last frame
    needed = (n_out - 1) * d + size
    x = x[:, size - size // 2 :]
    if x.shape[1] < needed:
        x = torch.nn.functional.pad(x, (0, needed - x.shape[1]))
    dev = x.device

    if impl == "direct":
        frames = overlapped_frames(x, d, size, n_out)  # (B, n_out, size)
        return _planes(frames, device_table("fir.direct", taps.tobytes(), dev, lambda: taps))

    if impl == "polyphase":
        m = -(-size // d)
        hp = device_table("fir.polyphase", (taps.tobytes(), d), dev, lambda: polyphase_matrix(taps, d))  # (d, m)
        t = -(-x.shape[1] // d)
        if x.shape[1] < t * d:
            x = torch.nn.functional.pad(x, (0, t * d - x.shape[1]))
        c = _planes(x.reshape(x.shape[0], t, d), hp)  # (B, t, m)
        out = c[:, 0:n_out, 0]
        for k in range(1, m):
            out = out + c[:, k : k + n_out, k]
        return out

    if impl == "banded":
        return _banded(x, taps, d, n_out)
    if impl == "overlap_save":
        return _overlap_save(x, taps, d, n_out)
    return _overlap_save_poly(x, taps, d, n_out)


def polyphase_matrix(taps: np.ndarray, d: int) -> np.ndarray:
    """(d, m) f32 matrix of the ``m = ceil(N/d)`` phase subfilters:
    column ``q`` holds taps ``q*d .. q*d + d - 1``, zero past the last."""
    size = len(taps)
    m = -(-size // d)
    h = np.zeros(m * d, dtype=np.float32)
    h[:size] = taps
    return np.ascontiguousarray(h.reshape(m, d).T)


def _complex64(h: np.ndarray) -> np.ndarray:
    """``h`` as complex64, each part rounded to f32 alone."""
    out = np.empty(h.shape, dtype=np.complex64)
    out.real, out.imag = h.real.astype(np.float32), h.imag.astype(np.float32)
    return out


def banded_weights(taps_key: bytes, d: int) -> np.ndarray:
    """(span_p, 128) banded matrix ``W[p, l] = h[p - l*d]``: 128 decimated
    outputs per row of input span.  ``taps_key``: the f32 taps' bytes."""
    taps = np.frombuffer(taps_key, dtype=np.float32)
    size = len(taps)
    span = 127 * d + size
    span_p = -(-span // 128) * 128
    w = np.zeros((span_p, 128), dtype=np.float32)
    for l in range(128):
        w[l * d : l * d + size, l] = taps
    return w


def _banded(x: torch.Tensor, taps: np.ndarray, d: int, n_out: int) -> torch.Tensor:
    """One dense banded product: groups of 128 outputs share one input
    span, ``(B, groups, span) @ (span, 128)``."""
    key = taps.astype(np.float32).tobytes()
    w = device_table("fir.banded", (key, d), x.device, lambda: banded_weights(key, d))
    groups = -(-n_out // 128)
    lhs = overlapped_frames(x, 128 * d, w.shape[0], groups)  # (B, groups, span_p)
    y = _planes(lhs, w)  # (B, groups, 128)
    return y.reshape(x.shape[0], groups * 128)[:, :n_out]


def _correlation_spectrum(h: np.ndarray, n: int, axis: int = -1) -> np.ndarray:
    """``sum_j h[j] e^{+2 pi i j k / n} = conj(FFT(conj(h)))`` in f64: a
    product with it correlates; the inner conj makes complex taps right."""
    return np.conj(np.fft.fft(np.conj(h.astype(np.complex128)), n=n, axis=axis))


def _overlap_save_poly(x: torch.Tensor, taps: np.ndarray, d: int, n_out: int) -> torch.Tensor:
    """Polyphase overlap-save: split tap index ``j = q*d + r`` so that
    ``y[i] = sum_r corr(x_r, h_r)[i]`` with ``x_r[n] = x[n*d + r]`` and
    ``h_r[q] = h[q*d + r]``; every FFT runs at the decimated rate and the
    phase spectra sum before the one inverse transform."""
    size = len(taps)
    md = -(-size // d)  # decimated-domain subfilter length
    # the JAX package's frame: a 128K-sample raw frame, capped at 4096
    # bins, floored by 2x the subfilter, never past one frame of outputs
    base = max(min(131072 // d, 4096), 512)
    m2 = 1 << (max(2 * md, min(base, n_out + md - 1)) - 1).bit_length()
    hop2 = m2 - md + 1  # valid correlation outputs per frame
    n_frames = -(-n_out // hop2)

    def spectra() -> np.ndarray:
        hp = np.zeros((md * d,), dtype=np.complex128)
        hp[:size] = taps
        return _complex64(_correlation_spectrum(hp.reshape(md, d), m2, axis=0).T)  # (d, m2)

    hf = device_table("fir.os_poly", (taps.dtype.str, taps.tobytes(), d, m2), x.device, spectra)

    # raw frames at stride hop2*d; (m2, d) makes the phase split a view
    frames = overlapped_frames(x, hop2 * d, m2 * d, n_frames)  # (B, F, m2*d)
    b = x.shape[0]
    ph = frames.reshape(b, n_frames, m2, d).transpose(2, 3)  # (B, F, d, m2)
    # per frame: the phase spectra, summed, then the one inverse transform
    y = fixed_row_calls(lambda p: torch.fft.ifft(torch.sum(spectral_product(torch.fft.fft(p), hf), dim=-2)),
                        ph, 2)[:, :, :hop2]
    return y.reshape(b, n_frames * hop2)[:, :n_out]


def _overlap_save(x: torch.Tensor, taps: np.ndarray, d: int, n_out: int) -> torch.Tensor:
    """Frequency-domain decimating correlation over overlapped frames of
    ``x`` (group-delay prefix already dropped):
    ``y[i] = sum_j x[i*d + j] h[j]``."""
    size = len(taps)
    m = _overlap_save_frame(size)
    hop = ((m - size + 1) // d) * d
    if hop <= 0:
        raise ValueError("filter too long for overlap-save frame")
    n_frames = -(-(n_out * d) // hop)

    hf = device_table("fir.overlap_save", (taps.dtype.str, taps.tobytes(), m), x.device,
                      lambda: _complex64(_correlation_spectrum(taps, m)))
    frames = overlapped_frames(x, hop, m, n_frames)  # (B, n_frames, m)
    corr = fixed_row_calls(lambda f: torch.fft.ifft(spectral_product(torch.fft.fft(f), hf)), frames, 2)
    # linear-valid decimated outputs of each frame: 0, d, ..., hop-d
    picks = corr[:, :, 0:hop:d]
    return picks.reshape(x.shape[0], n_frames * (hop // d))[:, :n_out]
