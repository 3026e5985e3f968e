"""Fused frontend: decode -> exact NCO mix -> polyphase decimating FIR,
optionally followed by the fftshifted STFT magnitudes.

The counterpart of ``quadrs_tpu.ops.frontend_pallas.fused_frontend_t``,
with the same arguments and outputs.  On a CUDA tensor it launches the
hand-written kernels of ``csrc/frontend.cu`` (:func:`frontend_fir`,
:func:`frontend_fir_stft`); on a CPU tensor it runs
:func:`fused_frontend_t_reference`, the plain PyTorch version of the same
function.  A CUDA tensor never reaches the plain version through
:func:`fused_frontend_t`, and no failure falls back to it.

Phase planning is the JAX package's, unchanged: ``tout`` decimated
outputs form one phase tile with its own host-exact base angle
(:func:`tile_bases_t`), and the host cos/sin(delta) tables cover the
tile plus a 128-column halo (:func:`_plan_t`).  ``tout`` was sized for
the TPU's VMEM; here it is only the planning unit, and a CUDA block
(256 or 128 outputs) always sits inside one tile.

Past ``n_valid`` samples are zeroed in the decoded domain for every
format.  The TPU kernel masks only cu8/cs16 and relies on zero bytes
for cs8/cf32; the two agree wherever the tail is zero padding, which is
the only way the stream runner pads.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from quadrs_tpu_torch.formats import FileFormat, decode_plane
from quadrs_tpu_torch.ops.nco import ExactNCO

_FMT_CODE = {
    FileFormat.COMPLEX_FLOAT32: 0,
    FileFormat.COMPLEX_INT8: 1,
    FileFormat.COMPLEX_UINT8: 2,
    FileFormat.COMPLEX_INT16: 3,
}
_HALO = 128  # decimated columns past a tile that its outputs may read


@dataclass(frozen=True)
class FrontendSpec:
    fmt: FileFormat
    sample_rate: int
    shift_freq: int
    decimate: int
    taps_bytes: bytes  # f32 taps, hashable for caching

    @property
    def taps(self) -> np.ndarray:
        return np.frombuffer(self.taps_bytes, dtype=np.float32)

    @property
    def m_sub(self) -> int:
        """Polyphase subfilters, ``ceil(taps / decimate)``."""
        return -(-len(self.taps) // self.decimate)


def supported_t(decimate: int) -> bool:
    """The kernel's decimation envelope (with at most 128 subfilters)."""
    return 1 <= decimate <= 64


def _tout_t(spec: FrontendSpec) -> int:
    """Decimated outputs per phase tile: 4096 for cf32, 8192 otherwise,
    halved past 32 and quartered past 64 subfilters — the JAX package's
    tile size, kept as the phase-planning unit so bases and tables stay
    identical to its own."""
    base = 4096 if spec.fmt is FileFormat.COMPLEX_FLOAT32 else 8192
    if spec.m_sub > 64:
        base //= 4
    elif spec.m_sub > 32:
        base //= 2
    return max(1024, base)


@functools.lru_cache(maxsize=8)
def _plan_t(spec: FrontendSpec):
    """(m_sub, m_pad, hp, cdm, sdm, cdh, sdh): the polyphase taps
    ``hp[m, d] = h[m*D + d]`` zero-padded to ``m_pad >= 8`` rows, and the
    host-f64 cos/sin tables of the in-tile NCO angles, laid out (D, cols)
    as ``table[d, c] = f(angle(c*D + d))`` for the tile's ``tout``
    columns (``*m``) and its 128-column halo (``*h``)."""
    d = spec.decimate
    taps = spec.taps
    size = len(taps)
    m_sub = spec.m_sub
    if m_sub > 128:
        raise ValueError("filter too long for the transposed frontend")
    m_pad = max(8, -(-m_sub // 8) * 8)
    hp = np.zeros((m_pad, d), dtype=np.float32)
    flat = np.zeros(m_sub * d, dtype=np.float32)
    flat[:size] = taps
    hp[:m_sub] = flat.reshape(m_sub, d)

    nco = ExactNCO(spec.shift_freq, spec.sample_rate)

    def table(col0: int, cols: int) -> np.ndarray:
        c = col0 + np.arange(cols, dtype=np.int64)[None, :]
        dd = np.arange(d, dtype=np.int64)[:, None]
        return nco.angles(c * d + dd)

    def cs(delta: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        return (
            np.cos(delta.astype(np.float64)).astype(np.float32),
            np.sin(delta.astype(np.float64)).astype(np.float32),
        )

    tout = _tout_t(spec)
    cdm, sdm = cs(table(0, tout))
    cdh, sdh = cs(table(tout, _HALO))
    return m_sub, m_pad, hp, cdm, sdm, cdh, sdh


@functools.lru_cache(maxsize=8)
def _plan_stft(fft_width: int):
    """The JAX package's (128, 128) block-diagonal DFT: 128/W copies of
    F_W on the diagonal with the fftshift folded into the column order,
    ``Y[r, w*W + k] = sum_n y[r, w*W + n] * F[n, (k + W/2) % W]``."""
    w = fft_width
    per = 128 // w
    n = np.arange(w)
    f = np.exp(-2j * np.pi * np.outer(n, n) / w)
    f = f[:, (n + w // 2) % w]  # fftshifted bin order
    big = np.zeros((128, 128), dtype=np.complex128)
    for i in range(per):
        big[i * w : (i + 1) * w, i * w : (i + 1) * w] = f
    return big.real.astype(np.float32), big.imag.astype(np.float32)


def stft_fusable(fft_width: int) -> bool:
    """The STFT epilogue takes widths dividing 128 (a CUDA block's 128 or
    256 outputs then hold whole windows)."""
    return fft_width >= 2 and 128 % fft_width == 0


def tile_bases_t(spec: FrontendSpec, global_start: int, n_out: int) -> np.ndarray:
    """Host-exact per-tile NCO base angles for :func:`fused_frontend_t`,
    sized from ``n_out``."""
    tout = _tout_t(spec)
    l_in = tout * spec.decimate
    tiles = -(-n_out // tout)
    offs = global_start + np.arange(tiles, dtype=np.int64) * l_in
    return ExactNCO(spec.shift_freq, spec.sample_rate).angles(offs)


@dataclass(frozen=True)
class FrontendTables:
    """The frontend's tensors, on the device of the planes they serve.

    ``hp``: (m_pad, D) polyphase taps; ``cos``/``sin``: ((tout+128)*D,)
    cos/sin(delta) in in-tile sample order (the JAX tables transposed to
    the planes' own order); ``stft_cos``/``stft_sin``: (W,) twiddles
    ``e^{-2 pi i j / W}`` for the STFT epilogue, or None."""

    hp: torch.Tensor
    cos: torch.Tensor
    sin: torch.Tensor
    stft_cos: torch.Tensor | None = None
    stft_sin: torch.Tensor | None = None


def sample_order(main: np.ndarray, halo: np.ndarray) -> np.ndarray:
    """(D, tout) + (D, 128) JAX tables -> ((tout+128)*D,) in in-tile
    sample order: entry ``c*D + d`` is ``table[d, c]``."""
    return np.ascontiguousarray(np.concatenate([main, halo], axis=1).T.reshape(-1))


def stft_twiddles(fft_width: int) -> tuple[np.ndarray, np.ndarray]:
    """(cos, sin) of ``-2 pi j / W`` for j < W, f64-evaluated, f32."""
    a = -2.0 * np.pi * np.arange(fft_width, dtype=np.float64) / fft_width
    return np.cos(a).astype(np.float32), np.sin(a).astype(np.float32)


def frontend_tables(
    spec: FrontendSpec, stft_width: int | None = None, device=None
) -> FrontendTables:
    """The frontend's tables from the host planners, on ``device``."""
    _, _, hp, cdm, sdm, cdh, sdh = _plan_t(spec)
    t = functools.partial(torch.tensor, device=device)  # copies: _plan_t is cached
    tw = (None, None) if stft_width is None else map(t, stft_twiddles(stft_width))
    return FrontendTables(
        t(hp), t(sample_order(cdm, cdh)), t(sample_order(sdm, sdh)), *tw
    )


def _block_outputs(decimate: int) -> int:
    """Outputs per CUDA block: 256, or 128 past D 32, which keeps the
    staged span (~(bout + 127)·D samples) inside 227 KB of shared memory.
    Both divide every tout, so a block never straddles a phase tile."""
    return 256 if decimate <= 32 else 128


def _check_launch(planes, bases, tables, spec, n_out, n_ok, stft_width):
    """Raise unless every input is what the kernel takes."""
    dev = planes.device
    if dev.type != "cuda":
        raise ValueError(f"the frontend kernel takes CUDA tensors, got {dev}")
    if planes.dtype != spec.fmt.torch_dtype:
        raise ValueError(
            f"{spec.fmt.value} planes must be {spec.fmt.torch_dtype}, got {planes.dtype}"
        )
    if planes.dim() != 2 or planes.shape[0] != 2 or planes.stride(1) != 1:
        raise ValueError(
            f"planes must be (2, n) with unit stride, got {tuple(planes.shape)} "
            f"strides {planes.stride()}"
        )
    if not 0 <= n_ok <= planes.shape[1]:
        # the kernel reads every sample below n_ok
        raise ValueError(f"n_ok {n_ok} outside [0, {planes.shape[1]}]")
    d, tout = spec.decimate, _tout_t(spec)
    want = {
        "bases": (bases, (-(-n_out // tout),)),
        "hp": (tables.hp, (max(8, -(-spec.m_sub // 8) * 8), d)),
        "cos": (tables.cos, ((tout + _HALO) * d,)),
        "sin": (tables.sin, ((tout + _HALO) * d,)),
    }
    if stft_width is not None:
        want["stft_cos"] = (tables.stft_cos, (stft_width,))
        want["stft_sin"] = (tables.stft_sin, (stft_width,))
    for name, (x, shape) in want.items():
        if (
            x is None
            or x.device != dev
            or x.dtype != torch.float32
            or tuple(x.shape) != shape
            or not x.is_contiguous()
        ):
            raise ValueError(
                f"{name} must be a contiguous f32 {shape} tensor on {dev}, got "
                f"{None if x is None else (tuple(x.shape), x.dtype, x.device)}"
            )


def _kernel_args(planes, bases, tables, spec, n_ok):
    return (
        _FMT_CODE[spec.fmt],
        planes.device.index,
        planes[0].data_ptr(),
        planes[1].data_ptr(),
        n_ok,
        bases.data_ptr(),
        tables.cos.data_ptr(),
        tables.sin.data_ptr(),
        tables.hp.data_ptr(),
        spec.decimate,
        spec.m_sub,
        _tout_t(spec),
        _block_outputs(spec.decimate),
    )


def frontend_fir(
    planes, bases, tables: FrontendTables, spec: FrontendSpec, n_out: int, n_ok: int
) -> torch.Tensor:
    """Kernel 1 (``qt_frontend_fir``): (2, n_out) f32 decimated planes.
    ``n_ok``: samples of ``planes`` to use; later ones count as zero.
    :attr:`launches` counts the launches."""
    from quadrs_tpu_torch.ops._cuda import library

    _check_launch(planes, bases, tables, spec, n_out, n_ok, None)
    out = torch.empty((2, n_out), dtype=torch.float32, device=planes.device)
    lib = library()
    stream = torch.cuda.current_stream(planes.device).cuda_stream
    lib.call(
        "qt_frontend_fir",
        *_kernel_args(planes, bases, tables, spec, n_ok),
        n_out, out[0].data_ptr(), out[1].data_ptr(), stream,
    )
    frontend_fir.launches += 1
    return out


frontend_fir.launches = 0


def frontend_fir_stft(
    planes,
    bases,
    tables: FrontendTables,
    spec: FrontendSpec,
    n_out: int,
    n_ok: int,
    stft_width: int,
) -> torch.Tensor:
    """Kernel 2 (``qt_frontend_fir_stft``): (n_out/W, W) f32 fftshifted
    STFT norms of the decimated stream, which never leaves the kernel.
    :attr:`launches` counts the launches."""
    from quadrs_tpu_torch.ops._cuda import library

    _check_launch(planes, bases, tables, spec, n_out, n_ok, stft_width)
    norms = torch.empty(
        (n_out // stft_width, stft_width), dtype=torch.float32, device=planes.device
    )
    lib = library()
    stream = torch.cuda.current_stream(planes.device).cuda_stream
    lib.call(
        "qt_frontend_fir_stft",
        *_kernel_args(planes, bases, tables, spec, n_ok),
        n_out, tables.stft_cos.data_ptr(), tables.stft_sin.data_ptr(),
        stft_width, norms.data_ptr(), stream,
    )
    frontend_fir_stft.launches += 1
    return norms


frontend_fir_stft.launches = 0


def no_tf32() -> None:
    """Keep f32 matmuls and convolutions on the card in full f32: the
    reference runs them at ``Precision.HIGHEST``, and TF32 keeps about
    three decimal digits."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def fused_frontend_t_reference(
    planes: torch.Tensor,
    bases: torch.Tensor,
    spec: FrontendSpec,
    n_out: int,
    n_ok: int,
    tables: FrontendTables,
    stft_width: int | None = None,
) -> torch.Tensor:
    """The plain PyTorch version of the kernels, on any device: decode,
    mask past ``n_ok``, per-tile table mix, polyphase FIR as one
    ``(cols, D) @ (D, m_pad)`` product summed along its diagonals
    (``y[i] = sum_m C2[i + m, m]``), then the block DFT epilogue."""
    if planes.is_cuda:
        no_tf32()
    d, m_sub, tout = spec.decimate, spec.m_sub, _tout_t(spec)
    tiles = -(-n_out // tout)
    l_in, cols = tout * d, tout + _HALO
    need = tiles * l_in + _HALO * d
    n_ok = max(0, min(n_ok, need, planes.shape[1]))

    def decoded(plane):
        x = torch.zeros(need, dtype=torch.float32, device=planes.device)
        x[:n_ok] = decode_plane(plane[:n_ok], spec.fmt)
        return x.unfold(0, cols * d, l_in)  # (tiles, cols*D): each tile + halo

    xr, xi = decoded(planes[0]), decoded(planes[1])
    cb, sb = torch.cos(bases)[:, None], torch.sin(bases)[:, None]
    c = tables.cos * cb - tables.sin * sb
    s = tables.sin * cb + tables.cos * sb
    mre = (xr * c - xi * s).reshape(tiles, cols, d)
    mim = (xr * s + xi * c).reshape(tiles, cols, d)

    def fir(x):
        c2 = torch.matmul(x, tables.hp.T)  # (tiles, cols, m_pad)
        y = c2[:, 0:tout, 0].clone()
        for m in range(1, m_sub):
            y += c2[:, m : m + tout, m]
        return y.reshape(-1)[:n_out]

    yr, yi = fir(mre), fir(mim)
    if stft_width is None:
        return torch.stack([yr, yi])
    w = stft_width
    fr, fi = (torch.as_tensor(a[:w, :w], device=planes.device) for a in _plan_stft(w))
    yr, yi = yr.reshape(-1, w), yi.reshape(-1, w)
    zr = yr @ fr - yi @ fi
    zi = yr @ fi + yi @ fr
    return torch.sqrt(zr * zr + zi * zi)


def fused_frontend_t(
    planes: torch.Tensor,
    bases: torch.Tensor,
    spec: FrontendSpec,
    n_out: int,
    *,
    n_valid: int | None = None,
    stft_width: int | None = None,
    tables: FrontendTables | None = None,
) -> torch.Tensor:
    """Decode -> mix -> FIR over a contiguous chunk, the contract of the
    JAX ``fused_frontend_t``.

    ``planes``: (2, n) native-dtype planes, already advanced past the FIR
    group delay; ``bases``: (tiles,) f32 per-tile angles from
    :func:`tile_bases_t`; ``n_valid``: real samples in ``planes`` (later
    ones are zeroed in the decoded domain).  Returns (2, n_out) f32
    decimated planes, or with ``stft_width`` the (n_out/W, W) fftshifted
    f32 norms.  ``tables``: the :func:`frontend_tables` on the planes'
    device (planned here when omitted).

    A CUDA tensor goes to the kernels, a CPU tensor to the plain
    version; any other device raises."""
    d = spec.decimate
    if not supported_t(d):
        raise ValueError(f"the fused frontend requires 1 <= decimate <= 64, got {d}")
    if stft_width is not None:
        if not stft_fusable(stft_width):
            raise ValueError(f"the STFT epilogue requires a width dividing 128, got {stft_width}")
        if n_out % stft_width:
            raise ValueError(f"n_out {n_out} is not a whole number of {stft_width}-point windows")
    if tables is None:
        tables = frontend_tables(spec, stft_width, device=planes.device)
    n_ok = planes.shape[1] if n_valid is None else max(0, min(int(n_valid), planes.shape[1]))
    if n_out == 0:
        shape = (2, 0) if stft_width is None else (0, stft_width)
        return torch.zeros(shape, dtype=torch.float32, device=planes.device)
    if planes.device.type == "cuda":
        if stft_width is None:
            return frontend_fir(planes, bases, tables, spec, n_out, n_ok)
        return frontend_fir_stft(planes, bases, tables, spec, n_out, n_ok, stft_width)
    if planes.device.type == "cpu":
        return fused_frontend_t_reference(planes, bases, spec, n_out, n_ok, tables, stft_width)
    raise ValueError(f"the fused frontend runs on cuda or cpu, got {planes.device}")
