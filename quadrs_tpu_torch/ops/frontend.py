"""Fused frontend: decode -> exact NCO mix -> polyphase decimating FIR,
optionally followed by the fftshifted STFT magnitudes.

The counterpart of ``quadrs_tpu.ops.frontend_pallas``: ``fused_frontend_t``
and, at the end of this module, the v1 ``fused_frontend``, with the same
arguments and outputs.  On a CUDA tensor they launch the hand-written
kernels of ``csrc/frontend.cu`` (:func:`frontend_fir`,
:func:`frontend_fir_stft`, :func:`frontend_banded`); on a CPU tensor they
run :func:`fused_frontend_t_reference` and :func:`fused_frontend_reference`,
the plain PyTorch versions of the same functions.  A CUDA tensor never
reaches a plain version through the entry points, and no failure falls
back to one.

Phase planning is the JAX package's, unchanged: ``tout`` decimated
outputs form one phase tile with its own host-exact base angle
(:func:`tile_bases_t`), and the host cos/sin(delta) tables cover the
tile plus a 128-column halo (:func:`_plan_t`).  ``tout`` was sized for
the TPU's VMEM; here it is only the planning unit, and a CUDA block
(32 to 256 outputs, :func:`launch_plan`) always sits inside one tile.

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
    ``e^{-2 pi i j / W}`` for the STFT epilogue, or None; ``decode``:
    the 256-entry f32 decode table of a byte format
    (``ops.waterfall.decode_table``), None for cs16 and cf32."""

    hp: torch.Tensor
    cos: torch.Tensor
    sin: torch.Tensor
    stft_cos: torch.Tensor | None = None
    stft_sin: torch.Tensor | None = None
    decode: torch.Tensor | None = None


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
        t(hp), t(sample_order(cdm, cdh)), t(sample_order(sdm, sdh)), *tw,
        decode=decode_tensor(spec.fmt, device),
    )


def decode_tensor(fmt: FileFormat, device=None) -> torch.Tensor | None:
    """The kernels' decode table of a byte format on ``device``; None for
    cs16 and cf32."""
    from quadrs_tpu_torch.ops.waterfall import decode_table  # imports this module

    table = decode_table(fmt)
    return None if table is None else torch.tensor(table, device=device)


_R = 8  # consecutive outputs a kernel thread owns (csrc/frontend.cu kR)
_CHUNK = 8  # polyphase subfilters whose partial sums a thread holds at once (kMC)
_SMEM_BYTES = 232_448  # shared memory one block may use on Hopper
_SM_BYTES = 233_472  # shared memory of one SM; every resident block reserves 1 KiB more
_BLOCKS = (256, 128, 64, 32)  # outputs a block may own; each divides every tout
_STAGE_THREADS = 256  # threads of a block of 128 outputs or more: the staging is latency-bound on few


@dataclass(frozen=True)
class LaunchPlan:
    """How the kernels of ``csrc/frontend.cu`` launch for one spec.

    ``bout`` outputs a block; ``outputs`` (8) consecutive outputs a thread;
    ``chunk`` (8) subfilters a chunk; ``groups``: 1, or 2 when the filter
    is exactly two chunks and each takes half of the workers; ``threads``
    a block; ``inst``: the instantiation, ``"d32"`` or ``"any"``; ``row``:
    floats per row of the staged span (16-byte aligned, 4 mod 8);
    ``cols``: the columns a block stages, ``bout + m_sub - 1``;
    ``smem_bytes``; ``blocks_per_sm`` resident blocks."""

    bout: int
    outputs: int
    chunk: int
    groups: int
    threads: int
    inst: str
    row: int
    cols: int
    smem_bytes: int
    blocks_per_sm: int


def _layout(d: int, m_sub: int, bout: int, elem: int, ex: bool, width: int) -> tuple[int, int]:
    """(row floats, shared-memory bytes) of a block: csrc/frontend.cu's
    ``make_layout``."""
    m_pad = -(-m_sub // _CHUNK) * _CHUNK
    row = -(-(bout + m_pad) // 16) * 16 + 4
    floats = 2 * d * row + d * m_pad + (256 if elem == 1 else 0) + (2 * bout if ex else 0) + 2 * width
    return row, 4 * floats


@functools.lru_cache(maxsize=64)
def launch_plan(spec: FrontendSpec, stft_width: int | None = None) -> LaunchPlan:
    """The launch plan of kernel 1 and the v1 kernel (``stft_width`` None)
    or of kernel 2.  Among the block sizes that hold whole STFT
    windows and fit shared memory it takes the one that keeps the most
    outputs resident on an SM, counted with the share of a block's staging
    that its halo of ``m_sub - 1`` columns wastes, preferring sizes that
    leave two blocks on an SM (one stages while the other sums).  Raises
    when no block fits."""
    d, m_sub = spec.decimate, spec.m_sub
    elem = spec.fmt.torch_dtype.itemsize
    chunks = -(-m_sub // _CHUNK)
    groups = 2 if chunks == 2 else 1  # at exactly two chunks, a group of workers per chunk
    width = stft_width or 0
    best = None
    for bout in _BLOCKS:
        if width and bout % width:
            continue
        row, nbytes = _layout(d, m_sub, bout, elem, groups == 2 or bool(width), width)
        if nbytes > _SMEM_BYTES:
            continue
        threads = -(-(2 * (bout // _R) * groups) // 32) * 32
        if bout >= 128:
            threads = max(threads, _STAGE_THREADS)
        # the kernel is built for 128 registers a thread: 512 threads an SM
        per_sm = min(_SM_BYTES // (nbytes + 1024), 512 // threads, 32)
        score = (per_sm >= 2, per_sm * bout * bout / (bout + m_sub - 1))
        if best is None or score > best[0]:
            best = (score, LaunchPlan(bout, _R, _CHUNK, groups, threads, "d32" if d == 32 else "any",
                                      row, bout + m_sub - 1, nbytes, per_sm))
    if best is None:
        raise ValueError(f"{len(spec.taps)} taps at decimate {d}: the staged span exceeds shared memory")
    return best[1]


def _check_inputs(planes, spec: FrontendSpec, n_ok: int, want: dict) -> None:
    """Raise unless ``planes`` are (2, n) native planes on a CUDA device
    with unit stride, ``0 <= n_ok <= n``, and each of ``want``'s
    ``name: (tensor, shape)`` is a contiguous f32 tensor of that shape on
    the same device, 16-byte aligned (the kernel reads tables as vectors)."""
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
    for name, (x, shape) in want.items():
        if (
            x is None
            or x.device != dev
            or x.dtype != torch.float32
            or tuple(x.shape) != shape
            or not x.is_contiguous()
            or x.data_ptr() % 16
        ):
            raise ValueError(
                f"{name} must be a contiguous, 16-byte aligned f32 {shape} tensor on {dev}, got "
                f"{None if x is None else (tuple(x.shape), x.dtype, x.device)}"
            )


@dataclass(frozen=True)
class _Launch:
    """What a launch of kernel 1 or 2 needs that depends only on
    ``(spec, stft_width)``: the leading scalar arguments after the
    pointers, the plan's, and the shapes the tables must have."""

    fmt: int
    d: int
    m_sub: int
    tout: int
    plan: LaunchPlan
    shapes: tuple  # (name, attribute of FrontendTables, shape)


@functools.lru_cache(maxsize=64)
def _launch_t(spec: FrontendSpec, stft_width: int | None) -> _Launch:
    d, tout = spec.decimate, _tout_t(spec)
    if spec.m_sub > 128:
        raise ValueError("filter too long for the transposed frontend")
    shapes = [
        ("hp", (max(8, -(-spec.m_sub // 8) * 8), d)),
        ("cos", ((tout + _HALO) * d,)),
        ("sin", ((tout + _HALO) * d,)),
    ]
    if stft_width is not None:
        shapes += [("stft_cos", (stft_width,)), ("stft_sin", (stft_width,))]
    if spec.fmt.torch_dtype.itemsize == 1:
        shapes.append(("decode", (256,)))
    return _Launch(_FMT_CODE[spec.fmt], d, spec.m_sub, tout, launch_plan(spec, stft_width), tuple(shapes))


def _launch(name: str, planes, bases, tables, spec, n_out: int, n_ok: int, stft_width, out) -> None:
    """Check the inputs of kernel 1 or 2 and launch it on the current
    stream; ``out``: the pointers and scalars after ``n_out``."""
    from quadrs_tpu_torch.ops._cuda import library

    la = _launch_t(spec, stft_width)
    want = {attr: (getattr(tables, attr), shape) for attr, shape in la.shapes}
    want["bases"] = (bases, (-(-n_out // la.tout),))
    _check_inputs(planes, spec, n_ok, want)
    re = planes.data_ptr()
    plan = la.plan
    library().call(
        name, la.fmt, planes.device.index, re, re + planes.stride(0) * planes.element_size(), n_ok,
        bases.data_ptr(), tables.cos.data_ptr(), tables.sin.data_ptr(), tables.hp.data_ptr(),
        0 if tables.decode is None else tables.decode.data_ptr(),
        la.d, la.m_sub, la.tout, plan.bout, plan.groups, plan.threads, n_out, *out,
        torch.cuda.current_stream(planes.device).cuda_stream,
    )


def frontend_fir(
    planes, bases, tables: FrontendTables, spec: FrontendSpec, n_out: int, n_ok: int
) -> torch.Tensor:
    """Kernel 1 (``qt_frontend_fir``): (2, n_out) f32 decimated planes.
    ``n_ok``: samples of ``planes`` to use; later ones count as zero.
    :attr:`launches` counts the launches."""
    out = torch.empty((2, n_out), dtype=torch.float32, device=planes.device)
    at = out.data_ptr()
    _launch("qt_frontend_fir", planes, bases, tables, spec, n_out, n_ok, None, (at, at + 4 * n_out))
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
    norms = torch.empty(
        (n_out // stft_width, stft_width), dtype=torch.float32, device=planes.device
    )
    # _launch has checked the twiddles before it reads these pointers
    tw = tables.stft_cos, tables.stft_sin
    out = (*(0 if t is None else t.data_ptr() for t in tw), stft_width, norms.data_ptr())
    _launch("qt_frontend_fir_stft", planes, bases, tables, spec, n_out, n_ok, stft_width, out)
    frontend_fir_stft.launches += 1
    return norms


frontend_fir_stft.launches = 0


def no_tf32() -> None:
    """Keep f32 matmuls and convolutions on the card in full f32: the
    reference runs them at ``Precision.HIGHEST``, and TF32 keeps about
    three decimal digits."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _polyphase_fir(x: torch.Tensor, hp: torch.Tensor, m_sub: int, tout: int, n_out: int) -> torch.Tensor:
    """The plain versions' FIR: ``x`` (tiles, cols, D) mixed samples of
    each phase tile and what follows it, ``hp`` (>= m_sub, D) polyphase
    taps; ``y[t*tout + i] = sum_m sum_dd hp[m, dd] x[t, i + m, dd]``, each
    subfilter summed first (one ``(cols, D) @ (D, m)`` product), then the
    subfilters along the diagonals ``C2[i + m, m]``."""
    c2 = torch.matmul(x, hp.T)  # (tiles, cols, m)
    y = c2[:, 0:tout, 0].clone()
    for m in range(1, m_sub):
        y += c2[:, m : m + tout, m]
    return y.reshape(-1)[:n_out]


def _mixed_t(planes, bases, spec: FrontendSpec, n_out: int, n_ok: int, tables: FrontendTables):
    """The plain versions' decode, mask and per-tile table mix: (mre, mim),
    each (tiles, tout + 128, D) f32, the mixed samples of every phase tile
    and its halo in polyphase order."""
    d, tout = spec.decimate, _tout_t(spec)
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
    return (xr * c - xi * s).reshape(tiles, cols, d), (xr * s + xi * c).reshape(tiles, cols, d)


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
    m_sub, tout = spec.m_sub, _tout_t(spec)
    mre, mim = _mixed_t(planes, bases, spec, n_out, n_ok, tables)
    yr = _polyphase_fir(mre, tables.hp, m_sub, tout, n_out)
    yi = _polyphase_fir(mim, tables.hp, m_sub, tout, n_out)
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


# ---------------------------------------------------------------------------
# v1: the JAX package's first fused frontend (``fused_frontend``), whose
# TPU kernel ran the FIR as a banded matmul.  It computes the same
# decode -> mix -> FIR as above, with two differences of contract: the mix
# is cos/sin(base[t] + delta[q]) per element (an f32 sum and f32 trig, not
# a table rotation), and a phase tile is 2048 outputs.  No path of the JAX
# package runs it; it is ported as a kernel with its plain version.
# ---------------------------------------------------------------------------

_TOUT_V1 = 2048  # outputs per v1 phase tile (the TPU's 16 x 128 output block)


def supported(decimate: int) -> bool:
    """The v1 envelope: ``decimate`` divides 128 (the TPU kernel's lhs
    rows land on row boundaries), at most 64."""
    return decimate in (1, 2, 4, 8, 16, 32, 64)


@functools.lru_cache(maxsize=8)
def _plan(spec: FrontendSpec) -> tuple[int, int, np.ndarray]:
    """(l_in, halo_p, delta): raw samples per tile, the halo after it that
    the JAX package reads (at least 32 rows of 128, covering the banded
    span), and the host-exact in-tile angles ``delta[q] = angle(q)``.
    ``delta[:l_in + halo_p]`` are the JAX package's ``delta_main`` and
    ``delta_halo`` in sample order; the table runs on to the last sample a
    block of the kernel stages, ``(2048 + m_sub - 1) * D``."""
    d = spec.decimate
    size = len(spec.taps)
    l_in = _TOUT_V1 * d
    span_p = -(-(127 * d + size) // 128) * 128
    halo_p = -(-max(span_p - 128 * d, 32 * 128) // 128) * 128
    n_tab = max(l_in + halo_p, (_TOUT_V1 + spec.m_sub - 1) * d)
    delta = ExactNCO(spec.shift_freq, spec.sample_rate).angles(np.arange(n_tab, dtype=np.int64))
    return l_in, halo_p, delta


def tile_bases(spec: FrontendSpec, global_start: int, tiles: int) -> np.ndarray:
    """Host-exact per-tile NCO base angles for :func:`fused_frontend`
    (2048-output tiles)."""
    l_in = _TOUT_V1 * spec.decimate
    offs = global_start + np.arange(tiles, dtype=np.int64) * l_in
    return ExactNCO(spec.shift_freq, spec.sample_rate).angles(offs)


@dataclass(frozen=True)
class BandedTables:
    """The v1 frontend's tensors: ``taps`` (m_sub * D,) zero-padded f32
    taps, ``delta`` the :func:`_plan` angle table, ``decode`` the decode
    table of a byte format (None for cs16 and cf32)."""

    taps: torch.Tensor
    delta: torch.Tensor
    decode: torch.Tensor | None = None


def banded_tables(spec: FrontendSpec, device=None) -> BandedTables:
    h = np.zeros(spec.m_sub * spec.decimate, dtype=np.float32)
    h[: len(spec.taps)] = spec.taps
    return BandedTables(torch.tensor(h, device=device), torch.tensor(_plan(spec)[2], device=device),
                        decode_tensor(spec.fmt, device))


def _banded_block_outputs(spec: FrontendSpec) -> int:
    """Outputs per CUDA block of the v1 kernel (:func:`launch_plan`);
    raises when no block's staged span and taps fit in shared memory."""
    return launch_plan(spec).bout


def frontend_banded(
    planes, bases, tables: BandedTables, spec: FrontendSpec, n_out: int
) -> torch.Tensor:
    """Kernel 3 (``qt_frontend_banded``): (2, n_out) f32 decimated planes
    of the v1 function; samples past ``planes.shape[1]`` count as zero.
    :attr:`launches` counts the launches."""
    from quadrs_tpu_torch.ops._cuda import library

    dev = planes.device
    want = {
        "bases": (bases, (-(-n_out // _TOUT_V1),)),
        "taps": (tables.taps, (spec.m_sub * spec.decimate,)),
        "delta": (tables.delta, (len(_plan(spec)[2]),)),
    }
    if spec.fmt.torch_dtype.itemsize == 1:
        want["decode"] = (tables.decode, (256,))
    _check_inputs(planes, spec, planes.shape[1], want)
    plan = launch_plan(spec)
    out = torch.empty((2, n_out), dtype=torch.float32, device=dev)
    re, at = planes.data_ptr(), out.data_ptr()
    library().call(
        "qt_frontend_banded",
        _FMT_CODE[spec.fmt], dev.index, re, re + planes.stride(0) * planes.element_size(), planes.shape[1],
        bases.data_ptr(), tables.delta.data_ptr(), tables.taps.data_ptr(),
        0 if tables.decode is None else tables.decode.data_ptr(), spec.decimate, spec.m_sub,
        _TOUT_V1, plan.bout, plan.groups, plan.threads, n_out, at, at + 4 * n_out,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    frontend_banded.launches += 1
    return out


frontend_banded.launches = 0


def fused_frontend_reference(
    planes: torch.Tensor, bases: torch.Tensor, spec: FrontendSpec, n_out: int
) -> torch.Tensor:
    """The plain PyTorch version of the v1 function, on any device: per
    2048-output tile, decode the tile's samples and those after it, zero
    samples past ``planes.shape[1]``, mix by ``cos/sin(base[t] + delta)``,
    then the FIR.

    The FIR sums each polyphase subfilter first, as the kernel does
    (:func:`_polyphase_fir`), where the JAX package's banded matmul
    ``lhs (16, span) @ W (span, 128)`` sums each output's taps in one run.
    The two agree to f32 rounding at a few hundred taps; past a few
    thousand taps of cu8 or cs16 the output is a small residual of the
    decode's large DC offset, f32 loses it in any order (4000 taps of cu8
    at decimate 32: ~2e-4 of the output's scale against an f64 sum), and
    only the kernel and this version share their rounding."""
    d, m_sub = spec.decimate, spec.m_sub
    l_in, _, delta = _plan(spec)
    tiles = -(-n_out // _TOUT_V1)
    span = len(delta)  # the samples of a tile and what follows it, a multiple of D
    need = (tiles - 1) * l_in + span
    n_ok = min(planes.shape[1], need)

    def decoded(plane):
        x = torch.zeros(need, dtype=torch.float32, device=planes.device)
        x[:n_ok] = decode_plane(plane[:n_ok], spec.fmt)
        return x.unfold(0, span, l_in)  # (tiles, span)

    xr, xi = decoded(planes[0]), decoded(planes[1])
    theta = bases[:, None] + torch.as_tensor(delta, device=planes.device)[None, :]
    c, s = torch.cos(theta), torch.sin(theta)
    mre = (xr * c - xi * s).reshape(tiles, span // d, d)
    mim = (xr * s + xi * c).reshape(tiles, span // d, d)
    h = np.zeros(m_sub * d, dtype=np.float32)
    h[: len(spec.taps)] = spec.taps
    hp = torch.tensor(h.reshape(m_sub, d), device=planes.device)
    return torch.stack([
        _polyphase_fir(mre, hp, m_sub, _TOUT_V1, n_out),
        _polyphase_fir(mim, hp, m_sub, _TOUT_V1, n_out),
    ])


def fused_frontend(
    planes: torch.Tensor,
    bases: torch.Tensor,
    spec: FrontendSpec,
    n_out: int,
    *,
    tables: BandedTables | None = None,
) -> torch.Tensor:
    """Decode -> mix -> FIR over a contiguous chunk, the contract of the
    JAX ``fused_frontend`` (v1).

    ``planes``: (2, n) native-dtype planes, already advanced past the FIR
    group delay; samples past ``n`` count as zero (decoded domain).
    ``bases``: (ceil(n_out / 2048),) f32 per-tile angles from
    :func:`tile_bases`.  Returns (2, n_out) f32 decimated planes.
    ``tables``: the :func:`banded_tables` on the planes' device (planned
    here when omitted).  A CUDA tensor goes to the kernel, a CPU tensor to
    the plain version; any other device raises."""
    d = spec.decimate
    if not supported(d):
        raise ValueError(f"the v1 frontend requires decimate | 128 (at most 64), got {d}")
    if n_out == 0:
        return torch.zeros((2, 0), dtype=torch.float32, device=planes.device)
    if planes.device.type == "cuda":
        if tables is None:
            tables = banded_tables(spec, device=planes.device)
        return frontend_banded(planes, bases, tables, spec, n_out)
    if planes.device.type == "cpu":
        return fused_frontend_reference(planes, bases, spec, n_out)
    raise ValueError(f"the v1 frontend runs on cuda or cpu, got {planes.device}")
