"""Fused waterfall: decode -> window -> DFT of width 128·b -> fftshifted
norms, and its two in-kernel reductions (per-window peak, per-bin survey).

The counterpart of ``quadrs_tpu.ops.waterfall_pallas``: the same specs,
arguments and outputs for :func:`fused_waterfall`,
:func:`fused_waterfall_search` and :func:`fused_waterfall_scan`.  On a
CUDA tensor each launches its hand-written kernel of
``csrc/waterfall.cu`` (:func:`waterfall_norms`, :func:`waterfall_search`,
:func:`waterfall_scan`); on a CPU tensor each runs its plain PyTorch
version (``*_reference``): decode, overlapped frames, window,
``torch.fft.fft``, fftshift, ``sqrt(re² + im²)``, then the reduction.  A
CUDA tensor never reaches a plain version through these functions, and
no failure falls back to one.

The TPU package routes each stride and width through one of several
layouts (pre-arranged windows, in-kernel class rows, sub-aligned class
interleaves, tiles sized for VMEM).  Here one kernel body takes every
width ``128·b`` (2 <= b <= 64) at every integer stride >= 1, any base
pointer and any stream stride.  Its host side lives here: the pass plan
(:func:`fft_plan`: radix-8 Stockham passes over the power-of-two part of
the width, a direct m-point DFT for its odd part m), the f64-planned f32
tables (:func:`plan_twiddles`, :func:`decode_table`), the window tile
(:func:`window_tile`, ~256 threads a block, 8 points a thread) and the
grid (:func:`kernel_grid`); ``csrc/waterfall.cu`` derives the same plan
from the width and refuses a grid that does not cover the tiles.

Peak contract (both the kernel and its plain version): the maximum
magnitude and the lowest fftshifted bin that holds it; a window whose
norms hold a NaN returns bin ``width - 1`` and a NaN magnitude, as the
TPU kernel does (``waterfall_pallas.py:238-244``).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from quadrs_tpu_torch.formats import FileFormat, decode_plane
from quadrs_tpu_torch.ops._cuda import count_launch
from quadrs_tpu_torch.ops.fir import overlapped_frames
from quadrs_tpu_torch.ops.frontend import _FMT_CODE
from quadrs_tpu_torch.ops.stft import blackman_harris_window, stft_norms

_POINTS = 8  # complex points a kernel thread holds (csrc/waterfall.cu kPoints)
_BLOCK_THREADS = 256  # threads of a kernel block to aim for (csrc/waterfall.cu kBlockThreads)
# kernel blocks to aim for on an H100 (132 SMs): norms and search 64 per SM,
# so the last wave of blocks is short; the scan 16 per SM, each writing a
# partial sum of every bin
_GRID_BLOCKS = 8448
_SCAN_GRID_BLOCKS = 2112


@dataclass(frozen=True)
class WaterfallSpec:
    fmt: FileFormat
    width: int
    windowing: str = "rectangular"


def supported(width: int) -> bool:
    """width = 128*b with 2 <= b <= 64 (256..8192)."""
    return width % 128 == 0 and 2 <= width // 128 <= 64


def windowed(windowing: str) -> bool:
    return windowing in ("blackman-harris", "blackmanharris")


def plan_window(spec: WaterfallSpec) -> np.ndarray | None:
    """The f32 Blackman-Harris window of ``spec``, or None (rectangular)."""
    return blackman_harris_window(spec.width) if windowed(spec.windowing) else None


def fft_plan(width: int) -> tuple[tuple[int, ...], int]:
    """The kernel's factorization of ``width = 128·b``: (the radices of its
    Stockham passes over the power-of-two part ``P = width / m``, 16 while
    16 divides what is left and then the rest, m) where m is the odd part
    of b.  With ``m > 1`` a direct m-point DFT is the last pass."""
    m = width // 128
    while m % 2 == 0:
        m //= 2
    radices, rest = [], width // m
    while rest > 1:
        radices.append(min(_POINTS, rest))
        rest //= radices[-1]
    return tuple(radices), m


def _pass_strides(radices) -> list[int]:
    """``Ns`` of each pass: the product of the radices before it."""
    ns = [1]
    for r in radices[:-1]:
        ns.append(ns[-1] * r)
    return ns


@functools.lru_cache(maxsize=8)
def plan_twiddles(width: int) -> np.ndarray:
    """The kernel's DFT tables, evaluated in f64 and stored as f32, as
    interleaved (re, im) pairs: for each radix-R pass after the first, in
    order, ``W_{Ns·R}^{j·r}`` at ``(r - 1)·Ns + j`` (1 <= r < R, j < Ns);
    then, where m > 1 (:func:`fft_plan`), ``W_m^k`` (k < m) and the last
    pass's twiddle ``W_N^{(i mod P)·(i div P)}`` at i < N.  The kernel
    keeps all but that last part in shared memory."""
    radices, m = fft_plan(width)
    parts = []
    for ns, r in zip(_pass_strides(radices), radices):
        if ns > 1:
            parts.append(np.exp(-2j * np.pi * np.outer(np.arange(1, r), np.arange(ns)) / (ns * r)).reshape(-1))
    if m > 1:
        p = width // m
        i = np.arange(width)
        parts.append(np.exp(-2j * np.pi * np.arange(m) / m))
        parts.append(np.exp(-2j * np.pi * (i % p) * (i // p) / width))
    z = np.concatenate(parts)
    return np.stack([z.real, z.imag], axis=-1).reshape(-1).astype(np.float32)


def twiddles_len(width: int) -> int:
    radices, m = fft_plan(width)
    pairs = sum((r - 1) * ns for ns, r in zip(_pass_strides(radices), radices) if ns > 1)
    return 2 * (pairs + (m + width if m > 1 else 0))


def decode_table(fmt: FileFormat) -> np.ndarray | None:
    """The kernel's 256-entry f32 decode table of a byte format (cs8,
    cu8), indexed by the byte's unsigned value: the format's decode of
    every code, bit-equal to the IEEE division it replaces.  None for
    cs16 (decoded by division) and cf32."""
    if fmt.torch_dtype not in (torch.int8, torch.uint8):
        return None
    codes = np.arange(256, dtype=np.uint8)
    if fmt.torch_dtype == torch.int8:
        codes = codes.view(np.int8)
    return np.asarray(decode_plane(codes, fmt), dtype=np.float32)


@dataclass(frozen=True)
class WaterfallTables:
    """The kernel's tables on the device of the planes they serve:
    ``twiddles`` (:func:`plan_twiddles`), ``window`` ((width,) f32, or
    None for rectangular windows) and ``decode`` (:func:`decode_table`,
    or None for cs16 and cf32)."""

    twiddles: torch.Tensor
    window: torch.Tensor | None
    decode: torch.Tensor | None = None


def waterfall_tables(spec: WaterfallSpec, device=None) -> WaterfallTables:
    """The planned tables of ``spec`` on ``device``."""
    window, decode = plan_window(spec), decode_table(spec.fmt)
    return WaterfallTables(
        torch.tensor(plan_twiddles(spec.width), device=device),  # a copy: the plan is cached
        None if window is None else torch.tensor(window, device=device),
        None if decode is None else torch.tensor(decode, device=device),
    )


def window_tile(width: int) -> int:
    """Windows per kernel block: a window takes width/16 threads, 16
    points each, and a block about :data:`_BLOCK_THREADS` of them."""
    return max(1, _BLOCK_THREADS // (width // _POINTS))


def kernel_grid(n_streams: int, n_windows: int, width: int, blocks: int = _GRID_BLOCKS) -> tuple[int, int]:
    """(tiles per block, blocks per stream) of the kernels: about
    ``blocks`` blocks, each walking a contiguous run of window tiles (so
    its tables load once per run, and the scan folds the run into one
    partial).  A function of the shapes only, so the scan's reduction
    order, and its result, repeat run to run."""
    n_tiles = -(-n_windows // window_tile(width))
    per_block = -(-n_tiles // min(n_tiles, max(1, -(-blocks // n_streams))))
    return per_block, -(-n_tiles // per_block)


# -- plain versions ---------------------------------------------------------


def fused_waterfall_reference(
    planes: torch.Tensor, spec: WaterfallSpec, n_windows: int, *, stride: int | None = None, window=None
) -> torch.Tensor:
    """The plain version of :func:`waterfall_norms`, on any device and at
    any width: (S, 2, n) native planes -> (S, n_windows, width) f32
    fftshifted norms.  ``window`` replaces the spec's planned window."""
    s = planes.shape[0]
    x = torch.complex(decode_plane(planes[:, 0], spec.fmt), decode_plane(planes[:, 1], spec.fmt))
    frames = overlapped_frames(x, stride or spec.width, spec.width, n_windows)
    if window is None:
        window = plan_window(spec)
    norms = stft_norms(frames.reshape(s * n_windows, spec.width), window=window)
    return norms.reshape(s, n_windows, spec.width)


def peaks_of(norms: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., W) fftshifted norms -> ((...) int32 bin, (...) f32 magnitude)
    under the kernel's peak contract: the lowest bin holding the maximum;
    bin W-1 and a NaN magnitude where the norms hold a NaN."""
    val = torch.amax(norms, dim=-1)
    idx = torch.argmax(norms, dim=-1).to(torch.int32)
    return torch.where(torch.isnan(val), norms.shape[-1] - 1, idx).to(torch.int32), val


def fused_waterfall_search_reference(
    planes: torch.Tensor, spec: WaterfallSpec, n_windows: int, *, stride: int | None = None, window=None
) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version of :func:`waterfall_search`: (S, n_windows)
    int32 peak bins and f32 magnitudes."""
    return peaks_of(fused_waterfall_reference(planes, spec, n_windows, stride=stride, window=window))


def scan_of(
    norms: torch.Tensor, threshold, n_valid: int | None = None
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(S, windows, W) norms -> per (stream, bin) the f32 sum, max and
    count of norms above ``threshold`` (compared in f32), over the first
    ``n_valid`` windows (by default all; none gives 0, -inf and 0)."""
    if n_valid is not None:
        norms = norms[:, : max(0, n_valid)]
    if not norms.shape[1]:
        zero = norms.new_zeros(norms.shape[0], norms.shape[2])
        return zero, torch.full_like(zero, -torch.inf), zero
    thr = torch.tensor(float(threshold), dtype=torch.float32, device=norms.device)
    return norms.sum(dim=1), torch.amax(norms, dim=1), (norms > thr).sum(dim=1).to(torch.float32)


def fused_waterfall_scan_reference(
    planes: torch.Tensor,
    spec: WaterfallSpec,
    n_windows: int,
    threshold,
    *,
    stride: int | None = None,
    window=None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain version of :func:`waterfall_scan`: three (S, width) f32
    arrays, sum, max and count above ``threshold`` over the windows."""
    return scan_of(fused_waterfall_reference(planes, spec, n_windows, stride=stride, window=window), threshold)


# -- the kernels --------------------------------------------------------------


def _check_launch(planes, tables: WaterfallTables, spec: WaterfallSpec, n_windows: int, stride: int):
    """Raise unless every input is what the kernels take."""
    dev = planes.device
    if dev.type != "cuda":
        raise ValueError(f"the waterfall kernels take CUDA tensors, got {dev}")
    if planes.dtype != spec.fmt.torch_dtype:
        raise ValueError(f"{spec.fmt.value} planes must be {spec.fmt.torch_dtype}, got {planes.dtype}")
    if planes.dim() != 3 or planes.shape[1] != 2 or planes.stride(2) != 1:
        raise ValueError(
            f"planes must be (S, 2, n) with unit stride along n, got {tuple(planes.shape)} "
            f"strides {planes.stride()}"
        )
    if not 1 <= planes.shape[0] <= 65535:
        raise ValueError(f"1 to 65535 streams, got {planes.shape[0]}")
    if not supported(spec.width):
        raise ValueError(f"the waterfall kernels take width = 128*b, 2 <= b <= 64, got {spec.width}")
    if n_windows < 1 or stride < 1:
        raise ValueError(f"n_windows {n_windows} and stride {stride} must be >= 1")
    last = (n_windows - 1) * stride + spec.width
    if last > planes.shape[2]:
        raise ValueError(f"{n_windows} windows at stride {stride} need {last} samples, planes hold {planes.shape[2]}")
    want = {"twiddles": (tables.twiddles, (twiddles_len(spec.width),))}
    if windowed(spec.windowing) or tables.window is not None:
        want["window"] = (tables.window, (spec.width,))
    if spec.fmt.torch_dtype in (torch.int8, torch.uint8):
        want["decode"] = (tables.decode, (256,))
    for name, (x, shape) in want.items():
        if x is None or x.device != dev or x.dtype != torch.float32 or tuple(x.shape) != shape or not x.is_contiguous():
            raise ValueError(
                f"{name} must be a contiguous f32 {shape} tensor on {dev}, got "
                f"{None if x is None else (tuple(x.shape), x.dtype, x.device)}"
            )


def _kernel_args(planes, tables: WaterfallTables, spec: WaterfallSpec, n_windows: int, stride: int, grid=None):
    """The entry points' shared leading arguments; ``grid`` defaults to
    :func:`kernel_grid`'s."""
    if grid is None:
        grid = kernel_grid(planes.shape[0], n_windows, spec.width)
    return (
        _FMT_CODE[spec.fmt],
        planes.device.index,
        planes.data_ptr(),
        planes.stride(0),
        planes.stride(1),
        planes.shape[0],
        n_windows,
        stride,
        spec.width,
        *grid,
        tables.twiddles.data_ptr(),
        None if tables.decode is None else tables.decode.data_ptr(),
        None if tables.window is None else tables.window.data_ptr(),
    )


def _stream(planes) -> int:
    return torch.cuda.current_stream(planes.device).cuda_stream


def waterfall_norms(
    planes: torch.Tensor, tables: WaterfallTables, spec: WaterfallSpec, n_windows: int, stride: int
) -> torch.Tensor:
    """Kernel ``qt_waterfall_norms``: (S, n_windows, width) f32
    fftshifted norms, each the approximate f32 square root of re² + im²
    (one MUFU op, relative error ~2^-23; the bank's tolerance is rtol
    2e-5).  :attr:`launches` counts the launches."""
    from quadrs_tpu_torch.ops._cuda import library

    _check_launch(planes, tables, spec, n_windows, stride)
    out = torch.empty((planes.shape[0], n_windows, spec.width), dtype=torch.float32, device=planes.device)
    library().call(
        "qt_waterfall_norms",
        *_kernel_args(planes, tables, spec, n_windows, stride),
        out.data_ptr(), _stream(planes),
    )
    count_launch(waterfall_norms)
    return out


waterfall_norms.launches = 0


def waterfall_search(
    planes: torch.Tensor, tables: WaterfallTables, spec: WaterfallSpec, n_windows: int, stride: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel ``qt_waterfall_search``: (S, n_windows) int32 peak bins and
    f32 magnitudes; the norms never leave the kernel.  :attr:`launches`
    counts the launches."""
    from quadrs_tpu_torch.ops._cuda import library

    _check_launch(planes, tables, spec, n_windows, stride)
    shape = (planes.shape[0], n_windows)
    val = torch.empty(shape, dtype=torch.float32, device=planes.device)
    idx = torch.empty(shape, dtype=torch.int32, device=planes.device)
    library().call(
        "qt_waterfall_search",
        *_kernel_args(planes, tables, spec, n_windows, stride),
        val.data_ptr(), idx.data_ptr(), _stream(planes),
    )
    count_launch(waterfall_search)
    return idx, val


waterfall_search.launches = 0


def waterfall_scan(
    planes: torch.Tensor,
    tables: WaterfallTables,
    spec: WaterfallSpec,
    n_windows: int,
    stride: int,
    threshold,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel ``qt_waterfall_scan``: per (stream, fftshifted bin) the f32
    sum, max and count of norms above ``threshold``, as three (S, width)
    arrays.  Blocks write per-tile-run partials to scratch, which a
    second pass of the same source reduces in a fixed order: no float
    atomics, so results repeat run to run.  :attr:`launches` counts the
    launches (both passes are one launch of the kernel)."""
    from quadrs_tpu_torch.ops._cuda import library

    _check_launch(planes, tables, spec, n_windows, stride)
    s, w = planes.shape[0], spec.width
    grid = kernel_grid(s, n_windows, w, _SCAN_GRID_BLOCKS)
    partial = torch.empty((3, s, grid[1], w), dtype=torch.float32, device=planes.device)
    out = torch.empty((3, s, w), dtype=torch.float32, device=planes.device)
    library().call(
        "qt_waterfall_scan",
        *_kernel_args(planes, tables, spec, n_windows, stride, grid),
        float(threshold), partial.data_ptr(), out.data_ptr(), _stream(planes),
    )
    count_launch(waterfall_scan)
    return out[0], out[1], out[2]


waterfall_scan.launches = 0


# -- the JAX package's entry points -------------------------------------------


def _resolve(planes, spec: WaterfallSpec, stride: int | None, tables: WaterfallTables | None):
    if not supported(spec.width):
        raise ValueError(f"fused waterfall requires width = 128*b (b in 2..64), got {spec.width}")
    stride = spec.width if stride is None else int(stride)
    if stride <= 0:
        raise ValueError("stride must be positive")
    if planes.device.type not in ("cuda", "cpu"):
        raise ValueError(f"the fused waterfall runs on cuda or cpu, got {planes.device}")
    if tables is None:
        tables = waterfall_tables(spec, device=planes.device)
    return stride, tables


def fused_waterfall(
    planes: torch.Tensor,
    spec: WaterfallSpec,
    n_windows: int,
    *,
    stride: int | None = None,
    tables: WaterfallTables | None = None,
) -> torch.Tensor:
    """(S, 2, n) native planes -> (S, n_windows, width) f32 fftshifted
    norms of the windows at ``stride`` (default ``width``).  ``tables``:
    :func:`waterfall_tables` on the planes' device (planned when
    omitted).  A CUDA tensor goes to the kernel, a CPU tensor to the
    plain version."""
    stride, tables = _resolve(planes, spec, stride, tables)
    if planes.is_cuda:
        return waterfall_norms(planes, tables, spec, n_windows, stride)
    return fused_waterfall_reference(planes, spec, n_windows, stride=stride, window=tables.window)


def fused_waterfall_search(
    planes: torch.Tensor,
    spec: WaterfallSpec,
    n_windows: int,
    *,
    stride: int | None = None,
    tables: WaterfallTables | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per (stream, window) the fftshifted peak bin (int32) and its f32
    magnitude, under the module's peak contract; on the card the norms
    never reach device memory."""
    stride, tables = _resolve(planes, spec, stride, tables)
    if planes.is_cuda:
        return waterfall_search(planes, tables, spec, n_windows, stride)
    return fused_waterfall_search_reference(planes, spec, n_windows, stride=stride, window=tables.window)


def fused_waterfall_scan(
    planes: torch.Tensor,
    spec: WaterfallSpec,
    n_windows: int,
    threshold,
    *,
    stride: int | None = None,
    tables: WaterfallTables | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Band-survey reduction: per (stream, fftshifted bin) the sum and
    max of the window norms and the count of windows above ``threshold``
    (a runtime f32 scalar), each (S, width) f32; on the card the norms
    never reach device memory."""
    stride, tables = _resolve(planes, spec, stride, tables)
    if planes.is_cuda:
        return waterfall_scan(planes, tables, spec, n_windows, stride, threshold)
    return fused_waterfall_scan_reference(planes, spec, n_windows, threshold, stride=stride, window=tables.window)
