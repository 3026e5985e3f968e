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
width ``128·b`` (2 <= b <= 64) at every integer stride >= 1, by index
arithmetic alone.

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
from quadrs_tpu_torch.ops.fir import overlapped_frames
from quadrs_tpu_torch.ops.frontend import _FMT_CODE
from quadrs_tpu_torch.ops.stft import blackman_harris_window, stft_norms

_TILE_SAMPLES = 2048  # samples of a kernel block's window tile (one window past it)
_SCAN_BLOCKS = 1056  # scan blocks to aim for: 8 per SM of an H100 (132 SMs)


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


@functools.lru_cache(maxsize=8)
def plan_twiddles(width: int) -> np.ndarray:
    """The kernel's DFT tables, evaluated in f64 and stored as f32, packed
    into one array: ``W_128^j`` (j < 64) re then im, ``W_b^j`` (j < b) re
    then im, and ``W_N^{q·r}`` (q < b, r < 128, row-major) re then im,
    where ``N = width = 128·b``.  The kernel splits the sample index
    ``n = b·p + q``: b 128-point FFTs over p, the twiddle ``W_N^{q·r}``,
    then a b-point DFT over q gives bin ``k = r + 128·s``."""
    b = width // 128
    j = np.arange(64, dtype=np.float64)
    tw128 = np.exp(-2j * np.pi * j / 128.0)
    wb = np.exp(-2j * np.pi * np.arange(b, dtype=np.float64) / b)
    qr = np.outer(np.arange(b, dtype=np.float64), np.arange(128, dtype=np.float64))
    twq = np.exp(-2j * np.pi * qr / width).reshape(-1)
    parts = [tw128.real, tw128.imag, wb.real, wb.imag, twq.real, twq.imag]
    return np.concatenate(parts).astype(np.float32)


def twiddles_len(width: int) -> int:
    return 128 + 258 * (width // 128)


@dataclass(frozen=True)
class WaterfallTables:
    """The kernel's tables on the device of the planes they serve:
    ``twiddles`` (:func:`plan_twiddles`) and ``window`` ((width,) f32,
    or None for rectangular windows)."""

    twiddles: torch.Tensor
    window: torch.Tensor | None


def waterfall_tables(spec: WaterfallSpec, device=None) -> WaterfallTables:
    """The planned tables of ``spec`` on ``device``."""
    window = plan_window(spec)
    return WaterfallTables(
        torch.tensor(plan_twiddles(spec.width), device=device),  # a copy: the plan is cached
        None if window is None else torch.tensor(window, device=device),
    )


def window_tile(width: int) -> int:
    """Windows per kernel block: several at small widths, one from 2048."""
    return max(1, _TILE_SAMPLES // width)


def scan_grid(n_streams: int, n_windows: int, width: int) -> tuple[int, int]:
    """(tiles per block, blocks per stream) of the scan kernel: enough
    blocks to fill the card (:data:`_SCAN_BLOCKS`), each folding a
    contiguous run of window tiles into its partial sums.  A function of
    the shapes only, so the reduction order, and the result, repeat run
    to run."""
    n_tiles = -(-n_windows // window_tile(width))
    per_block = -(-n_tiles // min(n_tiles, max(1, -(-_SCAN_BLOCKS // n_streams))))
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


def scan_of(norms: torch.Tensor, threshold) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(S, windows, W) norms -> per (stream, bin) the f32 sum, max and
    count of norms above ``threshold`` (compared in f32)."""
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
    for name, (x, shape) in want.items():
        if x is None or x.device != dev or x.dtype != torch.float32 or tuple(x.shape) != shape or not x.is_contiguous():
            raise ValueError(
                f"{name} must be a contiguous f32 {shape} tensor on {dev}, got "
                f"{None if x is None else (tuple(x.shape), x.dtype, x.device)}"
            )


def _kernel_args(planes, tables: WaterfallTables, spec: WaterfallSpec, n_windows: int, stride: int, grid):
    """The entry points' shared leading arguments; ``grid`` is (tiles per
    block, blocks per stream)."""
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
        window_tile(spec.width),
        *grid,
        tables.twiddles.data_ptr(),
        None if tables.window is None else tables.window.data_ptr(),
    )


def _one_tile_each(n_windows: int, width: int) -> tuple[int, int]:
    return 1, -(-n_windows // window_tile(width))


def _stream(planes) -> int:
    return torch.cuda.current_stream(planes.device).cuda_stream


def waterfall_norms(
    planes: torch.Tensor, tables: WaterfallTables, spec: WaterfallSpec, n_windows: int, stride: int
) -> torch.Tensor:
    """Kernel ``qt_waterfall_norms``: (S, n_windows, width) f32
    fftshifted norms.  :attr:`launches` counts the launches."""
    from quadrs_tpu_torch.ops._cuda import library

    _check_launch(planes, tables, spec, n_windows, stride)
    out = torch.empty((planes.shape[0], n_windows, spec.width), dtype=torch.float32, device=planes.device)
    library().call(
        "qt_waterfall_norms",
        *_kernel_args(planes, tables, spec, n_windows, stride, _one_tile_each(n_windows, spec.width)),
        out.data_ptr(), _stream(planes),
    )
    waterfall_norms.launches += 1
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
        *_kernel_args(planes, tables, spec, n_windows, stride, _one_tile_each(n_windows, spec.width)),
        val.data_ptr(), idx.data_ptr(), _stream(planes),
    )
    waterfall_search.launches += 1
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
    grid = scan_grid(s, n_windows, w)
    partial = torch.empty((3, s, grid[1], w), dtype=torch.float32, device=planes.device)
    out = torch.empty((3, s, w), dtype=torch.float32, device=planes.device)
    library().call(
        "qt_waterfall_scan",
        *_kernel_args(planes, tables, spec, n_windows, stride, grid),
        float(threshold), partial.data_ptr(), out.data_ptr(), _stream(planes),
    )
    waterfall_scan.launches += 1
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
