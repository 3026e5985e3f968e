"""Row means and exclusive prefix sums in a fixed order: the trailing
stages' reductions (``stream.DcBlock``, ``stream.Agc``).

The JAX package takes the stages' trailing sums from ``jnp.cumsum``
(``quadrs_tpu/stream.py:317``, ``:367``), XLA code with no Pallas kernel.
On the card torch's ``cumsum`` and row ``mean`` choose their blocking by
the tensor's shape, so a window's samples would move with the windows
batched beside it.  On a CUDA tensor :func:`row_mean` and
:func:`row_exclusive_prefix` launch the hand-written kernels of
``csrc/rowscan.cu``, whose order of additions is fixed by the row length
alone; on a CPU tensor they run :func:`row_mean_reference` and
:func:`row_exclusive_prefix_reference`, the plain PyTorch versions, so the
stages' CPU outputs are what they were (the CPU's ``cumsum`` adds each row
in sequence; its ``mean`` of a lone row of 32k elements or more splits
across threads, ROADMAP C10).  A CUDA tensor never reaches a plain version
through these entry points, and no failure falls back to one.

A row is f32, or complex64 taken as interleaved (re, im) f32 pairs, each
summed on its own.  The kernel's sums are not the plain version's: the
CPU's ``cumsum`` adds in sequence, the kernel in tiles of :data:`TILE`
(``csrc/rowscan.cu`` says in what order).
"""

from __future__ import annotations

import torch

from quadrs_tpu_torch.ops._cuda import count_launch

TILE = 4096  # elements a tile: csrc/rowscan.cu's kTile, checked by the kernel

_CHANNELS = {torch.float32: 1, torch.complex64: 2}


def _check(x: torch.Tensor, sub: torch.Tensor | None = None) -> None:
    """Raise unless ``x`` is a (B, L) f32 or complex64 tensor with B >= 1
    and L >= 1, contiguous on a CUDA device, and ``sub`` (when given) a
    (B, 1) tensor of ``x``'s dtype on ``x``'s device (contiguity only where
    the kernel reads the rows flat)."""
    if x.dtype not in _CHANNELS:
        raise ValueError(f"row scans take float32 or complex64 rows, got {x.dtype}")
    if x.dim() != 2 or x.shape[0] < 1 or x.shape[1] < 1:
        raise ValueError(f"row scans take (B, L) rows with B >= 1 and L >= 1, got {tuple(x.shape)}")
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"row scans run on cuda or cpu, got {x.device}")
    if x.is_cuda and not x.is_contiguous():
        raise ValueError(f"the row-scan kernels take contiguous rows, got strides {x.stride()}")
    if sub is not None and (
        sub.dtype != x.dtype
        or sub.device != x.device
        or tuple(sub.shape) != (x.shape[0], 1)
        or (x.is_cuda and not sub.is_contiguous())
    ):
        raise ValueError(
            f"sub must be a contiguous {x.dtype} ({x.shape[0]}, 1) tensor on {x.device}, got "
            f"{(tuple(sub.shape), sub.dtype, sub.device)}"
        )


def _scratch(x: torch.Tensor, copies: int) -> torch.Tensor:
    """``copies`` (B, tiles, channels) f32 arrays of per-tile scratch."""
    tiles = -(-x.shape[1] // TILE)
    return torch.empty((copies, x.shape[0], tiles, _CHANNELS[x.dtype]), dtype=torch.float32, device=x.device)


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def row_mean_reference(x: torch.Tensor) -> torch.Tensor:
    """The plain version of :func:`row_mean`: torch's own mean."""
    return x.mean(dim=1, keepdim=True)


def row_exclusive_prefix_reference(v: torch.Tensor, sub: torch.Tensor | None = None) -> torch.Tensor:
    """The plain version of :func:`row_exclusive_prefix`: a zero column,
    then torch's own ``cumsum`` of ``v - sub``."""
    if sub is not None:
        v = v - sub
    return torch.cat([torch.zeros_like(v[:, :1]), torch.cumsum(v, dim=1)], dim=1)


def row_mean(x: torch.Tensor) -> torch.Tensor:
    """(B, 1) mean of each row of a (B, L) f32 or complex64 ``x``.  On a
    CUDA tensor kernel ``qt_row_sum`` (:attr:`launches` counts its
    launches), then a division by L; on a CPU tensor the plain version."""
    _check(x)
    if not x.is_cuda:
        return row_mean_reference(x)
    from quadrs_tpu_torch.ops._cuda import library

    rows, n = x.shape
    sums = torch.empty((rows, 1), dtype=x.dtype, device=x.device)
    scratch = _scratch(x, 1)
    library().call(
        "qt_row_sum", _CHANNELS[x.dtype], x.device.index, x.data_ptr(), rows, n, TILE,
        scratch.data_ptr(), sums.data_ptr(), _stream(x),
    )
    count_launch(row_mean)
    (torch.view_as_real(sums) if sums.is_complex() else sums).div_(n)
    return sums


row_mean.launches = 0


def row_exclusive_prefix(v: torch.Tensor, sub: torch.Tensor | None = None) -> torch.Tensor:
    """(B, L + 1) exclusive prefix sums of each row of ``v - sub``: column 0
    is 0, column j + 1 the sum of the row's first j + 1 values.  ``v``: a
    (B, L) f32 or complex64 tensor; ``sub``: an optional (B, 1) value a row
    of its dtype, subtracted as the rows load.  On a CUDA tensor kernel
    ``qt_row_exclusive_prefix`` (:attr:`launches` counts its launches); on
    a CPU tensor the plain version."""
    _check(v, sub)
    if not v.is_cuda:
        return row_exclusive_prefix_reference(v, sub)
    from quadrs_tpu_torch.ops._cuda import library

    rows, n = v.shape
    out = torch.empty((rows, n + 1), dtype=v.dtype, device=v.device)
    scratch = _scratch(v, 2)
    library().call(
        "qt_row_exclusive_prefix", _CHANNELS[v.dtype], v.device.index, v.data_ptr(), rows, n,
        0 if sub is None else sub.data_ptr(), TILE, scratch[0].data_ptr(), scratch[1].data_ptr(),
        out.data_ptr(), _stream(v),
    )
    count_launch(row_exclusive_prefix)
    return out


row_exclusive_prefix.launches = 0
