"""Constellation plot: a PSK burst's synchronized symbol decisions as a
PNG (``psk -plot``).

The counterpart of ``quadrs_tpu.viz.constellation``: numpy
rasterization, the file through :mod:`quadrs_tpu_torch.utils.png`.  The
canvas is a square IQ plane: axes cross at the origin, symbols accumulate
into a 2-D histogram (brightness saturates with density, eui's blue map),
and the ideal ``order``-th roots of unity, scaled to the median symbol
magnitude, are drawn as crosshair markers.  A tight blue cluster on each
marker is a healthy burst; smears are residual carrier offset, rings are
timing error."""

from __future__ import annotations

from pathlib import Path

import numpy as np

from quadrs_tpu_torch.utils.png import write_png

SIZE = 256
_AXIS_RGB = (70, 70, 70)
_MARK_RGB = (255, 160, 60)
_MARK_HALF = 3  # crosshair half-length in px


def constellation_render(sym: np.ndarray, order: int) -> np.ndarray:
    """Rasterize synchronized symbols: returns ``(SIZE, SIZE, 3)`` u8."""
    sym = np.asarray(sym)
    if len(sym) == 0:
        raise ValueError("no symbols to plot")
    img = np.zeros((SIZE, SIZE, 3), dtype=np.uint8)
    half = SIZE // 2
    img[half, :, :] = _AXIS_RGB
    img[:, half, :] = _AXIS_RGB

    med = float(np.median(np.abs(sym)))
    scale = (0.38 * SIZE) / max(med, 1e-12)  # the ideal ring at ~0.76 of half

    def to_px(re: np.ndarray, im: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        col = np.clip(np.round(half + re * scale), 0, SIZE - 1).astype(np.int64)
        row = np.clip(np.round(half - im * scale), 0, SIZE - 1).astype(np.int64)
        return row, col

    row, col = to_px(np.real(sym), np.imag(sym))
    counts = np.zeros((SIZE, SIZE), dtype=np.int64)
    np.add.at(counts, (row, col), 1)
    # density -> blue brightness, saturating: one hit is already visible
    blue = np.clip(counts * 64, 0, 255).astype(np.uint8)
    hit = counts > 0
    img[..., 2] = np.where(hit, blue, img[..., 2])
    img[..., 0] = np.where(hit, np.minimum(blue // 4, 255), img[..., 0])

    # the ideal constellation's markers at the median magnitude
    ang = 2.0 * np.pi * np.arange(order) / order
    mr, mc = to_px(med * np.cos(ang), med * np.sin(ang))
    for r, c in zip(mr, mc):
        lo_c, hi_c = max(0, c - _MARK_HALF), min(SIZE, c + _MARK_HALF + 1)
        lo_r, hi_r = max(0, r - _MARK_HALF), min(SIZE, r + _MARK_HALF + 1)
        img[r, lo_c:hi_c, :] = _MARK_RGB
        img[lo_r:hi_r, c, :] = _MARK_RGB
    return img


def constellation_render_file(sym: np.ndarray, order: int, path: str | Path, overwrite: bool = False) -> Path:
    """Write the constellation PNG at ``path``, refusing to clobber unless
    ``overwrite``, like every other writer."""
    return write_png(path, constellation_render(sym, order), overwrite=overwrite)
