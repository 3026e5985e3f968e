"""Survey plot: a :class:`~quadrs_tpu_torch.stream_runner.ScanResult` as a
PNG, the visual end of the rtl_power workflow (``scan -plot``).

The counterpart of ``quadrs_tpu.viz.survey``: numpy rasterization, the
file through :mod:`quadrs_tpu_torch.utils.png`.  One image a stream, one
pixel column a fftshifted bin:

* the spectrum panel: per-bin average power in dB (20·log10 of the
  magnitude) as a filled area, the per-bin maximum as a dimmer fill above
  it, a gray column at DC (the band centre);
* a 1-px separator row;
* the occupancy strip: the fraction of windows above the scan threshold,
  in eui's blue map.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from quadrs_tpu_torch.utils.png import write_png

SPECTRUM_H = 200
STRIP_H = 24

_AVG_RGB = (80, 200, 255)
_MAX_RGB = (120, 100, 60)
_DC_RGB = (70, 70, 70)


def _to_db(v: np.ndarray) -> np.ndarray:
    return 20.0 * np.log10(np.maximum(v, 1e-30))


def survey_render(avg: np.ndarray, max_norms: np.ndarray, occupancy: np.ndarray) -> np.ndarray:
    """Rasterize one stream's survey: ``avg``/``max_norms``/``occupancy``
    are (width,) per-bin arrays; returns (H, width, 3) u8."""
    width = avg.shape[0]
    a_db = _to_db(np.asarray(avg, dtype=np.float64))
    m_db = _to_db(np.asarray(max_norms, dtype=np.float64))
    lo = float(a_db.min())
    hi = float(m_db.max())
    span = max(hi - lo, 1e-9)

    def rows_of(db: np.ndarray) -> np.ndarray:
        # dB -> pixel row (0 = top); full scale is the panel's height
        frac = (db - lo) / span
        return (SPECTRUM_H - 1 - np.round(frac * (SPECTRUM_H - 1))).astype(np.int64)

    img = np.zeros((SPECTRUM_H + 1 + STRIP_H, width, 3), dtype=np.uint8)
    cols = np.arange(width)
    # the DC marker, in the spectrum panel only: the strip stays a pure blue map
    img[:SPECTRUM_H, width // 2, :] = _DC_RGB
    r = np.arange(SPECTRUM_H)[:, None]
    # the max fills dimly from its curve down; the average brightly
    m_mask = r >= rows_of(m_db)[None, :]
    a_mask = r >= rows_of(a_db)[None, :]
    for c, val in enumerate(_MAX_RGB):
        img[:SPECTRUM_H, :, c] = np.where(m_mask, val, img[:SPECTRUM_H, :, c])
    for c, val in enumerate(_AVG_RGB):
        img[:SPECTRUM_H, :, c] = np.where(a_mask, val, img[:SPECTRUM_H, :, c])
    img[SPECTRUM_H, :, :] = 40  # separator
    # the occupancy strip: eui's blue map of the [0, 1] fraction
    blue = np.clip(np.asarray(occupancy, dtype=np.float64) * 256.0, 0, 255)
    img[SPECTRUM_H + 1 :, cols, 2] = blue.astype(np.uint8)[None, :]
    return img


def survey_render_file(result, stream: int, path: str | Path, overwrite: bool = False) -> Path:
    """Write stream ``stream`` of a ScanResult as a PNG at ``path``, refusing
    to clobber unless ``overwrite``, like every other writer."""
    img = survey_render(result.avg[stream], result.max_norms[stream], result.occupancy[stream])
    return write_png(path, img, overwrite=overwrite)
