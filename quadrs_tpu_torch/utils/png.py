"""A PNG writer and reader for 8-bit RGB images, with the standard library.

The JAX package saves its images through Pillow; this package needs no
Pillow.  :func:`write_png` writes colour type 2 (RGB, 8 bits a channel),
filter 0 on every row, one zlib-compressed ``IDAT`` chunk and CRCs from
``zlib.crc32``.  Its contract is the pixels: a PNG decoder gives back the
array that was written, whatever bytes another encoder would choose.
:func:`read_png` reads the files :func:`write_png` writes (and any
non-interlaced 8-bit RGB PNG whose rows use filter 0).
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunk(kind: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF)


def png_bytes(img: np.ndarray) -> bytes:
    """``img``: an (H, W, 3) uint8 array; returns the PNG file's bytes."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"PNG writer takes (H, W, 3) uint8, got {img.dtype} {img.shape}")
    h, w, _ = img.shape
    rows = np.zeros((h, 1 + 3 * w), dtype=np.uint8)  # filter byte 0 a row
    rows[:, 1:] = img.reshape(h, 3 * w)
    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return _SIGNATURE + _chunk(b"IHDR", header) + _chunk(b"IDAT", zlib.compress(rows.tobytes())) + _chunk(b"IEND", b"")


def write_png(path: str | Path, img: np.ndarray, overwrite: bool = True) -> Path:
    """Write ``img`` as a PNG at ``path``; with ``overwrite=False`` the file
    is opened ``"xb"`` and an existing one raises ``FileExistsError``."""
    path = Path(path)
    data = png_bytes(img)
    with open(path, "wb" if overwrite else "xb") as fh:
        fh.write(data)
    return path


def read_png(path: str | Path) -> np.ndarray:
    """The (H, W, 3) uint8 pixels of an 8-bit RGB PNG with filter-0 rows."""
    data = Path(path).read_bytes()
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG")
    pos, header, idat = 8, None, []
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos : pos + 4])
        kind, body = data[pos + 4 : pos + 8], data[pos + 8 : pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n : pos + 12 + n])
        if zlib.crc32(kind + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"{path}: bad CRC in a {kind.decode()} chunk")
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        pos += 12 + n
    if header is None or header[2:] != (8, 2, 0, 0, 0):
        raise ValueError(f"{path}: not a non-interlaced 8-bit RGB PNG")
    w, h = header[:2]
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), dtype=np.uint8).reshape(h, 1 + 3 * w)
    if np.any(rows[:, 0]):
        raise ValueError(f"{path}: a row uses a filter other than 0")
    return rows[:, 1:].reshape(h, w, 3).copy()
