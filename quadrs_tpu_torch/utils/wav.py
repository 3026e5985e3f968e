"""Minimal RIFF/WAVE writer for demodulated audio: a copy of
``quadrs_tpu.utils.wav`` (``wav_bytes``, ``write_wav``, ``read_wav_f32``),
kept here because the port imports nothing of the JAX package.

The audio commands' native output is raw mono LE f32
(``{prefix}.sr{rate}.f32``); ``-wav yes`` wraps the same samples in a
WAVE_FORMAT_IEEE_FLOAT (format tag 3) container so any player opens it
directly.  Non-PCM WAVs carry a ``fact`` chunk with the frame count, as
the spec asks.  The stdlib's ``wave`` writes integer PCM only, hence the
hand-built header.
"""

from __future__ import annotations

import struct

import numpy as np


def wav_bytes(rate: int, samples: np.ndarray) -> bytes:
    """Mono 32-bit-float WAVE file content for ``samples`` at ``rate``."""
    if rate <= 0:
        raise ValueError("sample rate must be positive")
    data = np.ascontiguousarray(samples, dtype="<f4").tobytes()
    fmt = struct.pack(
        "<HHIIHH",
        3,  # WAVE_FORMAT_IEEE_FLOAT
        1,  # channels
        rate,
        rate * 4,  # byte rate
        4,  # block align
        32,  # bits per sample
    )
    fact = struct.pack("<I", len(data) // 4)
    body = (
        b"WAVE"
        + b"fmt " + struct.pack("<I", len(fmt)) + fmt
        + b"fact" + struct.pack("<I", len(fact)) + fact
        + b"data" + struct.pack("<I", len(data)) + data
    )
    return b"RIFF" + struct.pack("<I", len(body)) + body


def write_wav(path: str, rate: int, samples: np.ndarray, overwrite: bool = False) -> str:
    """Write ``samples`` as a mono float32 WAV; returns ``path``."""
    with open(path, "wb" if overwrite else "xb") as fh:
        fh.write(wav_bytes(rate, samples))
    return path


def read_wav_f32(path: str) -> tuple[int, np.ndarray]:
    """Parse a mono float32 WAV written by :func:`write_wav` (tests and
    round-trips; not a general WAV reader): ``(rate, samples)``."""
    with open(path, "rb") as fh:
        raw = fh.read()
    if raw[:4] != b"RIFF" or raw[8:12] != b"WAVE":
        raise ValueError("not a RIFF/WAVE file")
    pos, rate, data = 12, None, None
    while pos + 8 <= len(raw):
        tag = raw[pos : pos + 4]
        (size,) = struct.unpack_from("<I", raw, pos + 4)
        if tag == b"fmt ":
            tag_fmt, ch, rate, _, _, bits = struct.unpack_from("<HHIIHH", raw, pos + 8)
            if (tag_fmt, ch, bits) != (3, 1, 32):
                raise ValueError("not mono float32")
        elif tag == b"data":
            data = np.frombuffer(raw, dtype="<f4", count=size // 4, offset=pos + 8)
        pos += 8 + size + (size & 1)
    if rate is None or data is None:
        raise ValueError("missing fmt/data chunk")
    return rate, data
