"""Waterfall renderers: the reference GUIs' images as PNG files.

The counterpart of ``quadrs_tpu.viz.waterfall``.  The reference ships two
OpenGL desktop waterfalls; a server has no display, so the same render
engines write PNGs instead:

* :func:`ui_render` mirrors the legacy conrod GUI's ``render``
  (``src/ui/mod.rs:294-412``): stride-1 STFT, one column a window,
  wrapping into row bands every ``stretch*fft_width + 16`` px, the HSV map
  ``hue=(1-mag/2.29)*0.8*360°, sat=1, val=mag/2.29``
  (``src/ui/mod.rs:351-372``), a black separator column every ``stride``
  windows.
* :func:`eui_render` mirrors the egui GUI's render
  (``src/eui/mod.rs:86-113``): the Blackman-Harris ``take_fft`` over a
  percentage slice of the file, 2048 rows, the blue map ``b =
  saturate(mag/10*256)`` (``src/eui/mod.rs:103-106``).

The STFT runs on the device through the Executor; the colour maps run
on the host in numpy, as in the JAX package; files go through
:mod:`quadrs_tpu_torch.utils.png` (no Pillow).
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from quadrs_tpu_torch.ops.stft import stft_norms
from quadrs_tpu_torch.runtime import Executor, stream_batches
from quadrs_tpu_torch.sinks import take_fft
from quadrs_tpu_torch.sources import SampleSource
from quadrs_tpu_torch.stream import Stream
from quadrs_tpu_torch.utils.png import write_png
from quadrs_tpu_torch.utils.sniff import guess_details


@dataclass
class UiParams:
    """Defaults per ``src/ui/mod.rs:71-77`` (window size :26-27)."""

    width: int = 800
    height: int = 600
    fft_width: int = 8
    stride: int = 1
    stretch: int = 4


def _hsv_to_rgb_u8(scaled: np.ndarray) -> np.ndarray:
    """The legacy GUI colour map: scaled magnitude in [0, ~1] -> (r, g, b).

    hue = (1-scaled)*0.8*360 deg, sat = 1, value = scaled, then ``(channel *
    256) as u8`` with Rust's saturating cast.
    """
    inv = 1.0 - scaled
    h = (inv * 0.8 * 360.0) % 360.0
    v = 1.0 - inv
    c = v  # chroma = v * s, s = 1
    hp = h / 60.0
    x = c * (1.0 - np.abs(hp % 2.0 - 1.0))
    z = np.zeros_like(c)
    sector = np.floor(hp).astype(np.int32) % 6
    r = np.choose(sector, [c, x, z, z, x, c])
    g = np.choose(sector, [x, c, c, x, z, z])
    b = np.choose(sector, [z, z, x, c, c, x])
    rgb = np.stack([r, g, b], axis=-1)
    return np.clip(rgb * 256.0, 0, 255).astype(np.uint8)


def blue_map(norms: np.ndarray) -> np.ndarray:
    """eui's blue channel: ``(mag/10*256) as u8`` with Rust's saturating
    cast (``src/eui/mod.rs:103-106``)."""
    return np.clip(norms / 10.0 * 256.0, 0, 255).astype(np.uint8)


def ui_norms(stream: Stream, params: UiParams | None = None, *, device: torch.device | str) -> np.ndarray:
    """The (n_windows, fft_width) f32 fftshifted norms :func:`ui_render`
    paints: stride-1 windows until the canvas's last row band."""
    p = params or UiParams()
    w, h = p.width, p.height
    if w <= p.fft_width:
        raise ValueError("window too narrow")
    if p.stretch <= 0:
        raise ValueError("negative stretching")
    row_height = p.stretch * p.fft_width + 16
    samples_available = stream.length - p.fft_width
    if samples_available <= 0:
        raise ValueError("input shorter than fft width")
    # columns fill left to right, then wrap to the next row band; stop when
    # the band start passes the canvas (src/ui/mod.rs:325-331)
    max_bands = h // row_height + 1
    n_windows = int(min(samples_available, w * max_bands))
    offsets = np.arange(n_windows, dtype=np.int64)
    batch, batches = stream_batches(stream, offsets, p.fft_width)
    ex = Executor(stream, p.fft_width, device, batch=batch, post=stft_norms)
    norms_all = []
    for _, norms, valid in ex.run_each(batches):
        if not np.all(valid == p.fft_width):
            raise RuntimeError("read-exact messed up in ui render")
        norms_all.append(norms)
    return np.concatenate(norms_all, axis=0)


def ui_paint(norms: np.ndarray, params: UiParams | None = None) -> tuple[np.ndarray, float, float]:
    """The legacy GUI's canvas from :func:`ui_norms`' rows: (H, W, 3) u8 and
    the (min, max) observed scaled magnitudes (the reference prints these,
    ``src/ui/mod.rs:409``)."""
    p = params or UiParams()
    w, h = p.width, p.height
    n_windows = norms.shape[0]
    img = np.zeros((h, w, 3), dtype=np.uint8)
    row_height = p.stretch * p.fft_width + 16

    scaled = norms / np.float32(2.29)
    obs_min = float(min(scaled.min(initial=99.0), 99.0))
    obs_max = float(max(scaled.max(initial=0.0), 0.0))

    colors = _hsv_to_rgb_u8(scaled.astype(np.float64))  # (n, fw, 3)
    # a black separator column every `stride` windows (src/ui/mod.rs:374-376)
    colors[:: p.stride, :, :] = 0

    cols = np.arange(n_windows)
    ox = cols % w
    oy = (cols // w) * row_height
    # each fft bin o paints `stretch` pixels from oy + o*stretch; the
    # framebuffer's y axis runs bottom up (src/ui/mod.rs:286-291), so the
    # image row is h - 1 - y
    for o in range(p.fft_width):
        for off in range(p.stretch):
            y = oy + o * p.stretch + off
            ok = y < h
            img[h - 1 - y[ok], ox[ok]] = colors[ok, o]
    return img, obs_min, obs_max


def ui_render(stream: Stream, params: UiParams | None = None, *, device: torch.device | str) -> tuple[np.ndarray, float, float]:
    """Render the legacy-GUI waterfall: (H, W, 3) u8 and the (min, max)
    observed scaled magnitudes."""
    return ui_paint(ui_norms(stream, params, device=device), params)


def ui_render_file(stream: Stream, path: str | Path = "ui.png", params: UiParams | None = None, *,
                   device: torch.device | str) -> Path:
    img, obs_min, obs_max = ui_render(stream, params, device=device)
    print(f"{obs_min} {obs_max}")
    return write_png(path, img)


def ui_render_frames(stream: Stream, n_frames: int, path_prefix: str | Path = "ui", params: UiParams | None = None, *,
                     device: torch.device | str) -> list[Path]:
    """A parameter sweep standing in for the interactive loop: the legacy
    GUI re-renders on every parameter change (``src/ui/mod.rs:235-258``)
    and its fft+ button doubles ``fft_width`` (``:140-160``), so frame ``k``
    renders at ``fft_width * 2**k``, as ``{prefix}{k:03d}.png``."""
    if n_frames < 1:
        raise ValueError("need at least one frame")
    p = params or UiParams()
    paths: list[Path] = []
    for k in range(n_frames):
        fw = p.fft_width << k
        if k > 0 and fw >= min(stream.length, p.width):
            break  # the GUI would refuse this click; frame 0 raises instead
        frame = UiParams(width=p.width, height=p.height, fft_width=fw, stride=p.stride, stretch=p.stretch)
        img, obs_min, obs_max = ui_render(stream, frame, device=device)
        print(f"{obs_min} {obs_max}")
        paths.append(write_png(f"{path_prefix}{k:03d}.png", img))
    return paths


@dataclass
class EuiParams:
    """Defaults per ``src/eui/mod.rs:62-70``: 46%..46.3% of the file, a
    512-wide Blackman-Harris FFT, 2048 rows (:87)."""

    start_pct: float = 46.0
    end_pct: float = 46.3
    fft_width: int = 512
    rows: int = 2048


def eui_slice(length: int, p: EuiParams) -> tuple[int, int]:
    """The percentage slice's sample bounds, in f32 products as the
    reference computes them (``src/eui/mod.rs:91-92``)."""
    start = int(np.float32(length) * np.float32(p.start_pct) / np.float32(100.0))
    end = int(np.float32(length) * np.float32(p.end_pct) / np.float32(100.0))
    return start, end


def eui_render(stream: Stream, params: EuiParams | None = None, *, device: torch.device | str) -> np.ndarray:
    """Render the egui waterfall: (rows, fft_width, 3) u8."""
    p = params or EuiParams()
    res = take_fft(stream, eui_slice(stream.length, p), p.fft_width, p.rows, windowing="blackman-harris", device=device)
    img = np.zeros((res.output_len, p.fft_width, 3), dtype=np.uint8)
    img[:, :, 2] = blue_map(res.norms)
    return img


def _eui_source(filename) -> SampleSource:
    """eui reopens the file itself by sniffing its name (``src/eui/mod.rs:31-36``)."""
    if filename is None:
        raise ValueError("filename currently required")
    return SampleSource.from_file(str(filename), guess_details(str(filename)))


def eui_render_file(filename: str | Path | None, path: str | Path = "eui.png", params: EuiParams | None = None, *,
                    device: torch.device | str) -> Path:
    stream = _eui_source(filename)
    return write_png(path, eui_render(stream, params, device=device))


def eui_render_frames(filename: str | Path | None, n_frames: int, path_prefix: str | Path = "eui",
                      params: EuiParams | None = None, *, device: torch.device | str) -> list[Path]:
    """A scrolling render standing in for the slider loop (the egui GUI
    re-renders as the start and end sliders move, ``src/eui/mod.rs:154-161``):
    frame ``k`` moves the slice on by its own span, as
    ``{prefix}{k:03d}.png``, until the slice reaches the end of the file."""
    if filename is None:
        raise ValueError("filename currently required")
    if n_frames < 1:
        raise ValueError("need at least one frame")
    p = params or EuiParams()
    span = p.end_pct - p.start_pct
    if span <= 0:
        raise ValueError("end must be after start")
    stream = _eui_source(filename)
    paths: list[Path] = []
    for k in range(n_frames):
        start = p.start_pct + k * span
        end = start + span
        if end >= 100.0:
            # the right slider stop: end_pct=100 maps to end_sample == len,
            # which take_fft refuses (the reference asserts end < len)
            break
        frame = EuiParams(start_pct=start, end_pct=end, fft_width=p.fft_width, rows=p.rows)
        paths.append(write_png(f"{path_prefix}{k:03d}.png", eui_render(stream, frame, device=device)))
    return paths
