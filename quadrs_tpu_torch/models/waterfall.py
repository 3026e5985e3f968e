"""Batched multi-stream waterfall: many captures, one program per chunk.

The PyTorch counterpart of ``quadrs_tpu.models.waterfall`` (BASELINE
config 5: "64 parallel cs8 IQ streams, fused decode + 1024-pt strided
STFT spectrogram search").  Every stream decodes on the device and goes
through one batched windowing + DFT, with an optional per-window peak or
per-bin survey reduction: the hand-written kernels of
:mod:`quadrs_tpu_torch.ops.waterfall` on the card, their plain versions
elsewhere.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from quadrs_tpu_torch.formats import FileFormat
from quadrs_tpu_torch.ops import waterfall as wf


@dataclass(frozen=True)
class WaterfallConfig:
    n_streams: int = 64
    fft_width: int = 1024
    stride: int = 1024
    fmt: FileFormat = FileFormat.COMPLEX_INT8
    windowing: str = "rectangular"  # or "blackman-harris"


class WaterfallModel(nn.Module):
    def __init__(self, cfg: WaterfallConfig):
        super().__init__()
        self.cfg = cfg
        self.load_reference_arrays({"window": wf.plan_window(self.spec)})

    @property
    def spec(self) -> wf.WaterfallSpec:
        return wf.WaterfallSpec(fmt=self.cfg.fmt, width=self.cfg.fft_width, windowing=self.cfg.windowing)

    def load_reference_arrays(self, arrays: dict[str, np.ndarray | None]) -> None:
        """Install the window from host arrays: ``window`` is the JAX
        model's ``window`` ((fft_width,) f32, or None when rectangular).
        The buffer lands on the device the model is on."""
        window = arrays["window"]
        if (window is None) != (not wf.windowed(self.cfg.windowing)):
            raise ValueError(f"a {self.cfg.windowing} model takes window={'None' if window is None else 'an array'}")
        device = self.window.device if getattr(self, "window", None) is not None else None
        if window is not None:
            window = np.asarray(window)
            if window.shape != (self.cfg.fft_width,) or window.dtype != np.float32:
                raise ValueError(f"window must be f32 ({self.cfg.fft_width},), got {window.dtype} {window.shape}")
            window = torch.tensor(window, device=device)
        self.register_buffer("window", window)
        self._planned = None  # the planned tables, on first use on the planes' device

    def kernel_supported(self) -> bool:
        """The kernels take 128*b-bin windows (2 <= b <= 64) at any stride."""
        return wf.supported(self.cfg.fft_width)

    def _use_kernel(self, raw: torch.Tensor) -> bool:
        """The kernel for a CUDA tensor within its envelope, the plain
        chain otherwise (the JAX model's ``auto``, CUDA in the TPU's
        place)."""
        return raw.is_cuda and self.kernel_supported()

    def _tables(self, device) -> wf.WaterfallTables:
        if self._planned is None or self._planned.twiddles.device != device:
            self._planned = wf.waterfall_tables(self.spec, device=device)
        return wf.WaterfallTables(self._planned.twiddles, self.window, self._planned.decode)

    def n_windows(self, n: int) -> int:
        cfg = self.cfg
        return (n - cfg.fft_width) // cfg.stride + 1

    def step(self, raw: torch.Tensor) -> torch.Tensor:
        """(S, 2, n) native planes -> (S, windows, fft_width) f32 norms."""
        nw, stride = self.n_windows(raw.shape[-1]), self.cfg.stride
        if self._use_kernel(raw):
            return wf.fused_waterfall(raw, self.spec, nw, stride=stride, tables=self._tables(raw.device))
        return wf.fused_waterfall_reference(raw, self.spec, nw, stride=stride, window=self.window)

    def search(self, raw: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """Per (stream, window) the fftshifted peak bin (int32) and its f32
        magnitude; through the kernel the spectrogram never reaches device
        memory.  A window holding a NaN gives bin fft_width-1 on every
        route (the TPU kernel's contract)."""
        nw, stride = self.n_windows(raw.shape[-1]), self.cfg.stride
        if self._use_kernel(raw):
            return wf.fused_waterfall_search(raw, self.spec, nw, stride=stride, tables=self._tables(raw.device))
        return wf.fused_waterfall_search_reference(raw, self.spec, nw, stride=stride, window=self.window)

    def scan(self, raw: torch.Tensor, threshold) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Band-survey step: per (stream, fftshifted bin) the sum, max and
        count above ``threshold`` of the window norms, each (S, width)
        f32."""
        nw, stride = self.n_windows(raw.shape[-1]), self.cfg.stride
        if self._use_kernel(raw):
            return wf.fused_waterfall_scan(
                raw, self.spec, nw, threshold, stride=stride, tables=self._tables(raw.device)
            )
        return wf.fused_waterfall_scan_reference(raw, self.spec, nw, threshold, stride=stride, window=self.window)

    def synth_raw(self, n: int, seed: int = 0) -> np.ndarray:
        from quadrs_tpu_torch.formats import synth_planes

        return synth_planes(self.cfg.fmt, n, seed, n_streams=self.cfg.n_streams)
