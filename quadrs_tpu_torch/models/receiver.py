"""The receiver chain: decode -> NCO mix -> FIR decimate -> STFT.

The PyTorch counterpart of ``quadrs_tpu.models.receiver``, streaming
mode only: a raw capture chunk in its native narrow dtype goes through
the fused frontend (:mod:`quadrs_tpu_torch.ops.frontend`: the CUDA
kernels on the card, their plain version on the CPU) and comes out as
fftshifted spectrogram magnitudes.

The model holds no learned weights.  Its state is the f32 taps and the
host-planned phase tables, registered as buffers so ``.to(device)``
moves them; phases themselves are planned on the host per chunk
(:meth:`PipelineModel.stream_bases`).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from quadrs_tpu_torch.formats import FileFormat
from quadrs_tpu_torch.ops import frontend as fe
from quadrs_tpu_torch.ops.fir import lowpass_taps
from quadrs_tpu_torch.ops.nco import ExactNCO
from quadrs_tpu_torch.ops.stft import stft_norms

# the ROADMAP items that port the chains outside the fused envelope
OUTSIDE_ENVELOPE = "ROADMAP A3-A4 (the spectral os_poly and XLA FIR chains)"


@dataclass(frozen=True)
class PipelineConfig:
    """The stream chain: shift -> lowpass(decimate) -> STFT."""

    sample_rate: int = 21_000_000
    shift_freq: int = 280_000
    lp_freq: int = 200_000
    decimate: int = 32
    taps: int = 400
    fft_width: int = 64
    fmt: FileFormat = FileFormat.COMPLEX_FLOAT32


class PipelineModel(nn.Module):
    def __init__(self, cfg: PipelineConfig):
        super().__init__()
        self.cfg = cfg
        self._nco = ExactNCO(cfg.shift_freq, cfg.sample_rate)
        self.load_reference_arrays(
            {"taps": lowpass_taps(cfg.lp_freq / cfg.sample_rate, cfg.taps)}
        )

    def load_reference_arrays(self, arrays: dict[str, np.ndarray]) -> None:
        """Install the model's state from host arrays: ``taps`` (the f32
        filter), and optionally the planner's ``hp``, ``cdm``, ``sdm``,
        ``cdh`` and ``sdh`` (as the JAX package's ``_plan_t`` returns
        them); tables not given are planned from the taps.  The buffers
        land on the device the model is on."""
        taps = np.asarray(arrays["taps"], dtype=np.float32)
        if taps.shape != (self.cfg.taps,):
            raise ValueError(f"taps must have shape ({self.cfg.taps},), got {taps.shape}")
        device = self.taps.device if hasattr(self, "taps") else None
        self._taps_np = taps.copy()
        self.register_buffer("taps", torch.tensor(taps, device=device))
        if not self.fused_supported():
            return
        spec = self.frontend_spec
        planned = dict(zip(("hp", "cdm", "sdm", "cdh", "sdh"), fe._plan_t(spec)[2:]))
        for name, want in planned.items():
            got = arrays.get(name)
            if got is not None and (got.shape != want.shape or got.dtype != want.dtype):
                raise ValueError(
                    f"{name} must be {want.dtype} {want.shape}, got {got.dtype} {got.shape}"
                )
        a = {k: np.asarray(arrays.get(k, v)) for k, v in planned.items()}
        bufs = {
            "hp": a["hp"],
            "tab_cos": fe.sample_order(a["cdm"], a["cdh"]),
            "tab_sin": fe.sample_order(a["sdm"], a["sdh"]),
        }
        if fe.stft_fusable(self.cfg.fft_width):
            bufs["stft_cos"], bufs["stft_sin"] = fe.stft_twiddles(self.cfg.fft_width)
        for name, value in bufs.items():
            self.register_buffer(name, torch.tensor(value, device=device))

    # -- host-side exact phase planning (shared ExactNCO invariant) --------
    def theta0(self, offs: np.ndarray) -> np.ndarray:
        return self._nco.angles(offs)

    @property
    def frontend_spec(self) -> fe.FrontendSpec:
        return fe.FrontendSpec(
            fmt=self.cfg.fmt,
            sample_rate=self.cfg.sample_rate,
            shift_freq=self.cfg.shift_freq,
            decimate=self.cfg.decimate,
            taps_bytes=self._taps_np.tobytes(),
        )

    def fused_supported(self) -> bool:
        """The fused frontend's envelope: 1 <= decimate <= 64 and at most
        128 polyphase subfilters.  Outside it the port has no route yet
        (:data:`OUTSIDE_ENVELOPE`)."""
        m_sub = -(-self.cfg.taps // self.cfg.decimate)
        return fe.supported_t(self.cfg.decimate) and m_sub <= 128

    def require_fused(self) -> None:
        """Raise ``NotImplementedError`` outside :meth:`fused_supported`."""
        if not self.fused_supported():
            raise NotImplementedError(
                f"decimate {self.cfg.decimate} with {self.cfg.taps} taps is outside the fused "
                f"frontend's envelope; the chains for it are {OUTSIDE_ENVELOPE}, not yet ported"
            )

    def frontend_tables(self) -> fe.FrontendTables:
        """The model's buffers as the frontend's tables."""
        return fe.FrontendTables(
            self.hp, self.tab_cos, self.tab_sin,
            getattr(self, "stft_cos", None), getattr(self, "stft_sin", None),
        )

    def stream_bases(self, global_start: int, n_chunk: int) -> np.ndarray:
        """Host-exact per-tile NCO bases for :meth:`step_stream_fused` of
        a chunk whose first sample sits at absolute ``global_start``."""
        cfg = self.cfg
        # whole STFT windows only, as step_stream_fused computes
        n_dec = (n_chunk - cfg.taps) // cfg.decimate
        n_out = n_dec // cfg.fft_width * cfg.fft_width
        # group-delay prefix is ceil(taps/2)
        return fe.tile_bases_t(
            self.frontend_spec, global_start + (cfg.taps - cfg.taps // 2), n_out
        )

    # -- device steps -----------------------------------------------------
    def step_stream_fused(
        self,
        raw: torch.Tensor,
        bases: torch.Tensor,
        n_valid: int | None = None,
        fuse_stft: bool = False,
    ) -> torch.Tensor:
        """Streaming mode through the fused frontend.  ``raw``: (2,
        n_chunk) native planes on the model's device, including the
        ``taps`` halo at its end; ``bases``: per-tile angles from
        :meth:`stream_bases`; ``n_valid``: real samples when the caller
        zero-padded raw bytes (zeroed in the decoded domain).  Returns
        (n_windows, fft_width) f32 fftshifted norms.

        ``fuse_stft``: run the STFT inside the kernel (widths dividing
        128), so the decimated stream never reaches device memory."""
        self.require_fused()
        cfg = self.cfg
        n_in = raw.shape[-1]
        n_dec = (n_in - cfg.taps) // cfg.decimate
        n_windows = n_dec // cfg.fft_width
        n_out = n_windows * cfg.fft_width  # whole windows (see stream_bases)
        prefix = cfg.taps - cfg.taps // 2  # ceil(taps/2), like fir_decimate
        nv = None if n_valid is None else max(0, int(n_valid) - prefix)
        if fuse_stft:
            return fe.fused_frontend_t(
                raw[:, prefix:], bases, self.frontend_spec, n_out,
                n_valid=nv, stft_width=cfg.fft_width, tables=self.frontend_tables(),
            )
        y = fe.fused_frontend_t(
            raw[:, prefix:], bases, self.frontend_spec, n_out,
            n_valid=nv, tables=self.frontend_tables(),
        )
        return stft_norms(torch.complex(y[0], y[1]).reshape(n_windows, cfg.fft_width))

    @staticmethod
    def _peak_reduce(norms: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(…, W) fftshifted norms -> ((…,) int32 argmax bin, (…,) f32
        magnitude); ties go to the lowest shifted bin and a NaN wins, as
        with ``jnp.argmax``."""
        return torch.argmax(norms, dim=-1).to(torch.int32), torch.amax(norms, dim=-1)

    def step_stream_fused_search(
        self,
        raw: torch.Tensor,
        bases: torch.Tensor,
        n_valid: int | None = None,
        fuse_stft: bool = False,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """:meth:`step_stream_fused` reduced to each window's fftshifted
        peak bin and magnitude."""
        return self._peak_reduce(self.step_stream_fused(raw, bases, n_valid, fuse_stft))

    # -- convenience ------------------------------------------------------
    def chunk_bytes(self, n_samples: int) -> int:
        return n_samples * self.cfg.fmt.pair_bytes

    def synth_raw(self, n_samples: int, seed: int = 0) -> np.ndarray:
        """Synthetic capture as (2, n_samples) native-dtype planes."""
        from quadrs_tpu_torch.formats import synth_planes

        return synth_planes(self.cfg.fmt, n_samples, seed)
