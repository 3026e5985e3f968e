"""The receiver chain: decode -> NCO mix -> FIR decimate -> STFT.

The PyTorch counterpart of ``quadrs_tpu.models.receiver``.  A raw capture
chunk in its native narrow dtype becomes fftshifted spectrogram
magnitudes by one of two routes:

* the fused frontend (:meth:`PipelineModel.step_stream_fused`, the JAX
  package's ``step_stream_pallas``): decode, mix and FIR in one pass
  (:mod:`quadrs_tpu_torch.ops.frontend`: the CUDA kernels on the card,
  their plain version on the CPU), inside its envelope of 1 <= decimate
  <= 64 and at most 128 polyphase subfilters;
* the chain of torch ops, for any configuration: the per-window mode
  :meth:`~PipelineModel.step_windows` with the reference's semantics,
  and the streaming mode :meth:`~PipelineModel.step_stream`, whose FIR
  is :func:`~quadrs_tpu_torch.ops.fir.fir_decimate`.  Past 64
  subfilters the FIR runs in the frequency domain, where the NCO mix
  commutes into complex band-pass taps for free.

The model holds no learned weights.  Its state is the f32 taps and the
host-planned phase tables, registered as buffers so ``.to(device)``
moves them; phases themselves are planned on the host per chunk
(:meth:`PipelineModel.stream_bases`, :meth:`PipelineModel.theta0`), and
the chain's in-window NCO tables are kept on the device once
(:func:`~quadrs_tpu_torch.ops.tables.device_table`).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from quadrs_tpu_torch.formats import FileFormat, decode_plane
from quadrs_tpu_torch.ops import frontend as fe
from quadrs_tpu_torch.ops.fir import fir_decimate, is_spectral, lowpass_taps
from quadrs_tpu_torch.ops.nco import ExactNCO, mix
from quadrs_tpu_torch.ops.stft import stft_norms
from quadrs_tpu_torch.ops.tables import device_table


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
    fir_impl: str = "auto"

    @property
    def window_raw(self) -> int:
        """Raw samples per STFT window in per-window mode."""
        return self.fft_width * self.decimate + self.taps


def _angle(theta0, device) -> torch.Tensor:
    """A host-planned f32 angle (or angles) as a tensor on ``device``."""
    return torch.as_tensor(theta0, dtype=torch.float32, device=device)


class PipelineModel(nn.Module):
    _MIX_TILE = 4096  # in-row length of _mix_stream's q*K + r tables

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
        them); tables not given are planned from the taps, and the chain's
        premixed taps follow the taps.  The buffers land on the device the
        model is on."""
        taps = np.asarray(arrays["taps"], dtype=np.float32)
        if taps.shape != (self.cfg.taps,):
            raise ValueError(f"taps must have shape ({self.cfg.taps},), got {taps.shape}")
        device = self.taps.device if hasattr(self, "taps") else None
        self._taps_np = taps.copy()
        # the taps modulated by the exact NCO rotation at each tap index: a
        # complex band-pass filter (the spectral chain's premixed taps)
        dj = self._nco.angles(np.arange(self.cfg.taps, dtype=np.int64), dtype=np.float64)
        self._premixed_taps = (taps.astype(np.float64) * np.exp(1j * dj)).astype(np.complex64)
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

    def delta(self, n: int) -> np.ndarray:
        return self._nco.angles(np.arange(n, dtype=np.int64))

    def _cis(self, start: int, step: int, count: int, device) -> tuple[torch.Tensor, torch.Tensor]:
        """The host-exact ``(cos, sin)`` tables at indices ``start + step * i``,
        ``i < count``, kept on ``device``."""
        nco = self._nco
        t = device_table("nco.cis", (nco.frequency, nco.sample_rate, start, step, count), device,
                         lambda: np.stack(nco.cis(start + step * np.arange(count, dtype=np.int64))))
        return t[0], t[1]

    # -- the chain of torch ops ---------------------------------------------
    def _decode(self, raw: torch.Tensor) -> torch.Tensor:
        """(…, 2, n) native-dtype planes -> (…, n) complex64."""
        re = decode_plane(raw[..., 0, :], self.cfg.fmt)
        im = decode_plane(raw[..., 1, :], self.cfg.fmt)
        return torch.complex(re, im)

    def _mix(self, x: torch.Tensor, theta0: torch.Tensor, n: int) -> torch.Tensor:
        """Rotate each row by ``theta0[b] + delta[k]``: an f32 sum of host
        angles, then f32 cos/sin, then :func:`~quadrs_tpu_torch.ops.nco.mix`'s
        product."""
        nco = self._nco
        delta = device_table("nco.delta", (nco.frequency, nco.sample_rate, n), x.device, lambda: self.delta(n))
        return mix(x, theta0[..., None] + delta)

    def _mix_stream(self, x: torch.Tensor, theta0: torch.Tensor) -> torch.Tensor:
        """NCO mix over a long chunk without an O(chunk) angle table or
        per-sample trig: index ``i = q*K + r`` splits the exact rotation
        into ``cis(theta0) · cis(thetaQ[q]) · cis(thetaR[r])``, host-exact
        f64-rounded tables of O(n/K + K) values, rotated by the angle
        addition identity."""
        k = self._MIX_TILE
        n = x.shape[-1]
        rows = -(-n // k)
        if rows * k != n:
            x = torch.nn.functional.pad(x, (0, rows * k - n))
        cq, sq = self._cis(0, k, rows, x.device)
        cr, sr = self._cis(0, 1, k, x.device)
        c0, s0 = torch.cos(theta0), torch.sin(theta0)
        ca = (c0 * cq - s0 * sq)[:, None]
        sa = (s0 * cq + c0 * sq)[:, None]
        c = ca * cr[None, :] - sa * sr[None, :]
        s = sa * cr[None, :] + ca * sr[None, :]
        xr = x.reshape(rows, k)
        mixed = torch.complex(xr.real * c - xr.imag * s, xr.real * s + xr.imag * c)
        return mixed.reshape(rows * k)[:n]

    @property
    def _spectral_fir(self) -> bool:
        """True when :meth:`step_stream`'s FIR runs in the frequency
        domain, where the NCO mix commutes into the filter:
        ``sum_j x[iD+j] e^{i theta(iD+j)} h[j] = e^{i theta(iD)} sum_j
        x[iD+j] (h[j] e^{i theta(j)})``, complex taps plus a decimated-rate
        output twiddle and no per-sample mix."""
        if self.cfg.fir_impl in ("overlap_save", "os_poly"):
            return True
        if self.cfg.fir_impl != "auto":
            return False
        return is_spectral(self.cfg.taps, self.cfg.decimate)

    def _twiddle_decimated(self, y: torch.Tensor, theta0: torch.Tensor, n_dec: int) -> torch.Tensor:
        """Rotate decimated premixed-FIR outputs by the exact NCO angle of
        their first contributing sample: host-exact cis tables at the
        decimated rate, rotated by the chunk's base angle."""
        cfg = self.cfg
        prefix = cfg.taps - cfg.taps // 2  # fir_decimate's group-delay drop
        twr, twi = self._cis(prefix, cfg.decimate, n_dec, y.device)
        c0, s0 = torch.cos(theta0), torch.sin(theta0)
        cr = c0 * twr - s0 * twi
        ci = s0 * twr + c0 * twi
        return torch.complex(y.real * cr - y.imag * ci, y.real * ci + y.imag * cr)

    def step_windows(self, raw: torch.Tensor, theta0) -> torch.Tensor:
        """Per-window mode: ``raw`` is (B, 2, window_raw) native-dtype
        planes (one block per STFT window), ``theta0`` (B,) exact window
        phases.  Returns (B, fft_width) f32 spectrogram rows."""
        cfg = self.cfg
        x = self._mix(self._decode(raw), _angle(theta0, raw.device), cfg.window_raw)
        y = fir_decimate(x, self._taps_np, cfg.decimate, cfg.fft_width, impl=cfg.fir_impl)
        return stft_norms(y)

    def step_stream(self, raw: torch.Tensor, theta0, valid: int | None = None) -> torch.Tensor:
        """Streaming mode: ``raw`` is (2, n_chunk) native-dtype planes of a
        contiguous chunk (including the ``taps`` halo at its end),
        ``theta0`` the host-planned phase of its first sample.  The FIR
        runs once across the chunk; the decimated stream reshapes into
        adjacent STFT windows.  Returns (n_windows, fft_width) f32.

        ``valid``: real samples in ``raw``; later ones are zeroed in the
        decoded domain (a zero byte decodes to -127.5 in cu8 and -32767.5
        in cs16)."""
        cfg = self.cfg
        n_in = raw.shape[-1]
        theta0 = _angle(theta0, raw.device)
        x = self._decode(raw)
        if valid is not None and valid < n_in:
            x = torch.where(torch.arange(n_in, device=raw.device) < valid, x, 0)
        n_dec = (n_in - cfg.taps) // cfg.decimate
        n_windows = n_dec // cfg.fft_width
        if self._spectral_fir:
            y = fir_decimate(x[None, :], self._premixed_taps, cfg.decimate, n_dec, impl=cfg.fir_impl)[0]
            y = self._twiddle_decimated(y, theta0, n_dec)
        else:
            x = self._mix_stream(x, theta0)
            y = fir_decimate(x[None, :], self._taps_np, cfg.decimate, n_dec, impl=cfg.fir_impl)[0]
        return stft_norms(y[: n_windows * cfg.fft_width].reshape(n_windows, cfg.fft_width))

    def step_stream_search(
        self, raw: torch.Tensor, theta0, valid: int | None = None
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """:meth:`step_stream` reduced to each window's fftshifted peak
        bin and magnitude."""
        return self._peak_reduce(self.step_stream(raw, theta0, valid))

    # -- the fused frontend -----------------------------------------------
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
        128 polyphase subfilters.  Outside it the chain of torch ops
        (:meth:`step_stream`) is the route."""
        m_sub = -(-self.cfg.taps // self.cfg.decimate)
        return fe.supported_t(self.cfg.decimate) and m_sub <= 128

    def frontend_tables(self) -> fe.FrontendTables:
        """The model's buffers as the frontend's tables, with the byte
        formats' decode table on the buffers' device."""
        decode = getattr(self, "_decode_table", None)
        if decode is None or decode.device != self.hp.device:
            decode = self._decode_table = fe.decode_tensor(self.cfg.fmt, self.hp.device)
        return fe.FrontendTables(
            self.hp, self.tab_cos, self.tab_sin,
            getattr(self, "stft_cos", None), getattr(self, "stft_sin", None), decode,
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
        (n_windows, fft_width) f32 fftshifted norms, as :meth:`step_stream`.

        ``fuse_stft``: run the STFT inside the kernel (widths dividing
        128), so the decimated stream never reaches device memory."""
        if not self.fused_supported():
            raise ValueError(
                f"decimate {self.cfg.decimate} with {self.cfg.taps} taps is outside the fused "
                "frontend's envelope (1 <= decimate <= 64, at most 128 subfilters): use step_stream"
            )
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
