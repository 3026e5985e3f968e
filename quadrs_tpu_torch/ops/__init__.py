from quadrs_tpu_torch.ops.fir import fir_decimate, lowpass_taps
from quadrs_tpu_torch.ops.stft import blackman_harris_window, stft_norms

# the JAX package's exports but dft_matrix, its MXU DFT (torch.fft here)
__all__ = [
    "lowpass_taps",
    "fir_decimate",
    "stft_norms",
    "blackman_harris_window",
]
