"""The capture loader: C++ source, built at first use, bound with ctypes."""

from quadrs_tpu_torch.native.loader import NativeCapture, library

__all__ = ["NativeCapture", "library"]
