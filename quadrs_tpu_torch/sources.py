"""File-backed capture sources.

``SampleSource`` is the counterpart of the reference's ``SampleFile``
(``src/samples.rs:44-94``): length is the byte length over the pair
width, trailing partial pairs are truncated, and reads stage raw bytes
as (2, n) native-dtype planes (deinterleaved on the host in one pass),
which the device decodes.
"""

from __future__ import annotations

import numpy as np

from quadrs_tpu_torch.formats import FileDetails, FileFormat, planes_from_bytes
from quadrs_tpu_torch.utils.sniff import guess_details


class SampleSource:
    """A raw IQ capture, staged lazily as native-dtype planes."""

    def __init__(self, data: np.ndarray, fmt: FileFormat, sample_rate: int):
        """``data``: 1-D uint8 byte buffer (memmap or array) of the capture."""
        if sample_rate <= 0:
            raise ValueError("sample rate must be positive")
        self._bytes = data
        self.format = fmt
        self.sample_rate = int(sample_rate)
        # reference src/samples.rs:64-66
        self.length = len(data) // fmt.pair_bytes

    @classmethod
    def from_file(cls, path: str, details: FileDetails | None = None) -> "SampleSource":
        if details is None:
            details = guess_details(str(path))
        data = np.memmap(path, dtype=np.uint8, mode="r")
        return cls(data, details.format, details.sample_rate)

    def raw_bytes(self, lo: int, hi: int) -> bytes:
        """The capture's original interleaved bytes for samples [lo, hi)."""
        lo = max(0, min(lo, self.length))
        hi = max(lo, min(hi, self.length))
        pair = self.format.pair_bytes
        return bytes(self._bytes[lo * pair : hi * pair])

    def stage(self, lo: int, hi: int) -> np.ndarray:
        """Materialize samples [lo, hi) as (2, hi-lo) native-dtype planes
        (clipped to the capture)."""
        lo = max(0, min(lo, self.length))
        hi = max(lo, min(hi, self.length))
        pair = self.format.pair_bytes
        return planes_from_bytes(self._bytes[lo * pair : hi * pair], self.format)


def open_capture(
    path: str,
    sample_rate: str | int | None = None,
    fmt: str | None = None,
) -> SampleSource:
    """Open a capture with filename sniffing and optional overrides."""
    details = guess_details(
        str(path),
        override_sample_rate=None if sample_rate is None else str(sample_rate),
        override_format=fmt,
    )
    return SampleSource.from_file(path, details)
