"""Filename-based capture metadata sniffing.

Filename conventions carry configuration in the SDR world; this mirrors
the reference's regexes and precedence exactly (``src/args.rs:65-135``):

* ``\\bsr([0-9]+[kMG]?)\\b`` anywhere in the name sets the sample rate;
* gqrx captures ``gqrx_*_<freq>_<rate>_fc.raw`` set rate + cf32;
* rtl_433 captures ``g<n>_<freq>M_<rate>k.cu8`` set rate + cu8;
* the extension after the last ``.`` sets the format;
* explicit ``-sr`` / ``-format`` overrides win.
"""

from __future__ import annotations

import re

from quadrs_tpu_torch.formats import FileDetails, FileFormat, format_from_extension
from quadrs_tpu_torch.utils.si import parse_si_uint

_SR_RE = re.compile(r"\bsr([0-9]+[kMG]?)\b")
_GQRX_RE = re.compile(r"gqrx_.*?_[0-9]+_([0-9]+)_fc.raw")
_RTL433_RE = re.compile(r"g\d+_\d+(?:\.\d+)?M_(\d+k).cu8")


def guess_format_from_name(
    filename: str,
) -> tuple[str | None, FileFormat | None]:
    """Sniff (sample_rate_text, format) from a filename (``src/args.rs:100-135``)."""
    sample_rate: str | None = None
    fmt: FileFormat | None = None

    m = _SR_RE.search(filename)
    if m:
        sample_rate = m.group(1)

    m = _GQRX_RE.search(filename)
    if m:
        sample_rate = m.group(1)
        fmt = FileFormat.COMPLEX_FLOAT32

    m = _RTL433_RE.search(filename)
    if m:
        sample_rate = m.group(1)
        fmt = FileFormat.COMPLEX_UINT8

    dot = filename.rfind(".")
    if dot != -1:
        ext = filename[dot + 1 :]
        guess = format_from_extension(ext)
        if guess is not None:
            fmt = guess

    return sample_rate, fmt


def guess_details(
    filename: str,
    override_sample_rate: str | None = None,
    override_format: str | None = None,
) -> FileDetails:
    """Resolve capture metadata with override precedence (``src/args.rs:65-98``)."""
    sample_rate, fmt = guess_format_from_name(filename)

    if override_sample_rate is not None:
        sample_rate = override_sample_rate

    if override_format is not None:
        fmt = format_from_extension(override_format)
        if fmt is None:
            raise ValueError(f"unrecognised extension: {override_format!r}")

    if sample_rate is None:
        raise ValueError(
            f"unable to guess sample rate from filename {filename!r}, please specify it"
        )
    if fmt is None:
        raise ValueError(
            f"unable to guess format from filename {filename!r}, please specify it"
        )

    return FileDetails(format=fmt, sample_rate=parse_si_uint(sample_rate))
