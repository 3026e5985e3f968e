"""Command-line entry point: ``python -m quadrs_tpu_torch``.

Parses argv into commands, prints usage on error or when empty, then runs
each command on the device ``QUADRS_PLATFORM`` names: ``cpu``, or
``cuda`` (the default).  With CUDA asked for and none available the run
fails; it never carries on silently on the CPU.
"""

from __future__ import annotations

import os
import sys

import torch

from quadrs_tpu_torch import args as argmod
from quadrs_tpu_torch import serve

USAGE = """\
usage: {us} \\
  stream [-shift 0] [-lowpass 200k] [-power 200] [-decimate 32] [-width 64] \\
         [-chunk 4M] [-chunks N] [-search no] [-out PREFIX] FILENAME

(-mesh, -stdin, -scan and -trigger parse as in quadjax but are not yet ported.)

Formats:

 * cf32: complex (little endian) floats, 32-bit (GNU-Radio, gqrx)
 *  cs8: complex      signed (integers),  8-bit (HackRF)
 *  cu8: complex    unsigned (integers),  8-bit (RTL-SDR)
 * cs16: complex      signed (integers), 16-bit (Fancy)
"""


def select_device() -> torch.device:
    """The device ``QUADRS_PLATFORM`` names; unset means ``cuda``.
    Raises when CUDA is asked for and unavailable."""
    want = os.environ.get("QUADRS_PLATFORM") or "cuda"
    if want == "cpu":
        return torch.device("cpu")
    if want != "cuda":
        raise ValueError(f"QUADRS_PLATFORM must be 'cpu' or 'cuda', got {want!r}")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available (torch.cuda.is_available() is False); "
            "set QUADRS_PLATFORM=cpu to run on the CPU"
        )
    return torch.device("cuda")


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    us = "python -m quadrs_tpu_torch"

    try:
        commands = argmod.parse(argv)
    except ValueError as e:
        print(USAGE.format(us=us))
        print(f"Error: {e}", file=sys.stderr)
        return 1

    if not commands:
        print(USAGE.format(us=us))
        print("Error: no commands provided", file=sys.stderr)
        return 1

    try:
        device = select_device()
        for command in commands:
            rc = serve.run_stream(command, device)
            if rc:
                return rc
    except (ValueError, RuntimeError, OSError, NotImplementedError) as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
