"""The bench: ``python -m quadrs_tpu_torch.bench [--entries A,B] [--headline-only] [--quick]``.

The counterpart of the JAX package's root ``bench.py`` and
``bench_suite.py``.  The headline is BASELINE's chain (cs8 at 21 Msps,
shift 280k, lowpass 200k with 400 taps, decimate 32, a 64-point STFT)
over a device-resident 4M-sample chunk under 16 rotating NCO phases;
then the 18 entries of :mod:`quadrs_tpu_torch.bench_suite`.  Each entry
prints one flushed JSON line as soon as it is measured, headline first,
with ``entry`` its JAX function's name, the card's name in ``device`` and
the run's ``scale``.  An entry that fails prints ``{"entry": ...,
"error": ...}`` and the run goes on; the exit code is 1 if any failed.

It runs on the card (the full shapes and timing windows, or ``--quick``:
0.25 s windows, one rep, the 1G-sample captures cut to 2^28 samples),
and on the CPU only under ``QUADRS_PLATFORM=cpu``, where the shapes stay
and the lengths shrink (``smoke``): a check that every entry runs, not a
speed figure.  The synthetic captures are written to the temporary
directory and kept for the next run.  ``vs_baseline`` is against the 100
Msamples/sec north star.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
import traceback

import torch

from quadrs_tpu_torch import bench_suite as bs


def headline(sc: bs.Scale) -> dict:
    """BASELINE's chain through :func:`~quadrs_tpu_torch.bench_suite.make_step`."""
    return bs.chain_entry(sc, bs.HEADLINE_CFG, sc.size(1 << 22, 1 << 14),
                          "fused cs8 decode+shift+lowpass(dec32,taps400)+stft64 throughput", 4.5, min_iters=4, reps=3)


ENTRIES = {"headline": headline, **bs.SUITE}


def run(names: list[str], sc: bs.Scale, out=None) -> list[dict]:
    """Run the named entries in order, printing each line to ``out`` (by
    default standard output) as it is measured; returns the lines.  Between
    entries the card's queue is drained and the allocator's cache emptied,
    so that one entry's staging does not weigh on the next."""
    out = sys.stdout if out is None else out
    cuda = sc.device.type == "cuda"
    if cuda:
        from quadrs_tpu_torch.ops.frontend import no_tf32

        no_tf32()
    card = torch.cuda.get_device_name(sc.device) if cuda else "cpu"
    lines = []
    for name in names:
        t0 = time.perf_counter()
        try:
            line = {"entry": name, **ENTRIES[name](sc)}
        except Exception as e:  # the run goes on; the line says what failed
            traceback.print_exc()
            line = {"entry": name, "error": f"{type(e).__name__}: {e}"}
        if cuda:
            torch.cuda.synchronize(sc.device)
            torch.cuda.empty_cache()
        line.update(device=card, scale=sc.mode, seconds=time.perf_counter() - t0)
        print(json.dumps(line), file=out, flush=True)
        lines.append(line)
    return lines


def main(argv: list[str] | None = None) -> int:
    from quadrs_tpu_torch.cli import select_device

    parser = argparse.ArgumentParser(prog="python -m quadrs_tpu_torch.bench", description=__doc__.split("\n\n")[1])
    parser.add_argument("--entries", help="comma-separated entry names, run in the given order (default: all)")
    parser.add_argument("--headline-only", action="store_true", help="the headline alone")
    parser.add_argument("--quick", action="store_true",
                        help="0.25 s windows, one rep, 2^28-sample captures (the smoke run's phase)")
    args = parser.parse_args(argv)
    names = list(ENTRIES)
    if args.headline_only:
        names = ["headline"]
    elif args.entries:
        names = [n.strip() for n in args.entries.split(",") if n.strip()]
        unknown = [n for n in names if n not in ENTRIES]
        if unknown:
            parser.error(f"unknown entries {', '.join(unknown)}; the entries are {', '.join(ENTRIES)}")
    try:
        device = select_device()
    except (RuntimeError, ValueError) as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1
    mode = "smoke" if device.type == "cpu" else "quick" if args.quick else "full"
    lines = run(names, bs.Scale(mode, device, tempfile.gettempdir()))
    return 1 if any("error" in line for line in lines) else 0


if __name__ == "__main__":
    raise SystemExit(main())
