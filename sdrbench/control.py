"""The output check's control: the plain reference put in the program's
place and computed one precision below the configuration's (TF32 for
float32 with TF32 off), at the cell's own size, judged by the same
comparison as a run.  It has to come out as not correct.

    python3 -m sdrbench.control --workload CELL --seeds A,B,C \\
        [--precisions tf32,f32] [--passes N] [--seconds S]

One JSON line a cell, seed and precision: each number compared.  A
capture cell's control gives a whole pass, checked as a run's latest one,
with as many passes' drawn rows as ``--passes`` (the passes a run of the
cell makes); a live cell every chunk of a stream of ``--seconds``.  ``f32`` (TF32 off) is printed beside it as the
reading a sound float32 program would give.  It runs on the card where
there is one, else on the CPU (then at whatever size the cell's files
give: the tests use small ones).
"""

from __future__ import annotations

import argparse
import json
import types

import numpy as np
import torch

from sdrbench import capture as synth
from sdrbench import spec
from sdrbench.reference import chain as ref
from sdrbench.traffic import capture_cli, live_pipe


def _run(cell: spec.Cell, seed: int, device, **state) -> types.SimpleNamespace:
    return types.SimpleNamespace(config=cell.config, traffic=cell.traffic, limits=cell.limits, seed=seed,
                                 device=device, failed=0, state=dict(state))


def control_chain(cell, cap: ref.Capture, seed: int, prec: str, device, passes: int) -> list:
    """Every row of a pass from :func:`~sdrbench.reference.chain.sparkfft_all`
    in the lower precision (its running sums too, over the whole stream),
    checked as a run's latest pass, with each earlier pass's drawn rows."""
    cfg = cell.config
    expected = ref.sparkfft_rows(cfg, cap)
    lo, hi = cfg["sink"]["range"]
    rate = ref.Chain(cfg, cap).rate(len(cfg["chain"]))
    levels = ref.glyph_levels(ref.sparkfft_all(cfg, cap, prec).cpu(), lo, hi).numpy()
    text = capture_cli.glyph_text(levels)
    step = cfg["sink"]["width"] + 3
    draws = [capture_cli.draw(seed, p, expected, int(cell.traffic["sample_per_pass"])) for p in range(passes)]
    results = [{"rc": 0, "count": expected, "kept": {int(r): text[r * step : r * step + step - 1] for r in d},
                "header": f"sparkfft sample_rate={rate}", "malformed": None} for d in draws]
    run = _run(cell, seed, device, results=results, expected=expected, last=text)
    return capture_cli.compare(run, cap)


def control_live(cell, seed: int, prec: str, device, seconds: float) -> list:
    cfg, tr = cell.config, cell.traffic
    rate = int(cfg["sample_rate"])
    chunk = live_pipe.whole_windows(cfg, tr["chunk"])
    n_chunks = max(2, round(seconds * rate / chunk))
    data = synth.synthesize(cfg["signal"], cfg["sample_rate"], int(tr["loop_samples"]), seed, device)
    cap = ref.Capture(data, length=n_chunks * chunk, loop=True)
    lp = next(s for s in cfg["chain"] if s["stage"] == "lowpass")
    per = chunk // (lp["decimate"] * cfg["sink"]["width"])
    norms = live_pipe.stream_reference(cfg, cap, np.arange(n_chunks * per), prec).astype(np.float32)
    kept = {k: norms[k * per : (k + 1) * per] for k in range(n_chunks)}
    shapes = {k: (0, v.shape) for k, v in kept.items()}
    run = _run(cell, seed, device, kept=kept, shapes=shapes, per_chunk=per, total=n_chunks * chunk)
    return live_pipe.compare(run, cap)


def readings(cell, seed: int, prec: str, device, passes: int, seconds: float) -> dict:
    if cell.traffic["kind"] == "live_pipe":
        checks = control_live(cell, seed, prec, device, seconds)
    else:
        cfg = cell.config
        data = synth.synthesize(cfg["signal"], cfg["sample_rate"], int(cfg["capture"]["samples"]), seed, device)
        checks = control_chain(cell, ref.Capture(data), seed, prec, device, passes)
    return {name: value for name, value, _ in checks}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m sdrbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--precisions", default="tf32,f32")
    ap.add_argument("--passes", type=int, default=6)
    ap.add_argument("--seconds", type=float, default=20.0)
    a = ap.parse_args(argv)
    device = torch.device("cuda", 0) if torch.cuda.is_available() else torch.device("cpu")
    cell = spec.Cell(a.workload)
    for seed in [int(s) for s in a.seeds.split(",")]:
        for prec in a.precisions.split(","):
            out = readings(cell, seed, prec, device, a.passes, a.seconds)
            print(json.dumps({"workload": a.workload, "seed": seed, "precision": prec, "device": str(device),
                              "checks": {k: (v if np.isfinite(v) else None) for k, v in out.items()}}), flush=True)
            if device.type == "cuda":
                torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
