"""Run cells of the benchmark one after another, each run a process of its
own as a check runs them, and summarise the spread of their metrics.

    python3 -m sdrbench.measure --out FILE.jsonl \\
        --runs CELL:SEED:SECONDS:TRACE[,CELL:SEED:SECONDS:TRACE...]
    python3 -m sdrbench.measure --out FILE.jsonl --workload CELL \\
        --seeds A,B,C,... --seconds S [--trace 0|1] [--sets 2]

Each run appends one JSON line to ``FILE.jsonl`` (its cell, seed, exit
code, wall, result line and the end of its standard error).  With
``--sets N`` the seeds run N times over, set after set.  The summary, on
standard output, gives per cell, set and metric the median, the spread
(the distance between the quartiles over the median, by
``statistics.quantiles``) and the trimmed spread (without the run farthest
from the median, where that narrows it), and whether every run was
correct.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from collections import defaultdict

from sdrbench.arith import spread, trimmed_spread


def _one(cell: str, seed: int, seconds: float, trace: int, timeout: float) -> dict:
    cmd = [sys.executable, "-m", "sdrbench.run", "--workload", cell, "--seed", str(seed), "--seconds", f"{seconds:g}",
           "--trace", str(trace)]
    t = time.monotonic()
    try:
        p = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout)
        rc, out, err = p.returncode, p.stdout, p.stderr
    except subprocess.TimeoutExpired as e:
        rc, out, err = 124, e.stdout or "", e.stderr or ""
        out = out if isinstance(out, str) else out.decode(errors="replace")
        err = err if isinstance(err, str) else err.decode(errors="replace")
    wall = time.monotonic() - t
    result = None
    lines = out.strip().splitlines()
    if rc == 0 and lines:
        try:
            result = json.loads(lines[-1])
        except ValueError:
            result = None
    return {"cell": cell, "seed": seed, "seconds": seconds, "trace": trace, "rc": rc, "wall_s": wall,
            "result": result, "stderr": err[-3000:]}


def summarise(records: list[dict]) -> list[str]:
    by = defaultdict(lambda: defaultdict(list))
    ok = defaultdict(list)
    for r in records:
        key = (r["cell"], r.get("set", 0), r["trace"])
        ok[key].append(bool(r["result"] and r["result"]["correct"]))
        if r["result"]:
            for name, m in r["result"]["metrics"].items():
                by[key][name].append(m["value"])
    out = []
    for key in sorted(by):
        cell, s, trace = key
        for name, vals in sorted(by[key].items()):
            line = f"{cell} set {s} trace {trace} {name}: n={len(vals)} median={statistics.median(vals)!r}"
            if len(vals) >= 2:
                line += (f" spread={spread(vals)!r} trimmed={trimmed_spread(vals)!r} min={min(vals)!r}"
                         f" max={max(vals)!r}")
            out.append(line)
        out.append(f"{cell} set {s} trace {trace}: correct {sum(ok[key])}/{len(ok[key])}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m sdrbench.measure")
    ap.add_argument("--out", required=True)
    ap.add_argument("--runs", default="")
    ap.add_argument("--workload")
    ap.add_argument("--seeds", default="")
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--sets", type=int, default=1)
    ap.add_argument("--timeout", type=float, default=1200.0)
    a = ap.parse_args(argv)
    plan = []
    for item in filter(None, a.runs.split(",")):
        cell, seed, seconds, trace = item.split(":")
        plan.append((cell, int(seed), float(seconds), int(trace), 0))
    if a.workload:
        for s in range(a.sets):
            plan += [(a.workload, int(seed), a.seconds, a.trace, s) for seed in a.seeds.split(",")]
    records = []
    with open(a.out, "a") as fh:
        for cell, seed, seconds, trace, s in plan:
            rec = _one(cell, seed, seconds, trace, a.timeout)
            rec["set"] = s
            records.append(rec)
            fh.write(json.dumps(rec) + "\n")
            fh.flush()
            res = rec["result"]
            brief = {k: v["value"] for k, v in res["metrics"].items()} if res else rec["stderr"][-400:]
            print(f"{cell} seed {seed} set {s} trace {trace}: rc {rec['rc']} wall {rec['wall_s']:.1f}s "
                  f"correct {res and res['correct']} {brief} checks "
                  f"{res and {k: v['value'] for k, v in res['checks'].items()}}", flush=True)
    for line in summarise(records):
        print(line)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
