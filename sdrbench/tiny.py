"""The benchmark's cells at a size the CPU runs in seconds, for its tests:
a copy of the configurations, traffic mixes, cells and metrics with the
captures cut to 2^18 samples, the live chunks to 2^16, the conditioning
windows a hundredth of theirs, and a live cell's configuration at a
twentieth of its sample rate, so that its pipe runs at a twentieth of the
source's rate.  Widths, taps, decimation and the limits are the cells'
own."""

from __future__ import annotations

import json
import pathlib
import shutil

from sdrbench.spec import HERE

SAMPLES = 1 << 18
SLOWER = 20  # the live configurations' sample rate over this


def _config(d: dict) -> None:
    if "capture" in d:
        d["capture"]["samples"] = SAMPLES
        if d["capture"].get("warm_samples"):
            d["capture"]["warm_samples"] = 1 << 16
    for s in d["chain"]:
        if s["stage"] in ("dcblock", "agc"):
            s["window"] = max(2, s["window"] // 100)


def _traffic(d: dict) -> None:
    if d["kind"] == "live_pipe":
        d.update(loop_samples=SAMPLES, chunk=1 << 16)


def _edit(path: pathlib.Path, edit) -> None:
    d = json.loads(path.read_text())
    edit(d)
    path.write_text(json.dumps(d, indent=1))


def tiny_root(dst: pathlib.Path) -> pathlib.Path:
    """The cut copy under ``dst``; returns ``dst``."""
    dst = pathlib.Path(dst)
    for kind in ("configs", "traffic", "workloads", "metrics"):
        shutil.copytree(HERE / kind, dst / kind, dirs_exist_ok=True)
    for kind, edit in (("configs", _config), ("traffic", _traffic)):
        for p in sorted((dst / kind).glob("*.json")):
            _edit(p, edit)
    live = set()
    for p in sorted((dst / "workloads").glob("*.json")):
        cell = json.loads(p.read_text())
        if json.loads((dst / "traffic" / f"{cell['traffic']}.json").read_text())["kind"] == "live_pipe":
            live.add(cell["config"])
    for name in sorted(live):
        _edit(dst / "configs" / f"{name}.json", lambda d: d.update(sample_rate=d["sample_rate"] // SLOWER))
    return dst
