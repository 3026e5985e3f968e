"""Finding the benchmark's pieces by name.

Every configuration, traffic mix, traffic driver, cell and metric sits in
a file of its own, found by the name ``BENCHMARK.json`` gives it:

* ``configs/<config>.json``: one deployment of the chain;
* ``traffic/<traffic>.json``: one traffic mix, whose ``kind`` names its
  driver, ``traffic/<kind>.py``;
* ``workloads/<cell>.json``: one cell: its config, traffic and the limits
  of its output check;
* ``metrics/<metric>.py``: one reader a metric, ``read(run)`` giving a
  number or None.

So a later change adds files and entries and edits none that is there.
"""

from __future__ import annotations

import importlib.util
import json
import pathlib
import re

HERE = pathlib.Path(__file__).resolve().parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _name(name: str) -> str:
    if not NAME.match(name or ""):
        raise ValueError(f"not a benchmark name: {name!r}")
    return name


def load_json(kind: str, name: str, root: pathlib.Path = HERE) -> dict:
    """``<root>/<kind>/<name>.json``."""
    path = root / kind / f"{_name(name)}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1] if kind.endswith('s') else kind} named {name!r} ({path})")
    with open(path) as fh:
        return json.load(fh)


def load_module(kind: str, name: str, root: pathlib.Path = HERE):
    """``<root>/<kind>/<name>.py`` as a module of its own (names may hold
    dots, which an import path cannot)."""
    path = root / kind / f"{_name(name)}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} module named {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(f"sdrbench.{kind}.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_benchmark(path: pathlib.Path | None = None) -> dict:
    """``BENCHMARK.json`` from the checkout's root (the working directory
    the benchmark's command runs in)."""
    path = pathlib.Path("BENCHMARK.json") if path is None else path
    with open(path) as fh:
        return json.load(fh)


def cell_metrics(bench: dict, cell: str, trace: bool) -> list[dict]:
    """The metrics a cell reports: with ``trace`` its per-layer metrics,
    else its end-to-end ones, each as its ``BENCHMARK.json`` entry.  An
    entry without ``workloads`` reaches every cell (a per-layer one, every
    cell that reports the end-to-end metric it moves)."""
    e2e = [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}
    out = []
    for m in bench["per_layer"]:
        if "workloads" in m:
            if cell in m["workloads"]:
                out.append(m)
        elif m["moves"] in moved:
            out.append(m)
    return out


class Cell:
    """One cell with everything it names, found by name."""

    def __init__(self, name: str, root: pathlib.Path = HERE, bench: dict | None = None):
        self.name = name
        self.workload = load_json("workloads", name, root)
        self.config = load_json("configs", self.workload["config"], root)
        self.traffic = load_json("traffic", self.workload["traffic"], root)
        self.driver = load_module("traffic", self.traffic["kind"], root)
        self.limits = dict(self.workload.get("limits", {}))
        self.root = root
        self.bench = bench

    @property
    def chips(self) -> int:
        return int(self.workload.get("chips", 1))

    def metrics(self, trace: bool) -> list[dict]:
        if self.bench is None:
            return []
        return cell_metrics(self.bench, self.name, trace)

    def reader(self, metric: str):
        return load_module("metrics", metric, self.root)
