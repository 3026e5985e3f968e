"""Closed-loop capture traffic: the program's CLI run pass after pass over
one seeded capture, each pass a new command as a user runs it
(``quadrs_tpu_torch.cli.main``), until the first pass that ends after the
window's seconds.  A pass is ``from CAPTURE <the config's stages>
sparkfft -width W [-stride S] -range LO:HI``, its glyph rows into memory
(:class:`~sdrbench.outputs.GlyphRows`).

The check compares every row of the latest pass and the drawn rows of
every other pass with the plain reference.
"""

from __future__ import annotations

import contextlib
import os

import numpy as np
import torch

from sdrbench import capture as synth
from sdrbench.outputs import GlyphRows, glyph_levels
from sdrbench.reference import chain as ref


def _stage_args(st: dict) -> list[str]:
    kind = st["stage"]
    if kind == "shift":
        return ["shift", str(st["freq"])]
    if kind == "lowpass":
        return ["lowpass", "-power", str(st["power"]), "-decimate", str(st["decimate"]), str(st["freq"])]
    if kind == "dcblock":
        return ["dcblock", "-window", str(st["window"])]
    if kind == "agc":
        return ["agc", "-target", f"{st['target']:g}", "-window", str(st["window"]), "-max-gain", f"{st['max_gain']:g}"]
    raise ValueError(f"unknown stage {kind!r}")


def argv(cfg: dict, path: str) -> list[str]:
    """The command line of one pass over ``path``."""
    sink = cfg["sink"]
    args = ["from", path]
    for st in cfg["chain"]:
        args += _stage_args(st)
    args += ["sparkfft", "-width", str(sink["width"])]
    if sink["stride"] != sink["width"]:
        args += ["-stride", str(sink["stride"])]
    lo, hi = sink["range"]
    return args + ["-range", f"{lo:g}:{hi:g}"]


def _capture_path(run, name: str) -> str:
    return os.path.join(run.tmp, f"{name}.sr{run.config['sample_rate']}.{run.config['format']}")


class _Passes:
    """One command's passes and what each printed."""

    def __init__(self, run):
        from quadrs_tpu_torch import cli

        self.run = run
        self.main = cli.main
        self.rows = GlyphRows(run.config["sink"]["width"])
        self.last: list[str] = []

    def once(self, path: str, keep: np.ndarray) -> dict:
        self.rows.begin(keep)
        with contextlib.redirect_stdout(self.rows):
            rc = self.main(argv(self.run.config, path))
        self.rows.finish()
        self.last = self.rows.blocks
        return {"rc": rc, "count": self.rows.rows, "kept": dict(self.rows.kept), "header": self.rows.header,
                "malformed": self.rows.malformed}


def draw(seed: int, p: int, count: int, k: int) -> np.ndarray:
    """The rows or windows of pass ``p`` the check reads: ``k`` drawn from
    the seed, the first and the last among them."""
    rng = np.random.default_rng([int(seed) % (1 << 63), p])
    pick = rng.choice(count, size=min(k, count), replace=False) if count else np.zeros(0, np.int64)
    return np.unique(np.concatenate([pick, [0, count - 1]]).astype(np.int64)) if count else pick


def setup(run) -> None:
    cfg = run.config
    samples = int(cfg["capture"]["samples"])
    data = synth.synthesize(cfg["signal"], cfg["sample_rate"], samples, run.seed, run.device)
    run.state["path"] = _capture_path(run, "capture")
    synth.write(data, run.state["path"])
    warm = cfg["capture"].get("warm_samples")
    warm_path = run.state["path"]
    if warm:
        warm_path = _capture_path(run, "warm")
        synth.write(data[: 2 * int(warm)], warm_path)
    del data
    run.inputs_made()
    run.state["length"] = samples
    run.state["expected"] = ref.sparkfft_rows(cfg, ref.Capture(torch.zeros(2, dtype=torch.uint8), samples, loop=True))
    passes = _Passes(run)
    run.state["passes"] = passes
    out = passes.once(warm_path, np.zeros(0, np.int64))
    if out["rc"] != 0:
        raise RuntimeError(f"the warm-up pass exited {out['rc']}")
    if warm:
        os.unlink(warm_path)
    if run.device.type == "cuda":
        torch.cuda.synchronize()


def window(run) -> None:
    passes = run.state["passes"]
    k = int(run.traffic["sample_per_pass"])
    draws = [draw(run.seed, p, run.state["expected"], k) for p in range(64)]
    results = []
    ends = []
    run.begin()
    while True:
        p = len(results)
        keep = draws[p] if p < len(draws) else draw(run.seed, p, run.state["expected"], k)
        results.append(passes.once(run.state["path"], keep))
        ends.append(run.clock())
        if ends[-1] - run.t_start >= run.seconds:
            break
    run.end()
    walls = np.diff([run.t_start] + ends)
    q = np.percentile(walls, np.arange(0, 101, 10))
    thirds = [float(np.median(t)) for t in np.array_split(walls, 3) if len(t)]
    run.notes.append(f"passes: {len(walls)}, seconds by decile " + " ".join(f"{v:.4f}" for v in q)
                     + "; median by third of the window " + " ".join(f"{v:.4f}" for v in thirds))
    ok = sum(1 for r in results if r["rc"] == 0)
    run.attempted = len(results)
    run.failed = len(results) - ok
    run.samples = ok * run.state["length"]
    run.kind = "capture"
    run.passes = len(results)
    run.state["results"] = results
    run.state["last"] = "".join(passes.last)


def release(run) -> None:
    run.state.pop("passes", None)


def _load_capture(run) -> ref.Capture:
    raw = np.fromfile(run.state["path"], dtype=np.uint8)
    return ref.Capture(torch.from_numpy(raw).to(run.device))


def check(run) -> list[tuple[str, float, float]]:
    """The output check: each number compared with its limit."""
    return compare(run, _load_capture(run))


def compare(run, cap: ref.Capture) -> list[tuple[str, float, float]]:
    """What the passes in ``run.state["results"]`` printed, against the
    float64 reference over ``cap``."""
    return [("passes_failed", float(run.failed), 0.0)] + _check_chain(run, cap)


def glyph_text(levels: np.ndarray) -> str:
    """Rows of levels as ``sparkfft`` prints them, a newline after each."""
    return "".join(ref.glyph_row(r) + "\n" for r in levels)


def _check_chain(run, cap: ref.Capture) -> list[tuple[str, float, float]]:
    cfg, lim = run.config, run.limits
    results = run.state["results"]
    expected = run.state["expected"]
    width = cfg["sink"]["width"]
    lo, hi = cfg["sink"]["range"]
    rate = ref.Chain(cfg, cap).rate(len(cfg["chain"]))
    missing = 0.0
    for r in results:
        missing += abs(expected - r["count"])
        if r["rc"] == 0 and (r["header"] != f"sparkfft sample_rate={rate}" or r["malformed"]):
            missing += 1
    norms = ref.sparkfft_all(cfg, cap).cpu()
    gap = 0.0
    last = run.state.get("last")
    if last is not None:  # the latest pass, every row
        levels = glyph_levels(last, width)
        if levels is None or len(levels) != expected:
            gap = float("inf")
        else:
            gap = float(ref.level_gap(norms, torch.as_tensor(levels), lo, hi).max())
    for r in results:
        for w, text in r["kept"].items():
            levels = glyph_levels(text + "\n", width)
            if levels is None or not 0 <= w < len(norms):
                gap = float("inf")
                continue
            g = ref.level_gap(norms[w], torch.as_tensor(levels[0]), lo, hi)
            gap = max(gap, float(g.max()))
    return [("rows_missing", missing, lim["rows_missing"]), ("glyph_gap", gap, lim["glyph_gap"])]
