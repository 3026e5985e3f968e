"""What a window's batch changes in quadrs_tpu_torch, and what it costs.

Run from the root of a checkout:

- ``python3 profile_batches.py`` (one CUDA card): which torch ops of the
  executor's chains give a row's values that depend on the rows computed
  with it on the card (torch's row reductions and prefix sums at the
  trailing stages' shapes, beside the row-scan kernels of
  ``ops/rowscan.py``; the chains ``dcblock``, ``agc`` and ``shift`` through
  ``Executor`` at 1, 7 and 200 windows a batch), and the NCO mix's forms
  at the stage chain's batch (58 windows of 1,154,384): the complex
  product against real planes (seven passes, and ``ops.nco.rotate``'s
  four), each timed by CUDA events, with its temporaries and its batch
  dependence.
- ``python3 profile_batches.py stage TREE [TREE ...]``: ``chip_smoke.py``'s
  ``stage_sparkfft`` from each checkout given, in turn, each in a process of
  its own over the same fresh 2^24-sample capture, each tree's kernels
  built first: to compare two commits in one call (parent, change,
  change, parent).
- ``python3 profile_batches.py cpu`` (any host): on the CPU, which of
  torch's FFT, ``mean`` and ``cumsum`` give a row's values that depend on
  its batch or the threads, and the FFT through ``ops/fir.fixed_row_calls``.
- ``python3 profile_batches.py plan`` (any host): the host memory (by
  ``tracemalloc``) and time of ``ToneGen``'s planning of one capped batch
  with noise: 57 windows of 1,154,384 generated samples.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch


def per_rows(fn, x: torch.Tensor, rows: int) -> torch.Tensor:
    return torch.cat([fn(x[i:i + rows]) for i in range(0, x.shape[0], rows)])


def reductions(card: str) -> None:
    from quadrs_tpu_torch.ops import rowscan

    g = torch.Generator(device="cuda").manual_seed(0)
    ops = {
        "mean dim 1 (complex)": lambda t: t.mean(dim=1, keepdim=True),
        "sum dim 1 (f32)": lambda t: t.real.sum(dim=1, keepdim=True),
        "cumsum dim 1 (complex)": lambda t: torch.cumsum(t, dim=1),
        "cumsum dim 1 (f32)": lambda t: torch.cumsum(t.real**2 + t.imag**2, dim=1),
        "row_mean kernel (complex)": rowscan.row_mean,
        "row_exclusive_prefix kernel (complex)": lambda t: rowscan.row_exclusive_prefix(t, rowscan.row_mean(t)),
        "row_exclusive_prefix kernel (f32)": lambda t: rowscan.row_exclusive_prefix(t.real**2 + t.imag**2),
    }
    for shape in ((200, 562), (200, 162), (58, 36_061), (200, 4592)):
        x = torch.randn(shape, dtype=torch.complex64, device="cuda", generator=g) + (0.3 - 0.2j)
        for name, fn in ops.items():
            whole = fn(x)
            parts = {b: per_rows(fn, x, b) for b in (1, 7)}
            gap = max(float((p - whole).abs().max()) for p in parts.values())
            print(f"  {shape} {name}: values differing at 1 / 7 rows a call from all at once: "
                  f"{int((parts[1] != whole).sum())} / {int((parts[7] != whole).sum())} of {whole.numel()}; "
                  f"max |diff| {gap:.3e} ({card})", flush=True)


def chains(card: str) -> None:
    from quadrs_tpu_torch.formats import FileFormat
    from quadrs_tpu_torch.runtime import Executor
    from quadrs_tpu_torch.sources import SampleSource
    from quadrs_tpu_torch.stream import Agc, DcBlock, Shift

    rng = np.random.default_rng(5)
    raw = np.clip(np.rint(rng.normal(size=2 * (200 * 16 + 10_000)) * 40), -127, 127).astype(np.int8).view(np.uint8)
    src = SampleSource(raw, FileFormat("cs8"), 48_000)
    streams = {"dcblock 500": DcBlock(src, 500), "agc 100": Agc(src, window=100), "shift": Shift(src, 5_000),
               "shift dcblock agc": Agc(DcBlock(Shift(src, 5_000), 500), window=100)}
    offs = 16 * np.arange(200, dtype=np.int64)
    for name, stream in streams.items():
        ex = Executor(stream, 63, "cuda")
        runs = {b: np.concatenate([ex.run(offs[i:i + b])[0] for i in range(0, 200, b)]) for b in (1, 7, 200)}
        print(f"  {name}: values differing at 7 / 200 windows a batch from 1: {int((runs[7] != runs[1]).sum())} / "
              f"{int((runs[200] != runs[1]).sum())} of {runs[1].size}; max |diff| "
              f"{float(np.abs(runs[200] - runs[1]).max()):.3e} of {float(np.abs(runs[1]).max()):.4g} ({card})", flush=True)


def mix_forms(card: str) -> None:
    from chip_smoke import time_ms

    def complex_product(x, th):
        return x * torch.complex(torch.cos(th), torch.sin(th))

    def seven_passes(x, th):
        c, s = torch.cos(th), torch.sin(th)
        return torch.complex(x.real * c - x.imag * s, x.real * s + x.imag * c)

    def four_passes(x, th):  # ops.nco.rotate's CPU branch, on the card's tensors
        c, s = torch.cos(th), torch.sin(th)
        v = torch.view_as_real(x)
        p, q = v * c[..., None], v * s[..., None]
        out = torch.empty_like(p)
        torch.sub(p[..., 0], q[..., 1], out=out[..., 0])
        torch.add(q[..., 0], p[..., 1], out=out[..., 1])
        return torch.view_as_complex(out)

    forms = {"complex product": complex_product, "real planes, 7 passes": seven_passes,
             "real planes, 4 passes": four_passes}
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((58, 1_154_384), dtype=torch.complex64, device="cuda", generator=g)
    th = torch.rand((58, 1_154_384), device="cuda", generator=g) * 6.28
    for _ in range(2):
        for name, fn in forms.items():
            ms = time_ms(lambda: fn(x, th), iters=10)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            fn(x, th)
            torch.cuda.synchronize()
            print(f"  the mix at (58, 1154384): {name} {ms:.3f} ms, "
                  f"{(torch.cuda.max_memory_allocated() - base) / 2**30:.3f} GiB of temporaries ({card})", flush=True)
    xs, ts = x.reshape(-1)[: 200 * 4093].reshape(200, 4093), th.reshape(-1)[: 200 * 4093].reshape(200, 4093)
    for name, fn in forms.items():
        whole = fn(xs, ts)
        for b in (1, 7):
            parts = torch.cat([fn(xs[i:i + b], ts[i:i + b]) for i in range(0, 200, b)])
            print(f"  the mix's {name}: (200, 4093) at {b} rows a call against all at once: "
                  f"{int((parts != whole).sum())} values differ ({card})", flush=True)


STAGE = """
import json, os, sys
sys.path.insert(0, os.getcwd())
import chip_smoke as cs
print("RESULT", json.dumps(cs.stage_sparkfft(cs.card_line(), sys.argv[1], sys.argv[2])), flush=True)
"""


def stage(trees: list[str]) -> None:
    import chip_smoke as cs

    tmp = tempfile.mkdtemp()
    cap = os.path.join(tmp, "cap.sr21M.cs8")
    cs.write_capture(cap, 1 << 24)
    for tree in dict.fromkeys(trees):  # each tree's kernels built before any run is timed
        subprocess.run([sys.executable, "-c", "from quadrs_tpu_torch.ops import _cuda; _cuda.library()"],
                       cwd=os.path.abspath(tree), check=True, timeout=600)
    for tree in trees:
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-c", STAGE, cap, tempfile.mkdtemp()], cwd=os.path.abspath(tree),
                           capture_output=True, text=True, timeout=600)
        print(f"=== {tree}: stage_sparkfft rc {r.returncode} in {time.perf_counter() - t0:.1f}s", flush=True)
        print("\n".join(line for line in r.stdout.splitlines() if "│" not in line), r.stderr[-2000:], flush=True)
        if r.returncode:
            raise SystemExit(r.returncode)


def cpu() -> None:
    """On the CPU: how many values of a row change with the rows computed
    with it (one, 7 or 200 a call) and the threads (1 and 4): torch's FFT
    over 200 rows of 8192 complex64, as one call and through
    ``ops/fir.fixed_row_calls``; torch's ``mean`` and ``cumsum`` along
    rows at the trailing stages' lengths, one row a call against 58."""
    from quadrs_tpu_torch.ops.fir import fixed_row_calls

    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.normal(size=(200, 8192)) + 1j * rng.normal(size=(200, 8192))).astype(np.complex64))
    forms = {"torch.fft.fft": torch.fft.fft, "fixed_row_calls(torch.fft.fft)": lambda r: fixed_row_calls(torch.fft.fft, r, 1)}
    before = torch.get_num_threads()
    for name, fn in forms.items():
        runs = {}
        for t in (1, 4):
            torch.set_num_threads(t)
            for b in (1, 7, 200):
                runs[t, b] = per_rows(fn, x, b)
        print(f"  {name} over 200 x 8192 complex64: values differing from 1 thread, 200 rows a call, at "
              + ", ".join(f"{t} threads {b} a call {int((v != runs[1, 200]).sum())}" for (t, b), v in runs.items()),
              flush=True)
    for n in (562, 4063, 16_384, 36_062):
        for dtype in (torch.complex64, torch.float32):
            y = torch.from_numpy(rng.normal(size=(58, n)) + 1j * rng.normal(size=(58, n)) + (0.3 - 0.2j))
            y = y.to(dtype) if dtype == torch.complex64 else y.real.float()
            out = []
            for t in (1, 4):
                torch.set_num_threads(t)
                for op, fn in (("mean", lambda r: r.mean(dim=1, keepdim=True)), ("cumsum", lambda r: torch.cumsum(r, 1))):
                    whole = fn(y)
                    out.append(f"{op} at {t} threads {int((per_rows(fn, y, 1) != whole).sum())} of {whole.numel()}")
            print(f"  58 x {n} {str(dtype).split('.')[-1]}, one row a call against 58: " + ", ".join(out), flush=True)
    torch.set_num_threads(before)


def plan() -> None:
    import tracemalloc

    from quadrs_tpu_torch.sources import ToneGen

    gen = ToneGen([280_000, -230_000], 21_000_000, 0.0015, noise=0.1, seed=7)
    offs = 16 * np.arange(57, dtype=np.int64)
    tracemalloc.start()
    t0 = time.perf_counter()
    prep = gen.plan(offs, 1_154_384, 0).prep
    wall = time.perf_counter() - t0
    kept, peak = tracemalloc.get_traced_memory()
    print(json.dumps({"windows": len(offs), "samples": len(offs) * 1_154_384, "plan_s": wall,
                      "peak_gib": peak / 2**30, "kept_gib": kept / 2**30,
                      "planes": sorted(k for k in prep if k.startswith("noise"))}))


def main(argv: list[str]) -> int:
    if argv[:1] == ["plan"]:
        plan()
        return 0
    if argv[:1] == ["cpu"]:
        cpu()
        return 0
    if not torch.cuda.is_available():
        print("profile_batches: CUDA is not available; this needs one CUDA card", file=sys.stderr)
        return 1
    from chip_smoke import card_line

    card = card_line()
    print(card, flush=True)
    if argv[:1] == ["stage"]:
        stage(argv[1:])
    else:
        reductions(card)
        chains(card)
        mix_forms(card)
    print(card_line())
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
