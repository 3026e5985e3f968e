"""The trailing stages' row reductions (``quadrs_tpu_torch.ops.rowscan``)
on the CPU.

On a CUDA tensor ``row_mean`` and ``row_exclusive_prefix`` launch the
kernels of ``csrc/rowscan.cu``, which run only on the card
(``tests/test_torch_cuda.py`` holds them against their plain versions
there).  Here: the wrappers' input checks; the CPU route, which is torch's
own ``mean`` and ``cumsum`` byte for byte, so that ``DcBlock`` and ``Agc``
on the CPU give what they gave before the kernel (a copy of that code,
below, is held to them bit for bit); the tile and the entry points'
argument lists against the source; and the stages against the JAX
package's within ``test_torch_stages.py``'s tolerances (1e-4 of the decoded
scale)."""

import pathlib
import re
from typing import Any

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from quadrs_tpu import sources as jsources  # noqa: E402
from quadrs_tpu import stream as jstream  # noqa: E402
from quadrs_tpu.formats import FileFormat as JFormat  # noqa: E402
from quadrs_tpu.runtime import Executor as JExecutor  # noqa: E402

from quadrs_tpu_torch import sources as tsources  # noqa: E402
from quadrs_tpu_torch import stream as tstream  # noqa: E402
from quadrs_tpu_torch.formats import FileFormat  # noqa: E402
from quadrs_tpu_torch.ops import _cuda  # noqa: E402
from quadrs_tpu_torch.ops import rowscan  # noqa: E402
from quadrs_tpu_torch.runtime import Executor  # noqa: E402

CPU = "cpu"
FORMATS = ["cs8", "cu8", "cf32"]
SCALE = {"cf32": 1.0, "cs8": 1.0, "cu8": 128.0}  # test_torch_stages.py's decoded scale
SOURCE = pathlib.Path(_cuda.__file__).resolve().parent.parent / "csrc" / "rowscan.cu"


def rows(shape, dtype, seed: int) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape) + 1j * rng.normal(size=shape) + (0.3 - 0.2j)
    return torch.from_numpy(x.astype(np.complex64) if dtype == torch.complex64 else x.real.astype(np.float32))


# ------------------------------------------------------ the wrappers


BAD_INPUTS = {
    "float64": (lambda: torch.zeros((2, 5), dtype=torch.float64), None, "float32 or complex64"),
    "int32": (lambda: torch.zeros((2, 5), dtype=torch.int32), None, "float32 or complex64"),
    "one dim": (lambda: torch.zeros(5), None, r"\(B, L\)"),
    "three dims": (lambda: torch.zeros((2, 5, 1)), None, r"\(B, L\)"),
    "no rows": (lambda: torch.zeros((0, 5)), None, r"B >= 1"),
    "empty rows": (lambda: torch.zeros((2, 0)), None, r"L >= 1"),
    "sub's dtype": (lambda: torch.zeros((2, 5)), lambda: torch.zeros((2, 1), dtype=torch.complex64), "sub must be"),
    "sub's shape": (lambda: torch.zeros((2, 5)), lambda: torch.zeros((2,)), "sub must be"),
    "sub per column": (lambda: torch.zeros((2, 5)), lambda: torch.zeros((1, 5)), "sub must be"),
    "sub's device": (lambda: torch.zeros((2, 5)), lambda: torch.zeros((2, 1), device="meta"), "sub must be"),
    "meta rows": (lambda: torch.zeros((2, 5), device="meta"), None, "cuda or cpu"),
}


@pytest.mark.parametrize("case", list(BAD_INPUTS))
def test_wrappers_check_their_inputs(case):
    """Both wrappers raise on what the kernels do not take, on every
    device, and count no launch."""
    make_x, make_sub, match = BAD_INPUTS[case]
    before = (rowscan.row_mean.launches, rowscan.row_exclusive_prefix.launches)
    with pytest.raises(ValueError, match=match):
        rowscan.row_exclusive_prefix(make_x(), None if make_sub is None else make_sub())
    if make_sub is None:
        with pytest.raises(ValueError, match=match):
            rowscan.row_mean(make_x())
    assert (rowscan.row_mean.launches, rowscan.row_exclusive_prefix.launches) == before


SHAPES = [(1, 1), (3, 5000), (7, rowscan.TILE + 1), (58, 4063)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.complex64], ids=["f32", "c64"])
@pytest.mark.parametrize("shape", SHAPES, ids=[f"{b}x{n}" for b, n in SHAPES])
def test_cpu_route_is_torchs_own(shape, dtype):
    """A CPU tensor takes the plain versions, which are torch's ``mean`` and
    ``cumsum`` (the code the stages ran before the kernel), bit for bit,
    with a view's rows as with a copy's; no kernel launch is counted."""
    x = rows(shape, dtype, seed=shape[1])
    before = (rowscan.row_mean.launches, rowscan.row_exclusive_prefix.launches)
    mean = rowscan.row_mean(x)
    assert mean.dtype == dtype and mean.shape == (shape[0], 1)
    assert torch.equal(mean, x.mean(dim=1, keepdim=True))
    for sub in (None, mean):
        v = x if sub is None else x - sub
        want = torch.cat([torch.zeros_like(v[:, :1]), torch.cumsum(v, dim=1)], dim=1)
        got = rowscan.row_exclusive_prefix(x, sub)
        assert got.dtype == dtype and got.shape == (shape[0], shape[1] + 1)
        assert got.numpy().tobytes() == want.numpy().tobytes()
    wide = rows((shape[0], shape[1] + 3), dtype, seed=shape[1])[:, 1 : shape[1] + 1]
    assert rowscan.row_exclusive_prefix(wide).numpy().tobytes() == rowscan.row_exclusive_prefix(
        wide.contiguous()).numpy().tobytes()
    assert (rowscan.row_mean.launches, rowscan.row_exclusive_prefix.launches) == before


def test_tile_and_entry_points_match_the_source():
    """``TILE`` is the kernel's ``kTile`` (kThreads x kPer), and each entry
    point's ctypes argument list has its C prototype's length."""
    src = SOURCE.read_text()
    consts = {k: int(v) for k, v in re.findall(r"constexpr int (kThreads|kPer) = (\d+);", src)}
    assert "constexpr int kTile = kThreads * kPer;" in src
    assert rowscan.TILE == consts["kThreads"] * consts["kPer"]
    assert SOURCE in _cuda._SOURCES
    for name in ("qt_row_sum", "qt_row_exclusive_prefix"):
        proto = re.search(rf"int {name}\(([^)]*)\)", src).group(1)
        assert len(proto.split(",")) == len(_cuda._SIGNATURES[name]), name


@pytest.mark.parametrize("n,tiles", [(1, 1), (rowscan.TILE - 1, 1), (rowscan.TILE, 1), (rowscan.TILE + 1, 2),
                                     (36_062, 9)])
def test_scratch_counts_tiles(n, tiles):
    x = torch.zeros((5, n), dtype=torch.complex64)
    assert rowscan._scratch(x, 2).shape == (2, 5, tiles, 2)
    assert rowscan._scratch(x.real.contiguous(), 1).shape == (1, 5, tiles, 1)


# ------------------------------------------------------ the stages


class PlainDcBlock(tstream.DcBlock):
    """DcBlock's read as it was before the row-scan kernel."""

    def read_batch(self, ctx: dict, prep: Any, n: int) -> torch.Tensor:
        x = self._inner_block(ctx, prep, n)
        if self.window == 1:
            return torch.zeros((x.shape[0], n), dtype=x.dtype, device=x.device)
        x = x - x.mean(dim=1, keepdim=True)
        cs = torch.cat([torch.zeros_like(x[:, :1]), torch.cumsum(x, dim=1)], dim=1)
        _, hi, lo = tstream._tw_indices(prep["lead"], n, self.window)
        dc = (torch.gather(cs, 1, hi) - torch.gather(cs, 1, lo)) / tstream._tw_count(prep["abs_c"], n, self.window)
        return self._mask_valid(self._current(x, prep, n) - dc, prep, n)


class PlainAgc(tstream.Agc):
    """Agc's read as it was before the row-scan kernel."""

    def read_batch(self, ctx: dict, prep: Any, n: int) -> torch.Tensor:
        x = self._inner_block(ctx, prep, n)
        p = x.real**2 + x.imag**2
        cs = torch.cat([torch.zeros_like(p[:, :1]), torch.cumsum(p, dim=1)], dim=1)
        _, hi, lo = tstream._tw_indices(prep["lead"], n, self.window)
        psum = torch.gather(cs, 1, hi) - torch.gather(cs, 1, lo)
        rms = torch.sqrt(torch.clamp(psum, min=0.0) / tstream._tw_count(prep["abs_c"], n, self.window))
        return self._mask_valid(self._current(x, prep, n) * self._gain(rms), prep, n)


def capture_bytes(fmt: str, n: int, seed: int = 5) -> np.ndarray:
    """``n`` seeded samples of ``fmt``: noise with a DC offset and a slow
    swell (test_torch_stages.py's capture)."""
    rng = np.random.default_rng(seed)
    swell = 0.2 + np.abs(np.sin(np.arange(n) * 3e-3))
    x = (rng.normal(size=n) + 1j * rng.normal(size=n)) * swell + (0.3 - 0.2j)
    if fmt == "cf32":
        return np.ascontiguousarray(x.astype(np.complex64)).view(np.uint8)
    iq = np.stack([x.real, x.imag], axis=-1) * 40
    if fmt == "cs8":
        return np.clip(np.rint(iq), -127, 127).astype(np.int8).view(np.uint8).reshape(-1)
    return np.clip(np.rint(iq + 127.5), 0, 255).astype(np.uint8).reshape(-1)


# (dcblock window, agc window, outputs a window): the batch-invariance
# chain's, and windows past one tile of the kernel
WINDOWS = [(500, 100, 63), (5_000, 4_500, 300)]
SR = 48_000


def chain(mod, src, dc: int, agc: int, dc_cls=None, agc_cls=None):
    dc_cls, agc_cls = dc_cls or mod.DcBlock, agc_cls or mod.Agc
    return agc_cls(dc_cls(mod.Shift(src, 5_000, SR), dc), window=agc)


@pytest.mark.parametrize("dc,agc,n", WINDOWS)
@pytest.mark.parametrize("fmt", FORMATS)
def test_stages_on_the_cpu_are_the_plain_code(fmt, dc, agc, n):
    """``shift dcblock agc`` and each stage alone through the executor: bit
    for bit the code before the kernel, in batches of 1 and of all."""
    raw = capture_bytes(fmt, 12_000)
    src = tsources.SampleSource(raw, FileFormat(fmt), SR)
    offs = np.linspace(0, 12_000 - n, 24).astype(np.int64)
    cases = {
        "chain": (chain(tstream, src, dc, agc), chain(tstream, src, dc, agc, PlainDcBlock, PlainAgc)),
        "dcblock": (tstream.DcBlock(src, dc), PlainDcBlock(src, dc)),
        "agc": (tstream.Agc(src, window=agc), PlainAgc(src, window=agc)),
    }
    for name, (stage, plain) in cases.items():
        want = Executor(plain, n, CPU).run(offs)[0]
        for batch in (1, len(offs)):
            got = np.concatenate([Executor(stage, n, CPU).run(offs[i : i + batch])[0]
                                  for i in range(0, len(offs), batch)])
            assert got.tobytes() == want.tobytes(), (name, batch, int(np.sum(got != want)))


@pytest.mark.parametrize("dc,agc,n", WINDOWS)
@pytest.mark.parametrize("fmt", FORMATS)
def test_stages_match_jax(fmt, dc, agc, n):
    """``shift dcblock agc`` through both packages' executors: within
    1e-4 of the decoded scale (the stage tests' bound)."""
    raw = capture_bytes(fmt, 12_000)
    offs = np.linspace(0, 12_000 - n, 16).astype(np.int64)
    port = chain(tstream, tsources.SampleSource(raw, FileFormat(fmt), SR), dc, agc)
    jax_ = chain(jstream, jsources.SampleSource(raw, JFormat(fmt), SR), dc, agc)
    got, valid = Executor(port, n, CPU).run(offs)
    want, want_valid = JExecutor(jax_, n).run(offs)
    assert np.array_equal(valid, np.asarray(want_valid))
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4, atol=1e-4 * SCALE[fmt])
