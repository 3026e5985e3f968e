"""Several processes on ``torch.distributed``
(``quadrs_tpu_torch.parallel.distributed``), the port's counterpart of
``tests/test_distributed.py``: two processes join a gloo group on the CPU
(``QUADRS_PLATFORM=cpu``), each stages and computes only its own shards
of a mesh that spans both, and each one's ``addressable_rows`` must equal
the single-device rows at the same global index (within ``1e-5`` of
scale: the shards' phase tiles start at other samples, the stream mesh's
bound) and the JAX package's ``StreamRunner`` rows over the same capture
(within ``5e-5`` of scale, the port's bound against the JAX package in
``tests/test_torch_sharding.py``).  Each worker runs with a timeout of
its own, so a hung worker fails the test.

In one process: a mesh's ranks, each process's blocks of a chunk (as
``shard_span`` places them), the replicated tail, and the rows of the two
halves of a mesh computed one process at a time against the whole mesh's
joined output."""

import json
import os
import pathlib
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from quadrs_tpu import sources as jsources  # noqa: E402
from quadrs_tpu import stream_runner as jrunner  # noqa: E402
from quadrs_tpu.models.receiver import PipelineConfig as JConfig  # noqa: E402
from quadrs_tpu.models.receiver import PipelineModel as JModel  # noqa: E402

from quadrs_tpu_torch.formats import FileFormat  # noqa: E402
from quadrs_tpu_torch.models.receiver import PipelineConfig, PipelineModel  # noqa: E402
from quadrs_tpu_torch.models.waterfall import WaterfallConfig, WaterfallModel  # noqa: E402
from quadrs_tpu_torch.parallel import distributed as tdist  # noqa: E402
from quadrs_tpu_torch.parallel import sharding as tsh  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
WORKER_TIMEOUT = 120  # s, each worker
JAX_TOL = 5e-5  # the port against the JAX package, of the largest norm


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def write_cs8(path: pathlib.Path, n: int, seed: int) -> str:
    rng = np.random.default_rng(seed)
    rng.integers(-127, 128, 2 * n, dtype=np.int64).astype(np.int8).tofile(path)
    return str(path)


def jax_rows(cap: str, decimate: int, chunk: int) -> np.ndarray:
    """The JAX package's single-device ``StreamRunner`` rows over the
    capture, at the check's stream configuration."""
    src = jsources.SampleSource.from_file(cap)
    model = JModel(JConfig(sample_rate=src.sample_rate, shift_freq=280_000, lp_freq=200_000, decimate=decimate,
                           taps=400, fft_width=64, fmt=src.format))
    rows: list[np.ndarray] = []
    jrunner.StreamRunner(src, model, chunk_samples=chunk).run(lambda w0, r: rows.append(np.asarray(r)))
    return np.concatenate(rows)


@pytest.mark.parametrize("extra", [[], ["--decimate", "100", "--chunk", "256000"]], ids=["fused", "chain"])
def test_two_processes_rows_equal_single_device(tmp_path, extra):
    """Two ranks of two shards each over the stream chain (the fused route
    at decimate 32; the chain of torch ops at decimate 100): every rank's
    rows at their global index equal the single-device run's and the JAX
    package's, and both ranks see each other's result through the group."""
    cap = write_cs8(tmp_path / "cap.sr21M.cs8", 1 << 19 if not extra else 1 << 20, seed=7)
    address = f"127.0.0.1:{free_port()}"
    env = {**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1", "QUADRS_PLATFORM": "cpu"}
    procs = [subprocess.Popen([sys.executable, "-m", "quadrs_tpu_torch.parallel.distributed", "--address", address,
                               "--processes", "2", "--rank", str(r), "--shards", "2", "--out", str(tmp_path), *extra,
                               cap],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
             for r in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=WORKER_TIMEOUT)
            assert p.returncode == 0, err
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, got in enumerate(outs):
        assert got["ok"] and got["rank"] == r and got["backend"] == "gloo" and got["fused"] == (not extra)
        assert got["device"] == "cpu"
        assert got["shards"] > 0 and got["rows"] > 0 and got["max_abs_err"] <= 1e-5 * got["scale"]
        assert [x["rank"] for x in got["ranks"]] == [0, 1]
    assert outs[0]["rows"] == outs[1]["rows"]
    decimate, chunk = (100, 256000) if extra else (32, 1 << 16)
    want = jax_rows(cap, decimate, chunk)
    scale = float(want.max())
    covered = set()
    for r in range(2):
        saved = np.load(tmp_path / f"rank{r}.npz")
        assert len(saved["starts"]) == outs[r]["shards"]
        for at, rows in zip(saved["starts"], saved["rows"]):
            np.testing.assert_allclose(rows, want[at : at + rows.shape[0]], rtol=0, atol=JAX_TOL * scale,
                                       err_msg=f"rank {r}, windows from {at}")
            covered.update(range(at, at + rows.shape[0]))
    assert covered == set(range(len(covered)))  # the two ranks' rows tile the full chunks


def test_backend_rule(monkeypatch):
    """NCCL where each rank has a card of its own; gloo on the CPU and for
    several ranks on one card."""
    assert tdist.backend_for(2) == ("nccl" if torch.cuda.device_count() >= 2 else "gloo")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert (tdist.backend_for(1), tdist.backend_for(2)) == ("nccl", "gloo")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert tdist.backend_for(4) == "nccl"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tdist.backend_for(1) == "gloo"


def test_local_device_follows_the_cli(monkeypatch):
    """A process's device is the CLI's: the CPU under
    ``QUADRS_PLATFORM=cpu``, else its current card, and no CPU fallback
    where there is none."""
    monkeypatch.setenv("QUADRS_PLATFORM", "cpu")
    assert tdist.local_device() == CPU
    monkeypatch.delenv("QUADRS_PLATFORM")
    if torch.cuda.is_available():
        assert tdist.local_device() == torch.device("cuda", torch.cuda.current_device())
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tdist.local_device()


def test_mesh_with_ranks():
    mesh = tsh.make_mesh(2, 2, devices=[CPU] * 4, ranks=[0, 0, 1, 1])
    assert mesh.ranks == ((0, 0), (1, 1)) and mesh.shape == {"stream": 2, "time": 2}
    assert mesh.local(0, 1, 0) and not mesh.local(1, 0, 0) and mesh.local(1, 0, 1)
    assert mesh == tsh.make_mesh(2, 2, devices=[CPU] * 4, ranks=[0, 0, 1, 1])
    assert mesh != tsh.make_mesh(2, 2, devices=[CPU] * 4) and hash(mesh) != hash(tsh.make_mesh(2, 2, devices=[CPU] * 4))
    assert all(tsh.make_mesh(4, devices=[CPU] * 4).local(0, t, 3) for t in range(4))
    with pytest.raises(ValueError, match="ranks"):
        tsh.Mesh([[CPU, CPU]], ranks=[[0]])


@pytest.mark.parametrize("bank", [False, True])
def test_each_process_gets_its_blocks(bank):
    """``shard_chunk_global`` gives a process ``shard_span``'s blocks of its
    own shards and None elsewhere; over the ranks, every block once."""
    rng = np.random.default_rng(3)
    halo = 37
    shape = (4, 2, 1200 + halo) if bank else (2, 1200 + halo)
    span = rng.integers(-127, 128, shape, dtype=np.int64).astype(np.int8)
    n_stream = 2 if bank else 1
    mesh = tsh.make_mesh(3 if not bank else 2, n_stream, devices=[CPU] * (3 if not bank else 4),
                         ranks=[0, 1, 1] if not bank else [0, 1, 1, 0])
    want = tsh.shard_span(span, mesh, halo)
    seen = 0
    for rank in (0, 1):
        got = tdist.shard_chunk_global(span, mesh, halo, rank=rank)
        tails = tdist.replicate_tail_global(span[..., -halo:], mesh, rank=rank)
        for s, row in enumerate(got):
            for t, block in enumerate(row):
                if mesh.local(s, t, rank):
                    assert torch.equal(block, want[s][t]) and torch.equal(tails[s][t], torch.from_numpy(span[..., -halo:]))
                    seen += 1
                else:
                    assert block is None and tails[s][t] is None
    assert seen == mesh.shape["time"] * n_stream
    with pytest.raises(ValueError, match="equal time shards"):
        tdist.shard_chunk_global(span[..., :-1], mesh, halo, rank=0)


def _stream_model():
    return PipelineModel(PipelineConfig(sample_rate=21_000_000, shift_freq=280_000, lp_freq=200_000, decimate=32,
                                        taps=400, fft_width=64, fmt=FileFormat.COMPLEX_INT8))


@pytest.mark.parametrize("frontend", ["fused", "chain"])
def test_addressable_rows_of_each_process_fill_the_joined_output(frontend):
    """The stream step over a 4-shard mesh of two processes, run one
    process at a time: each process's rows, placed at their global index,
    give the whole mesh's joined output, bit for bit."""
    model = _stream_model()
    cfg = model.cfg
    halo = tsh.halo_samples(cfg)
    n, off = 4 * 2048 * 8, 123 * 2048
    rng = np.random.default_rng(9)
    span = rng.integers(-127, 128, (2, n + halo), dtype=np.int64).astype(np.int8)
    split = tsh.make_mesh(4, devices=[CPU] * 4, ranks=[0, 0, 1, 1])
    whole = tsh.make_mesh(4, devices=[CPU] * 4)
    n_local = n // 4

    def bases_for(blocks):
        if frontend != "fused":
            return None
        return [[torch.from_numpy(tsh.shard_bases(model, off, n_local, n_local + halo, t)) if b is not None else None
                 for t, b in enumerate(row)] for row in blocks]

    blocks = tsh.shard_span(span, whole, halo)
    want = tsh.join(tsh.make_sharded_stream_step(model, whole, frontend=frontend)(blocks, off, bases_for(blocks)), 1)
    got = np.full(tuple(want.shape), np.nan, dtype=np.float32)
    step = tsh.make_sharded_stream_step(model, split, frontend=frontend)
    for rank in (0, 1):
        mine = tdist.shard_chunk_global(span, split, halo, rank=rank)
        rows = tdist.addressable_rows(step(mine, off, bases_for(mine)))
        assert len(rows) == 2
        for index, r in rows:
            got[index] = r
    assert got.tobytes() == want.numpy().tobytes()


def test_addressable_rows_of_a_bank():
    """The waterfall step over a 2x2 mesh whose rows are two processes: the
    global index spans each row's streams."""
    model = WaterfallModel(WaterfallConfig(n_streams=4, fft_width=256, stride=128, fmt=FileFormat.COMPLEX_INT8))
    halo = tsh.waterfall_halo(model.cfg)
    rng = np.random.default_rng(11)
    span = rng.integers(-127, 128, (4, 2, 2 * 128 * 6 + halo), dtype=np.int64).astype(np.int8)
    whole = tsh.make_mesh(2, 2, devices=[CPU] * 4)
    split = tsh.make_mesh(2, 2, devices=[CPU] * 4, ranks=[0, 0, 1, 1])
    want = tsh.join(tsh.make_sharded_waterfall_step(model, whole)(tsh.shard_span(span, whole, halo)), 1)
    got = np.full(tuple(want.shape), np.nan, dtype=np.float32)
    step = tsh.make_sharded_waterfall_step(model, split)
    for rank in (0, 1):
        for index, rows in tdist.addressable_rows(step(tdist.shard_chunk_global(span, split, halo, rank=rank))):
            assert index[0] == slice(2 * rank, 2 * rank + 2)
            got[index] = rows
    assert got.tobytes() == want.numpy().tobytes()
