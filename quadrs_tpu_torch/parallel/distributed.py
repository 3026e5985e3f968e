"""Several processes: the sharded steps over a mesh that spans them.

The counterpart of ``quadrs_tpu.parallel.distributed``, on
``torch.distributed``.  Nothing in :mod:`quadrs_tpu_torch.parallel.sharding`
changes but that a :class:`~quadrs_tpu_torch.parallel.sharding.Mesh` may
name each shard's process: a process computes only its own shards, each
with the single-device program on its device.

Where the JAX package moves the halo between processes (its ``ppermute``
crosses the process boundary), here no sample crosses one: each process
stages its own shards' blocks, slice and halo, from the host bytes of the
capture (a file every process reads), as the single-process mesh does.
Only what one process needs of another's output would go through a
collective; :func:`addressable_rows` gives each process its own rows.

* :func:`init_distributed`: joins the process group (``tcp://``), with the
  backend :func:`backend_for` chooses.
* :func:`make_global_mesh`: a mesh over every process's devices, in rank
  order, as ``jax.devices()`` lists them after ``jax.distributed``.
* :func:`shard_chunk_global`, :func:`replicate_tail_global`: this
  process's shards of a chunk, and of its continuation.
* :func:`addressable_rows`: this process's output shards with their
  global index.

``python -m quadrs_tpu_torch.parallel.distributed --address HOST:PORT
--processes N --rank R CAPTURE`` runs one rank of a check: the stream
chain (shift 280k, lowpass 200k, 400 taps, 64-bin FFT, ``--decimate``)
over the capture on a mesh of ``--shards`` devices a process, each rank's
rows held to the single-device run at the same global index within
``1e-5`` of scale; ``--out DIR`` also writes the rank's rows to
``DIR/rank<R>.npz``.  Run one process a rank.  Each process takes the
card, its current one, unless ``QUADRS_PLATFORM=cpu`` asks for the CPU.
"""

from __future__ import annotations

import argparse
import datetime
import json
import sys

import numpy as np
import torch
import torch.distributed as dist

from quadrs_tpu_torch.parallel.sharding import Mesh, make_mesh, to_device


def backend_for(num_processes: int) -> str:
    """The process group's backend: ``nccl`` where every rank can have a
    card of its own (CUDA, and at least ``num_processes`` cards on this
    host, rank ``r`` on ``cuda:r``), ``gloo`` otherwise: on the CPU, and
    for several ranks on one card, which NCCL refuses."""
    if torch.cuda.is_available() and torch.cuda.device_count() >= num_processes:
        return "nccl"
    return "gloo"


JOIN_TIMEOUT_S = 120.0  # how long a rank waits for the others, at the start and in each collective


def init_distributed(coordinator_address: str, num_processes: int, process_id: int) -> str:
    """Join this process to the group of ``num_processes`` at
    ``coordinator_address`` (``host:port``, rank 0's listening socket) as
    rank ``process_id``; returns the backend, :func:`backend_for`'s.  On a
    CUDA machine TF32 goes off, as in every entry point of the package,
    and an NCCL rank takes ``cuda:rank`` as its current card."""
    backend = backend_for(num_processes)
    if backend == "nccl":
        torch.cuda.set_device(process_id)
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}", world_size=num_processes,
                            rank=process_id, timeout=datetime.timedelta(seconds=JOIN_TIMEOUT_S))
    if torch.cuda.is_available():
        from quadrs_tpu_torch.ops.frontend import no_tf32

        no_tf32()
    return backend


def local_device() -> torch.device:
    """This process's device: its current card, or the CPU where
    ``QUADRS_PLATFORM=cpu`` asks for it (the CLI's rule,
    :func:`quadrs_tpu_torch.cli.select_device`, which raises without CUDA)."""
    from quadrs_tpu_torch.cli import select_device

    device = select_device()
    return torch.device("cuda", torch.cuda.current_device()) if device.type == "cuda" else device


def _rank(rank: int | None) -> int:
    if rank is not None:
        return rank
    return dist.get_rank() if dist.is_initialized() else 0


def make_global_mesh(n_time: int, n_stream: int = 1, local_devices=None) -> Mesh:
    """A ``(n_stream, n_time)`` mesh over every process's devices: each
    process's ``local_devices`` (default :func:`local_device`), gathered
    in rank order, the first ``n_time * n_stream`` taken row by row, as
    :func:`~quadrs_tpu_torch.parallel.sharding.make_mesh` takes one
    process's.  Every process of the group must call it."""
    if local_devices is None:
        local_devices = [local_device()]
    gathered: list = [None] * dist.get_world_size()
    dist.all_gather_object(gathered, [str(torch.device(d)) for d in local_devices])
    devices = [torch.device(d) for names in gathered for d in names]
    ranks = [r for r, names in enumerate(gathered) for _ in names]
    return make_mesh(n_time, n_stream, devices=devices, ranks=ranks)


def shard_chunk_global(span: np.ndarray, mesh: Mesh, halo: int = 0, rank: int | None = None):
    """This process's shards of a host chunk, as the sharded steps take
    them: ``span`` ((S, 2, n + halo) planes of a bank, or (2, n + halo) of
    one capture; every process holds the same bytes, read from a shared
    file) splits as :func:`~quadrs_tpu_torch.parallel.sharding.shard_span`
    splits it, and each of this process's shards gets its slice and the
    ``halo`` samples after it on its device.  Returns ``blocks[s][t]``,
    None for another process's shard."""
    rank = _rank(rank)
    n_time, n_rows = mesh.shape["time"], mesh.shape["stream"]
    n = span.shape[-1] - halo
    if n % n_time:
        raise ValueError(f"a chunk of {n} samples does not split into {n_time} equal time shards")
    n_local = n // n_time
    if span.ndim == 2:
        if n_rows != 1:
            raise ValueError("one capture shards over 'time' only; use a Tx1 mesh")
        rows = [span]
    else:
        if span.shape[0] % n_rows:
            raise ValueError(f"{span.shape[0]} streams do not shard over {n_rows} 'stream' mesh rows")
        per = span.shape[0] // n_rows
        rows = [span[s * per : (s + 1) * per] for s in range(n_rows)]
    return [
        [to_device(row[..., t * n_local : t * n_local + n_local + halo], mesh.devices[s][t])
         if mesh.local(s, t, rank) else None for t in range(n_time)]
        for s, row in enumerate(rows)
    ]


def replicate_tail_global(tail: np.ndarray, mesh: Mesh, rank: int | None = None):
    """The chunk's continuation (``tail``: the samples after the chunk) on
    each of this process's shards' devices, None for another process's:
    the JAX package's replicated tail.  The sharded steps take each
    block's halo inside it (:func:`shard_chunk_global`); this is for a
    caller that keeps the chunk and its tail apart."""
    rank = _rank(rank)
    return [[to_device(tail, mesh.devices[s][t]) if mesh.local(s, t, rank) else None
             for t in range(mesh.shape["time"])] for s in range(mesh.shape["stream"])]


def addressable_rows(outs) -> list[tuple[tuple, object]]:
    """This process's output shards as ``(global index, rows)``: ``outs``
    a sharded step's ``out[s][t]`` (None for another process's shard), each
    a tensor of (S_l, windows, ...) or a tuple of them; the index is the
    tuple of slices of the chunk's single-device output ((S, windows, ...),
    as :func:`~quadrs_tpu_torch.parallel.sharding.join` assembles it) that
    the shard's rows fill, and the rows come back to the host as numpy.
    Each process takes the rows it computed, with no collective."""
    got = []
    for s, row in enumerate(outs):
        for t, out in enumerate(row):
            if out is None:
                continue
            first = out[0] if isinstance(out, tuple) else out
            rows, w = first.shape[0], first.shape[1]
            index = (slice(s * rows, (s + 1) * rows), slice(t * w, (t + 1) * w)) + (slice(None),) * (first.dim() - 2)
            host = tuple(o.cpu().numpy() for o in out) if isinstance(out, tuple) else out.cpu().numpy()
            got.append((index, host))
    return got


# -- the check: one rank of the sharded stream chain ----------------------------

CHECK_TOL = 1e-5  # of the single-device run's largest norm: the shards' phase tiles start at other samples


def _check(args) -> dict:
    """One rank's part: every full chunk of the capture through the sharded
    stream step over a mesh of ``args.shards`` devices a process, and this
    rank's rows against the single-device run of the same chunks."""
    from quadrs_tpu_torch.models.receiver import PipelineConfig, PipelineModel
    from quadrs_tpu_torch.ops import frontend as fe
    from quadrs_tpu_torch.parallel.sharding import halo_samples, make_sharded_stream_step, shard_bases
    from quadrs_tpu_torch.sources import open_capture
    from quadrs_tpu_torch.stream_runner import StreamRunner

    backend = init_distributed(args.address, args.processes, args.rank)
    device = local_device()
    mesh = make_global_mesh(args.processes * args.shards, 1, [device] * args.shards)
    src = open_capture(args.capture)
    model = PipelineModel(PipelineConfig(sample_rate=src.sample_rate, shift_freq=280_000, lp_freq=200_000,
                                         decimate=args.decimate, taps=400, fft_width=64, fmt=src.format)).to(device)
    cfg, n = model.cfg, args.chunk
    win_raw = cfg.decimate * cfg.fft_width
    if n % (mesh.shape["time"] * win_raw):
        raise ValueError(f"--chunk {n} is no multiple of {mesh.shape['time']} shards of {win_raw}-sample windows")
    halo = halo_samples(cfg)
    n_local = n // mesh.shape["time"]
    fused = model.fused_supported()
    step = make_sharded_stream_step(model, mesh, frontend="fused" if fused else "chain")
    single: list[np.ndarray] = []
    StreamRunner(open_capture(args.capture), model, device, chunk_samples=n).run(lambda w0, rows: single.append(rows))
    want = np.concatenate(single)
    scale = float(want.max())
    fe.frontend_fir.launches = 0  # the sharded step's launches, from here
    err, starts, mine_rows = 0.0, [], []
    for off in range(0, src.length - n - halo + 1, n):
        blocks = shard_chunk_global(src.stage(off, off + n + halo), mesh, halo)
        bases = [[torch.from_numpy(shard_bases(model, off, n_local, n_local + halo, t)).to(device)
                  if blocks[s][t] is not None else None
                  for t in range(mesh.shape["time"])] for s in range(mesh.shape["stream"])] if fused else None
        for index, rows in addressable_rows(step(blocks, off, bases)):
            at = off // win_raw + index[1].start
            ref = want[at : at + rows.shape[1]]
            err = max(err, float(np.abs(rows[0] - ref).max()) if rows[0].shape == ref.shape else float("inf"))
            starts.append(at)
            mine_rows.append(rows[0])
    if args.out:
        np.savez(f"{args.out}/rank{args.rank}.npz", starts=np.asarray(starts, dtype=np.int64),
                 rows=np.stack(mine_rows) if mine_rows else np.zeros((0, 0, cfg.fft_width), np.float32))
    mine = {"rank": args.rank, "backend": backend, "device": str(device), "shards": len(starts),
            "rows": sum(r.shape[0] for r in mine_rows), "max_abs_err": err, "scale": scale, "fused": fused,
            "launches": fe.frontend_fir.launches}
    everyone: list = [None] * args.processes
    dist.all_gather_object(everyone, mine)
    dist.destroy_process_group()
    ok = all(r["rows"] > 0 and r["max_abs_err"] <= CHECK_TOL * r["scale"] for r in everyone)
    return {**mine, "ok": ok, "ranks": everyone}


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="python -m quadrs_tpu_torch.parallel.distributed",
                                description="One rank of the sharded stream chain over a process group, each "
                                            "rank's rows held to the single-device run.")
    p.add_argument("capture")
    p.add_argument("--address", required=True, help="HOST:PORT of rank 0's process group socket")
    p.add_argument("--processes", type=int, required=True)
    p.add_argument("--rank", type=int, required=True)
    p.add_argument("--shards", type=int, default=2, help="time shards a process")
    p.add_argument("--chunk", type=int, default=1 << 16)
    p.add_argument("--decimate", type=int, default=32)
    p.add_argument("--out", help="a directory to write this rank's rows to, as rank<R>.npz")
    got = _check(p.parse_args(argv))
    print(json.dumps(got))
    return 0 if got["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
