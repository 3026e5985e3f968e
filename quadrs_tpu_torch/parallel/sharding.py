"""Multi-device execution: time-sharded streaming over a device mesh.

The counterpart of ``quadrs_tpu.parallel.sharding``.  The time axis is
sharded: each device of a ``(stream, time)`` mesh computes a contiguous
slice of the capture with the same single-device program the port
already runs (the fused frontend or the chain of torch ops, the
waterfall kernels, the matched filter, the channelizer's bank).  A
second mesh axis shards independent streams (the bank).

Where the JAX package moves each shard's halo (the samples past its
slice that its last outputs read) from its right neighbour over ICI
(``ppermute``), and feeds the last shard the chunk's true continuation,
the port stages each shard's block (its slice and its halo) straight
from the host bytes the caller already holds, as the JAX package stages
its ``tail``: no copy between devices and no ordering across devices to
get right.  The outputs are the same: every window is the exact
streaming continuation.

NCO phase coherence costs nothing: each shard's phase is planned on the
host from its absolute offset (the fused route's per-tile bases by
``PipelineModel.stream_bases``, the chain's first-sample angle by
``PipelineModel.theta0``), so no carry passes between devices.

A mesh may name one device more than once: a one-card machine stands
for a mesh by repeating its card, and the CPU platform's default mesh is
the CPU eight times over, as the JAX package's tests run on 8 virtual
CPU devices.  A mesh may also span processes
(:mod:`quadrs_tpu_torch.parallel.distributed`): each shard then names
its process's rank beside its device, and a process computes only its
own shards.
"""

from __future__ import annotations

import copy
import os
from typing import Callable

import numpy as np
import torch

from quadrs_tpu_torch.formats import FileFormat, decode_plane

# the CPU platform's default mesh devices: the JAX package's tests see the
# CPU as 8 virtual devices (tests/conftest.py sets
# --xla_force_host_platform_device_count=8)
CPU_MESH_DEVICES = 8


class Mesh:
    """A ``(stream, time)`` grid of torch devices, the JAX package's
    ``Mesh(grid, ("stream", "time"))``.  ``shape["stream"]`` rows of
    ``shape["time"]`` devices; ``devices[s][t]`` holds shard ``(s, t)``.
    ``ranks``: a grid alike of process ranks, for a mesh that spans
    processes; ``devices[s][t]`` is then a device of process
    ``ranks[s][t]`` (None: every shard is this process's).  Equal grids
    compare and hash equal, so a memoized step serves every mesh made
    alike."""

    def __init__(self, devices, ranks=None):
        grid = tuple(tuple(torch.device(d) for d in row) for row in devices)
        if not grid or not grid[0] or len({len(row) for row in grid}) != 1:
            raise ValueError("a mesh is a non-empty (stream, time) grid of devices")
        self.devices = grid
        self.shape = {"stream": len(grid), "time": len(grid[0])}
        self.ranks = None if ranks is None else tuple(tuple(int(r) for r in row) for row in ranks)
        if self.ranks is not None and [len(row) for row in self.ranks] != [len(row) for row in grid]:
            raise ValueError("a mesh's ranks are a grid of the shape of its devices")

    @property
    def distinct(self) -> list[torch.device]:
        """The mesh's devices, each once, in grid order."""
        return list(dict.fromkeys(d for row in self.devices for d in row))

    def local(self, s: int, t: int, rank: int) -> bool:
        """Whether shard ``(s, t)`` is process ``rank``'s."""
        return self.ranks is None or self.ranks[s][t] == rank

    def __eq__(self, other) -> bool:
        return isinstance(other, Mesh) and (other.devices, other.ranks) == (self.devices, self.ranks)

    def __hash__(self) -> int:
        return hash((self.devices, self.ranks))


def default_devices() -> list[torch.device]:
    """The devices a mesh takes by default: on the CPU platform
    (``QUADRS_PLATFORM=cpu``) the CPU 8 times over; otherwise every CUDA
    card, each by its index."""
    if os.environ.get("QUADRS_PLATFORM") == "cpu":
        return [torch.device("cpu")] * CPU_MESH_DEVICES
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(n_time: int, n_stream: int = 1, devices=None, ranks=None) -> Mesh:
    """A ``(n_stream, n_time)`` mesh over the first ``n_time * n_stream``
    of ``devices`` (default :func:`default_devices`), row by row.  A
    device may repeat.  ``ranks``: each device's process, for a mesh over
    several processes (:func:`quadrs_tpu_torch.parallel.distributed.make_global_mesh`)."""
    devices = list(devices if devices is not None else default_devices())
    if len(devices) < n_time * n_stream:
        raise ValueError(f"need {n_time * n_stream} devices, have {len(devices)}")
    rows = [slice(s * n_time, (s + 1) * n_time) for s in range(n_stream)]
    ranks = None if ranks is None else list(ranks)
    return Mesh([devices[r] for r in rows], None if ranks is None else [ranks[r] for r in rows])


def mesh_of(shape: tuple[int, int] | None) -> Mesh | None:
    """The mesh a command's ``-mesh TxS`` names (``shape``: (time,
    stream)) over the default devices, or None without one."""
    return None if shape is None else make_mesh(n_time=shape[0], n_stream=shape[1])


def halo_samples(cfg) -> int:
    """Samples a shard needs past its local slice: its last FIR output
    ``y[i]`` reads ``x[i*D + ceil(taps/2) .. i*D + ceil(taps/2) + taps)``,
    i.e. ``ceil(taps/2) + taps - D`` beyond the local extent."""
    half_up = cfg.taps - cfg.taps // 2
    return max(cfg.taps, cfg.taps + half_up - cfg.decimate)


def _replicas(model) -> Callable[[torch.device], object]:
    """``on(device)``: the model on ``device``; the model itself where its
    buffers are, elsewhere a copy made once (a rectangular waterfall
    model has no buffers, and its planned tables follow the device)."""
    reps: dict[torch.device, object] = {}

    def on(device: torch.device):
        if device == next((b.device for b in model.buffers()), None):
            return model
        if device not in reps:
            reps[device] = copy.deepcopy(model).to(device)
        return reps[device]

    return on


def _check_grid(blocks, mesh: Mesh) -> None:
    if len(blocks) != mesh.shape["stream"] or any(len(row) != mesh.shape["time"] for row in blocks):
        raise ValueError(f"blocks must be a {mesh.shape['stream']} x {mesh.shape['time']} grid, one per shard")


def _memo(model, key, build):
    """The step ``build()`` makes, memoized on the model per ``key``: a
    runner made per connection reuses its replicas and tables."""
    cache = model.__dict__.setdefault("_sharded_step_cache", {})
    if key not in cache:
        cache[key] = build()
    return cache[key]


FRONTENDS = ("auto", "fused", "chain")


def make_sharded_stream_step(model, mesh: Mesh, search: bool = False, frontend: str = "auto"):
    """The multi-device streaming step: ``step(blocks, off, bases=None)``.

    ``blocks[s][t]``: shard ``(s, t)``'s native planes, (2, n_local +
    halo) (or (1, 2, n_local + halo), as :func:`shard_span` places a
    bank's) on ``mesh.devices[s][t]``: stream ``s``'s samples from ``off +
    t * n_local``, its slice and then its :func:`halo_samples` halo (the
    next shard's head, or the chunk's true continuation for the last
    shard; zeros at EOF).  Every stream of a bank starts at ``off``.
    ``bases``: on the fused route, ``bases[s][t]`` is shard ``(s, t)``'s
    per-tile NCO bases on its device, from :func:`shard_bases` (the
    runner plans them on its staging thread and stages them beside the
    planes); the chain plans its first-sample phase here.  A shard of
    another process (a mesh over several) has None for its block, and
    None for its output.

    Returns ``out[s][t]``: shard ``(s, t)``'s (1, windows, fft_width)
    f32 norms, or with ``search`` its peak bins and magnitudes, each
    (1, windows); :func:`join` assembles them in (stream, time) order.
    Each shard runs the single-device route of ``frontend`` (``auto``:
    the fused frontend inside its envelope, the chain of torch ops
    outside it) on its device's current stream.

    Memoized on the model per (mesh, search, frontend)."""
    if frontend not in FRONTENDS:
        raise ValueError(f"frontend must be one of {FRONTENDS}, got {frontend!r}")
    cfg = model.cfg
    if cfg.taps // (2 * cfg.decimate) >= cfg.fft_width:
        raise ValueError("fft window shorter than the FIR group delay span")
    if frontend == "fused" and not model.fused_supported():
        raise ValueError(
            f"decimate {cfg.decimate} with {cfg.taps} taps is outside the fused frontend's envelope: "
            "use frontend='chain' or 'auto'"
        )
    fused = frontend == "fused" or (frontend == "auto" and model.fused_supported())

    def build():
        halo = halo_samples(cfg)
        on = _replicas(model)

        def step(blocks, off: int, bases=None):
            _check_grid(blocks, mesh)
            outs = []
            for s, row in enumerate(blocks):
                outs.append([])
                for t, block in enumerate(row):
                    if block is None:  # another process's shard
                        outs[s].append(None)
                        continue
                    if block.dim() == 3:
                        (block,) = block  # one stream a mesh row
                    n_local = block.shape[-1] - halo
                    if n_local < halo:
                        raise ValueError(
                            f"per-shard slice of {n_local} samples is shorter than the {halo}-sample "
                            f"halo; use chunks of at least {halo} samples per time-shard"
                        )
                    m = on(block.device)
                    if fused:
                        if bases is None:
                            raise ValueError("the fused route takes each shard's NCO bases (shard_bases)")
                        out = (m.step_stream_fused_search if search else m.step_stream_fused)(block, bases[s][t])
                    else:
                        theta0 = m.theta0(np.asarray([int(off) + t * n_local]))[0]
                        out = (m.step_stream_search if search else m.step_stream)(block, theta0)
                    outs[s].append(tuple(o[None] for o in out) if search else out[None])
            return outs

        return step

    return _memo(model, ("stream", mesh, search, frontend), build)


def shard_bases(model, off: int, n_local: int, cols: int, t: int) -> np.ndarray:
    """Time shard ``t``'s per-tile NCO bases on the fused route, for a
    block of ``cols`` samples (its slice and halo) of a chunk that starts
    at sample ``off`` and gives each shard ``n_local``: planned on the
    host from the shard's absolute offset, exact at any offset, so no
    phase passes between shards."""
    return model.stream_bases(off + t * n_local, cols)


def waterfall_halo(cfg) -> int:
    """Samples a waterfall time-shard needs past its local slice: the
    window starting at its last stride cell reads ``fft_width - stride``
    beyond the local extent (zero for tiling and skipping strides)."""
    return max(0, cfg.fft_width - cfg.stride)


def make_sharded_waterfall_step(model, mesh: Mesh, search: bool = False):
    """The multi-device waterfall bank: ``step(blocks)``.

    ``blocks[s][t]``: (S_l, 2, n_local + halo) native planes on
    ``mesh.devices[s][t]``: mesh row ``s``'s ``S_l`` streams over time
    shard ``t``'s slice, a whole number of ``stride`` cells, and its
    :func:`waterfall_halo` halo (the next shard's head, or the chunk's
    true continuation for the last shard; zeros at EOF, whose windows
    the caller drops).  Returns ``out[s][t]``: (S_l, n_local // stride,
    fft_width) f32 norms, or with ``search`` the per-window peak bins and
    magnitudes; each shard runs the single-device model (the waterfall
    kernels on a card).  A shard of another process has None for its
    block and for its output.

    Memoized on the model per (mesh, search)."""
    cfg = model.cfg

    def build():
        halo = waterfall_halo(cfg)
        on = _replicas(model)

        def step(blocks):
            _check_grid(blocks, mesh)
            outs = []
            for row in blocks:
                outs.append([])
                for block in row:
                    if block is None:  # another process's shard
                        outs[-1].append(None)
                        continue
                    n_local = block.shape[-1] - halo
                    if n_local % cfg.stride:
                        raise ValueError(
                            f"per-shard slice of {n_local} samples is not a whole "
                            f"number of {cfg.stride}-sample stride cells"
                        )
                    if halo and n_local < halo:
                        raise ValueError(
                            f"per-shard slice of {n_local} samples is shorter than the {halo}-sample window halo"
                        )
                    m = on(block.device)
                    outs[-1].append(m.search(block) if search else m.step(block))
            return outs

        return step

    return _memo(model, ("waterfall", mesh, search), build)


def find_halo(pattern_len: int) -> int:
    """Samples a matched-filter time-shard needs past its local slice: the
    score at its last local lag reads ``pattern_len - 1`` samples into its
    right neighbour, the analogue of the FIR halo (:func:`halo_samples`)."""
    return pattern_len - 1


def _decoded(block: torch.Tensor, fmt: FileFormat) -> torch.Tensor:
    """(2, n) native planes -> (n,) complex64, the sources' decode."""
    return torch.complex(decode_plane(block[0], fmt), decode_plane(block[1], fmt))


def make_sharded_find_step(pattern, c: int, fmt: FileFormat, mesh: Mesh, freqs=None):
    """The multi-device matched filter behind ``sinks.find_pattern(mesh=...)``:
    ``step(blocks)``.

    ``blocks[0][t]``: time shard ``t``'s native capture planes, (2,
    n_local + l - 1) on ``mesh.devices[0][t]``: its slice, a whole number
    of ``n_out = c - l + 1`` lag cells, and its :func:`find_halo` halo.
    Each shard decodes on its device, cuts its block into overlap-save
    windows of ``c`` samples at multiples of ``n_out`` (the single-device
    executor's partition) and scores every local lag with the
    single-device program (:func:`~quadrs_tpu_torch.ops.correlate.make_xcorr_post`).
    Returns ``out[0][t] = (score, scale, ridx)``, each (n_local,): entry
    ``i`` is lag ``t * n_local + i`` of the dispatch."""
    from quadrs_tpu_torch.ops.correlate import make_xcorr_post

    pats = [np.asarray(p) for p in pattern] if isinstance(pattern, (list, tuple)) else [np.asarray(pattern)]
    l = max(len(p) for p in pats)
    n_out = c - l + 1
    if mesh.shape["stream"] != 1:
        raise ValueError("the matched filter shards one capture over 'time'; use a Tx1 mesh")
    compute = make_xcorr_post(pats, c, freqs)

    def step(blocks):
        _check_grid(blocks, mesh)
        outs = []
        for block in blocks[0]:
            n_loc = block.shape[-1] - (l - 1)
            if n_loc % n_out:
                raise ValueError(f"per-shard slice of {n_loc} samples is not a whole number of {n_out}-lag cells")
            frames = _decoded(block, fmt).unfold(0, c, n_out)  # (n_loc // n_out, c)
            outs.append(tuple(o.reshape(-1) for o in compute(frames.contiguous())))
        return [outs]

    return step


def channelize_halo(size: int) -> int:
    """Input samples a channelizer time-shard needs past its K-aligned
    local slice: the bank's span arithmetic is LowPass-with-decimate-K
    (``n*D + taps`` raw samples per ``n`` outputs), so the last local
    output's window reads ``size`` samples into the right neighbour."""
    return size


def make_sharded_channelize_step(taps, k: int, fmt: FileFormat, mesh: Mesh):
    """The multi-device polyphase channelizer behind
    ``run_channelize(mesh=...)``: ``step(blocks)``.

    ``blocks[0][t]``: time shard ``t``'s native capture planes, (2,
    n_local + size) on ``mesh.devices[0][t]``: its slice, a whole number
    of ``k``-sample output cells and at least ``size`` samples, and its
    :func:`channelize_halo` halo.  Each shard decodes on its device and
    runs the single-device bank
    (:func:`~quadrs_tpu_torch.ops.channelizer.channelize_block`).
    Returns ``out[0][t]``: (n_local // k, K) complex64."""
    from quadrs_tpu_torch.ops.channelizer import channelize_block

    taps = np.asarray(taps, dtype=np.float32)
    size = len(taps)
    if mesh.shape["stream"] != 1:
        raise ValueError("channelize shards one capture over 'time'; use a Tx1 mesh")

    def step(blocks):
        _check_grid(blocks, mesh)
        outs = []
        for block in blocks[0]:
            n_loc = block.shape[-1] - size
            if n_loc % k:
                raise ValueError(f"per-shard slice of {n_loc} samples is not a whole number of {k}-sample output cells")
            if n_loc < size:
                raise ValueError(
                    f"per-shard slice of {n_loc} samples is shorter than the {size}-sample FIR halo; use larger chunks"
                )
            outs.append(channelize_block(_decoded(block, fmt)[None, :], taps, k, n_loc // k)[0])
        return [outs]

    return step


def to_device(planes: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host planes on ``device``: copied once into page-locked memory and
    from there with a non-blocking copy on a CUDA device (the caching host
    allocator keeps the page-locked block until the copy has left it)."""
    if device.type != "cuda":
        return torch.from_numpy(np.ascontiguousarray(planes))
    host = torch.empty(planes.shape, dtype=torch.from_numpy(planes[..., :0]).dtype, pin_memory=True)
    host.numpy()[...] = planes
    return host.to(device, non_blocking=True)


def shard_span(span: np.ndarray, mesh: Mesh, halo: int) -> list[list[torch.Tensor]]:
    """Place a host chunk and its continuation onto the mesh as the steps
    take it: ``span`` ((S, 2, n + halo) planes of a bank, or (2, n + halo)
    of one capture) holds the chunk's ``n`` samples and then the ``halo``
    that follow it; the chunk splits into ``shape['time']`` slices of
    ``n_local = n / T`` samples (and a bank's streams over
    ``shape['stream']`` rows), and each shard's block is its slice and the
    ``halo`` samples after it.  Returns ``blocks[s][t]`` on
    ``mesh.devices[s][t]``."""
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
        [to_device(row[..., t * n_local : t * n_local + n_local + halo], mesh.devices[s][t]) for t in range(n_time)]
        for s, row in enumerate(rows)
    ]


def join(outs, axis: int = 0):
    """Shard outputs (``out[s][t]``, each a tensor or a tuple of them)
    joined on the first shard's device in (stream, time) order: each mesh
    row's shards concatenated along ``axis``, the rows then along axis 0.
    An output on another device crosses to it first (after the work
    queued on its own device's stream); so one tensor (or tuple) comes
    back to the host, as from a single-device run."""
    first = outs[0][0]
    if isinstance(first, tuple):
        return tuple(join([[o[i] for o in row] for row in outs], axis) for i in range(len(first)))
    dev = first.device
    return torch.cat([torch.cat([o.to(dev, non_blocking=True) for o in row], dim=axis) for row in outs], dim=0)
