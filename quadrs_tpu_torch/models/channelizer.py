"""Channelizer model: split a capture into K channel streams at once.

The counterpart of ``quadrs_tpu.models.channelizer`` (no reference
counterpart: quadrs runs one ``shift`` -> ``lowpass`` chain a channel).
:class:`Channelize` plugs into the stream graph with the exact span and
valid arithmetic of :class:`~quadrs_tpu_torch.stream.LowPass` at
``decimate = K``; the device computes every channel in one program
(:func:`quadrs_tpu_torch.ops.channelizer.channelize_block`).

``read_batch`` returns ``(B, n, K)``: one trailing channel axis, so the
node is terminal; :func:`run_channelize` drives it through the
:class:`~quadrs_tpu_torch.runtime.Executor`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Iterator

import numpy as np
import torch

from quadrs_tpu_torch.ops.channelizer import channelize_block
from quadrs_tpu_torch.ops.fir import lowpass_taps
from quadrs_tpu_torch.runtime import Executor, root_step_of, window_batches
from quadrs_tpu_torch.stream import Plan, Stream


class Channelize(Stream):
    """K-channel polyphase filter bank over ``inner``.

    Channel ``ch`` equals ``Shift(inner, -ch*sr/K) -> LowPass(frequency,
    decimate=K, size)`` within f32 commutation (pinned by tests); the
    length and valid arithmetic is LowPass's with ``decimate = K``.
    ``frequency`` defaults to the alias-free cutoff ``sr/(2K)``; ``size``
    to the reference lowpass's default 40 taps.
    """

    def __init__(self, inner: Stream, channels: int, *, frequency: int | None = None, size: int = 40):
        if channels < 2:
            raise ValueError("channelize needs at least 2 channels")
        self.inner = inner
        self.channels = int(channels)
        self.frequency = int(frequency) if frequency is not None else inner.sample_rate // (2 * self.channels)
        if self.frequency <= 0:
            raise ValueError("channel cutoff must be positive")
        self.size = int(size)
        self.sample_rate = inner.sample_rate // self.channels
        if inner.length < self.size:
            raise ValueError("input shorter than the filter")
        self.length = 1 + (inner.length - self.size) // self.channels
        self.taps = lowpass_taps(self.frequency / inner.sample_rate, self.size)

    def span(self, off: int, n: int) -> tuple[int, int]:
        return self.inner.span(off * self.channels, n * self.channels + self.size)

    def plan(self, offs: np.ndarray, n: int, base: int) -> Plan:
        offs = np.asarray(offs, dtype=np.int64)
        inner = self.inner.plan(offs * self.channels, n * self.channels + self.size, base)
        valid_out = np.maximum(inner.valid - self.size, 0) // self.channels
        return Plan(prep={"inner": inner.prep, "valid_in": inner.valid}, valid=valid_out)

    def read_batch(self, ctx: dict, prep: Any, n: int) -> torch.Tensor:
        n_in = n * self.channels + self.size
        x = self.inner.read_batch(ctx, prep["inner"], n_in)
        # zero past each block's valid extent, in the decoded domain
        keep = torch.arange(n_in, device=x.device)[None, :] < prep["valid_in"][:, None]
        return channelize_block(torch.where(keep, x, 0), self.taps, self.channels, n)


@dataclass
class ChannelChunk:
    """One chunk of channelized output: ``data[ch, i]`` is output sample
    ``start + i`` of channel ``ch`` (complex64, valid samples only)."""

    start: int  # absolute output-sample offset (per channel)
    data: np.ndarray  # (K, n_valid) complex64


def channels_first(y: torch.Tensor) -> torch.Tensor:
    """The Executor's ``post``: each (n, K) block as (K, n) on the device,
    so that each channel comes back as one contiguous row."""
    return y.transpose(1, 2).contiguous()


def run_channelize(
    chan: Channelize,
    *,
    device: torch.device | str,
    chunk: int = 1 << 18,
    max_out: int | None = None,
    progress: Callable[[int], None] | None = None,
    mesh=None,
) -> Iterator[ChannelChunk]:
    """Stream the whole capture through the bank in executor chunks.

    Pull boundaries fall every ``chunk`` output samples, so edge truncation
    matches a reference chain pulled at the same size (only the capture
    tail differs from a single-shot run, as LowPass's per-read truncation
    does).  Each batch is computed while the one before it is consumed.

    ``mesh``: an optional Tx1 mesh
    (:func:`quadrs_tpu_torch.parallel.sharding.make_mesh`).  The capture's
    sample axis time-shards over it, each shard staged with its
    ``size``-sample FIR halo
    (:func:`~quadrs_tpu_torch.parallel.sharding.make_sharded_channelize_step`);
    the bank must sit directly on a raw capture, and the unaligned tail of
    the capture runs single-device on ``device``.  The per-shard slice is
    the "read" of the per-read truncation above, so when every shard pulls
    a full ``chunk`` the output is the single-device run's at the same
    ``chunk``; on a short capture the shard pull shrinks to fit."""
    total = chan.length if max_out is None else min(chan.length, max_out)
    if total <= 0:
        return
    done = 0
    lag0 = 0
    if mesh is not None:
        from quadrs_tpu_torch.parallel.sharding import join, make_sharded_channelize_step, shard_span

        src = chan.inner
        if src.root() is not src or not getattr(src, "has_staging", False):
            raise ValueError(
                "channelize -mesh shards a raw capture's sample axis; drop the intermediate stages or drop -mesh"
            )
        k, size = chan.channels, chan.size
        n_time = int(mesh.shape["time"])
        # per-shard outputs a dispatch: the executor chunk, cut so that a
        # short capture still runs on the mesh (a shard's slice must cover
        # the size-sample halo)
        avail = (src.length - size) // (n_time * k)
        per_shard = max(-(-size // k), min(chunk, avail))
        step_out = n_time * per_shard
        step = make_sharded_channelize_step(chan.taps, k, src.format, mesh)
        o = 0
        while o + step_out <= total and (o + step_out) * k + size <= src.length:
            outs = step(shard_span(src.stage(o * k, (o + step_out) * k + size), mesh, size))
            # each shard's (n, K) block channels-first on its device: the
            # channels come back as rows, joined shard after shard
            data = join([[channels_first(y[None])[0] for y in row] for row in outs], axis=1).cpu().numpy()
            yield ChannelChunk(start=o, data=data)
            done += step_out
            if progress is not None:
                progress(done)
            o += step_out
        lag0 = o
    if lag0 >= total:
        return
    offsets = np.arange(lag0, total, chunk, dtype=np.int64)
    batch, batches = window_batches(offsets, chunk, root_step=root_step_of(chan))
    ex = Executor(chan, chunk, device, batch=batch, post=channels_first)
    for offs, out, valid in ex.run_each(batches):  # out: (b, K, chunk)
        for row, off, v in zip(out, offs, valid):
            v = int(min(v, total - off))
            if v <= 0:
                continue
            yield ChannelChunk(start=int(off), data=np.ascontiguousarray(row[:, :v]))
            done += v
            if progress is not None:
                progress(done)
