"""Multi-device execution.

:mod:`quadrs_tpu_torch.parallel.sharding`: single-process meshes of torch
devices: time-sharded streaming with each shard's halo staged from the
host, stream banks, the sharded matched filter and channelizer.
"""

from quadrs_tpu_torch.parallel.sharding import (  # noqa: F401
    Mesh,
    halo_samples,
    join,
    make_mesh,
    make_sharded_stream_step,
    shard_bases,
    shard_span,
)
