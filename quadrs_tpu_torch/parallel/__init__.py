"""Multi-device and multi-process execution.

:mod:`quadrs_tpu_torch.parallel.sharding`: meshes of torch devices:
time-sharded streaming with each shard's halo staged from the host, stream
banks, the sharded matched filter, channelizer and receivers' front end.
:mod:`quadrs_tpu_torch.parallel.distributed`: a mesh over several
processes on ``torch.distributed``, each process staging and computing its
own shards.
"""

from quadrs_tpu_torch.parallel import distributed  # noqa: F401
from quadrs_tpu_torch.parallel.sharding import (  # noqa: F401
    Mesh,
    halo_samples,
    join,
    make_mesh,
    make_sharded_stream_step,
    shard_bases,
    shard_span,
)
