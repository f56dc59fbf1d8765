"""Data parallelism: ranks over `torch.distributed`, replicated weights, a
sharded batch and the global-batch reductions (`mesh.py`), and a dry run of
the distill and search steps on N ranks (`dryrun.py`)."""

from .mesh import (
    DATA_AXIS,
    SPATIAL_AXIS,
    SPATIAL_NOT_PORTED,
    Mesh,
    init_mesh,
    launch,
    make_mesh,
    rank_devices,
    replicate,
    shard_batch,
    sync_batchnorm_,
)
