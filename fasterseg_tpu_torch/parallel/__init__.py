"""Data parallelism: ranks over `torch.distributed`, replicated weights, a
sharded batch and the global-batch reductions (`mesh.py`), and a dry run of
the distill and search steps on N ranks (`dryrun.py`); spatial
partitioning, each image split over H with its halo and row-window
exchanges (`spatial.py`)."""

from .mesh import (
    DATA_AXIS,
    SPATIAL_AXIS,
    Mesh,
    init_mesh,
    launch,
    make_mesh,
    rank_devices,
    replicate,
    shard_batch,
    sync_batchnorm_,
)
