"""Data parallelism over `torch.distributed`: ranks, their process group and
the reductions the global-batch step needs.

Counterpart of the JAX package's parallel/mesh.py. There, a jitted step over
a device mesh with replicated parameters and a batch sharded on its data axis
computes the global-batch function: XLA inserts every reduction (SPMD). Here
each rank is a process holding a replica and its shard of the batch, and the
reductions are made explicitly where that function has one:

* train-mode BN statistics: each rank's mean and biased variance, merged
  over ranks (`ops.conv.batch_moments`);
* the losses' counts and OHEM's thresholds, over the global batch
  (`train.loss`);
* gradients, sum-reduced in one flat bucket before the update
  (`train.loop.train_step`, `search.loop.SearchEngine`);
* evaluation counts (`eval.evaluator.Evaluator`).

A mesh on the spatial axis (`make_mesh(axis_names=(SPATIAL_AXIS,))`) is the
same group of ranks, used to split each image over H instead of sharding
the batch (`parallel/spatial.py`, `Evaluator(spatial=True)`).

Only `all_reduce`, `broadcast` and `barrier` are called, so the same code
runs under NCCL and under gloo on CUDA tensors (gloo has no CUDA
`all_gather`): a gather writes each rank's slice into a zeroed
(world, ...) buffer and sum-reduces it.

Every rank holds an equal shard of each global batch (`Mesh.shard` raises
otherwise), so a global element count is the local one times the world.
"""

from __future__ import annotations

import datetime
import os
import tempfile
from typing import Callable, List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

DATA_AXIS = "data"
SPATIAL_AXIS = "spatial"

# how long a collective (or joining the group) waits for the other ranks
TIMEOUT = datetime.timedelta(seconds=600)


class Mesh:
    """This process's place in a group of ranks: its rank, the world size,
    the backend and the device it computes on. `bytes_reduced` counts the
    bytes this rank has passed to `all_reduce`."""

    def __init__(self, rank: int, world: int, backend: str,
                 device: Union[str, torch.device]):
        self.rank, self.world, self.backend = rank, world, backend
        self.device = torch.device(device)
        self.bytes_reduced = 0

    def __repr__(self):
        return (f"Mesh(rank={self.rank}, world={self.world}, "
                f"backend={self.backend!r}, device={str(self.device)!r})")

    def __deepcopy__(self, memo):
        # a copied module (an optimizer's reference copy, a runner's) stays
        # in the same process group
        return self

    # ---- collectives ----

    def all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        """Sum `t` over ranks in place (no autograd) and return it."""
        self.bytes_reduced += t.numel() * t.element_size()
        dist.all_reduce(t)
        return t

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of `t` over ranks, differentiable: the gradient of the
        sum of every rank's loss flows back to each rank's `t` (the
        backward sum-reduces the incoming gradients)."""
        return _AllReduceSum.apply(t, self)

    def gather(self, t: torch.Tensor, differentiable: bool = False
               ) -> torch.Tensor:
        """(world, *t.shape): every rank's `t` in rank order, as a sum of
        zeroed buffers each rank has written its own row into. (Built
        without a host-to-device copy: a blocking one would stall the
        stream at every BN layer.)"""
        if differentiable:
            zeros = lambda n: t.new_zeros((n,) + tuple(t.shape))
            return self.sum(torch.cat([zeros(self.rank), t[None],
                                       zeros(self.world - self.rank - 1)]))
        buf = t.new_zeros((self.world,) + tuple(t.shape))
        buf[self.rank] = t
        return self.all_reduce_(buf)

    def reduce_grads_(self, grads: Sequence[torch.Tensor]) -> None:
        """Sum-reduce gradients over ranks in place, in one flat bucket a
        dtype."""
        by_dtype = {}
        for g in grads:
            by_dtype.setdefault(g.dtype, []).append(g)
        for group in by_dtype.values():
            flat = self.all_reduce_(torch.cat([g.reshape(-1)
                                               for g in group]))
            offset = 0
            for g in group:
                g.copy_(flat[offset:offset + g.numel()].view_as(g))
                offset += g.numel()

    def broadcast_(self, tensors: Sequence[torch.Tensor], src: int = 0
                   ) -> None:
        """Overwrite each tensor with rank `src`'s (no autograd)."""
        with torch.no_grad():
            for t in tensors:
                dist.broadcast(t, src)

    def barrier(self) -> None:
        if self.backend == "nccl":
            dist.barrier(device_ids=[self.device.index or 0])
        else:
            dist.barrier()

    # ---- the batch ----

    def shard(self, n: int) -> slice:
        """This rank's rows of a global batch of `n`."""
        if n % self.world:
            raise ValueError(f"global batch {n} must divide over "
                             f"{self.world} ranks")
        per = n // self.world
        return slice(self.rank * per, (self.rank + 1) * per)

    def close(self) -> None:
        """Leave the process group."""
        if dist.is_initialized():
            dist.destroy_process_group()


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh):
        ctx.mesh = mesh
        return mesh.all_reduce_(t.clone())

    @staticmethod
    def backward(ctx, grad):
        return ctx.mesh.all_reduce_(grad.clone()), None


def init_mesh(rank: int, world: int, backend: str,
              device: Union[str, torch.device], store_path: str) -> Mesh:
    """Join the process group of `world` ranks that meet in the file
    `store_path` (a `FileStore`: no TCP port), as `rank`, computing on
    `device`."""
    device = torch.device(device)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend, store=dist.FileStore(store_path, world), rank=rank,
        world_size=world, timeout=TIMEOUT)
    return Mesh(rank, world, backend, device)


def make_mesh(n_devices: Optional[int] = None,
              axis_names: Sequence[str] = (DATA_AXIS,),
              device: Optional[Union[str, torch.device]] = None) -> Mesh:
    """The mesh of this process in the process group it has joined (the
    JAX package's `make_mesh`, over ranks), on one axis: `DATA_AXIS` or
    `SPATIAL_AXIS` (the same ranks; `Evaluator(spatial=True)` splits images
    over them). `device` defaults to the current card under NCCL and to the
    CPU under gloo."""
    if tuple(axis_names) not in ((DATA_AXIS,), (SPATIAL_AXIS,)):
        raise ValueError(f"a mesh has one axis, {DATA_AXIS!r} or "
                         f"{SPATIAL_AXIS!r}, not {tuple(axis_names)}")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: start the "
                           "ranks with `launch` or join with `init_mesh`")
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"the process group has {world} ranks, not "
                         f"{n_devices}")
    backend = dist.get_backend()
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if backend == "nccl" else torch.device("cpu"))
    return Mesh(dist.get_rank(), world, backend, device)


def replicate(module: torch.nn.Module, mesh: Optional[Mesh]
              ) -> torch.nn.Module:
    """Every parameter and buffer of `module` set to rank 0's."""
    if mesh is not None:
        mesh.broadcast_(list(module.parameters()) + list(module.buffers()))
    return module


def shard_batch(tree, mesh: Optional[Mesh]):
    """This rank's rows of each tensor or array (nested in lists, tuples
    and dicts) of a global batch."""
    if mesh is None:
        return tree
    if isinstance(tree, dict):
        return {k: shard_batch(v, mesh) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(shard_batch(v, mesh) for v in tree)
    return tree[mesh.shard(len(tree))]


def sync_batchnorm_(module: torch.nn.Module, mesh: Optional[Mesh]
                    ) -> torch.nn.Module:
    """Every train-mode BN of `module` (`ops.conv.BatchNorm` and the slim
    BN rows) normalises with the statistics of the global batch over
    `mesh` (with None: of the local batch)."""
    from ..ops.conv import BatchNorm
    from ..ops.slimmable import SlimBatchNorm
    for m in module.modules():
        if isinstance(m, (BatchNorm, SlimBatchNorm)):
            m.mesh = mesh
    return module


def rank_devices(n: int, device: Union[str, torch.device]
                 ) -> Tuple[str, List[str]]:
    """(backend, one device a rank) for `n` ranks: with "cpu" gloo, every
    rank on the CPU; with "cuda" NCCL, rank r on cuda:r, and more ranks
    than cards raise. A named card raises: the ranks take a card each."""
    if n < 1:
        raise ValueError(f"--devices {n}: need at least one rank")
    device = torch.device(device)
    if device.type == "cpu":
        return "gloo", ["cpu"] * n
    if device.type != "cuda" or device.index is not None:
        raise ValueError(f"ranks run on device cpu or cuda (rank r on "
                         f"cuda:r), not {device}")
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "the ranks on the CPU")
    count = torch.cuda.device_count()
    if n > count:
        raise ValueError(f"{n} ranks need {n} cards, this host has {count}")
    return "nccl", [f"cuda:{r}" for r in range(n)]


def _rank_entry(rank: int, fn: Callable, world: int, backend: str,
                devices: Sequence[str], tmp: str, args: tuple) -> None:
    if torch.device(devices[rank]).type == "cpu":
        # the ranks share the host's cores (or the caller's thread limit)
        torch.set_num_threads(max(1, min(torch.get_num_threads(),
                                         (os.cpu_count() or 1) // world)))
    mesh = init_mesh(rank, world, backend, devices[rank],
                     os.path.join(tmp, "store"))
    try:
        result = fn(mesh, *args)
        torch.save(result, os.path.join(tmp, f"result{rank}.pt"))
    finally:
        mesh.close()


def launch(fn: Callable, n: int, backend: str, devices: Sequence[str],
           args: tuple = (), store_dir: Optional[str] = None) -> list:
    """Run `fn(mesh, *args)` in `n` spawned ranks (rank r on `devices[r]`)
    and return their results in rank order. The ranks meet in a
    `FileStore` in a new directory under `store_dir` (default: the
    temporary directory). `fn` and its results must pickle; a rank that
    raises ends the others and raises here."""
    if len(devices) != n:
        raise ValueError(f"{n} ranks but {len(devices)} devices")
    with tempfile.TemporaryDirectory(dir=store_dir) as tmp:
        torch.multiprocessing.spawn(
            _rank_entry, args=(fn, n, backend, tuple(devices), tmp, args),
            nprocs=n, join=True)
        return [torch.load(os.path.join(tmp, f"result{r}.pt"),
                           weights_only=False) for r in range(n)]
