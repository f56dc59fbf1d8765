"""Spatial partitioning: each image split over H across ranks, the halo and
row-window exchanges of a forward on its blocks.

Counterpart of the JAX package's spatial mesh axis (parallel/mesh.py
`spatial_sharding`, eval/evaluator.py `spatial=True`), the CNN analogue of
context parallelism for batch-1 full-resolution evaluation. There, XLA
shards NHWC height over the axis and inserts the exchanges. Here each rank
holds one contiguous block of rows of every map (a `Block`: its rows, the
`Partition` of the map's rows over the ranks, and the `Exchange`), and the
exchanges are explicit:

* a 3x3 conv takes its neighbours' edge rows (`Block.halo`): the conv
  kernel reads them where it would zero-pad (kernels/conv.py, halo mode),
  and zero-pads only at the image's top and bottom;
* a bilinear resize takes the window of input rows that the rows of the
  global interpolation matrix for its block touch (`Block.rows`,
  ops/resize.py's row-window forms), which may reach past one row and into
  any rank's block;
* everything else (1x1 convs, BN, ReLU, the flip along W, argmax) is local.

Blocks start at multiples of the forward's `row_multiple`, so that a
stride-2 op (a conv, FactorizedReduce's offset slices) always meets an even
block start and samples the global grid.

Every exchange is one `Mesh.all_reduce_` of a zeroed buffer into which each
rank writes the rows it holds of every other rank's request: each row is
written by one rank, so the sum is exact, and the same code runs under
NCCL and under gloo on CUDA tensors (which offers no send/recv). Every rank
computes every rank's requests from the partitions, so no request is sent.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

import torch

from ..kernels.conv import conv3x3_bn_relu as _conv3x3_bn_relu

Window = Tuple[int, int]


@dataclasses.dataclass(frozen=True)
class Partition:
    """The rows [0, height) of a map split over ranks: rank r holds rows
    [bounds[r], bounds[r + 1])."""
    bounds: Tuple[int, ...]

    @property
    def world(self) -> int:
        return len(self.bounds) - 1

    @property
    def height(self) -> int:
        return self.bounds[-1]

    def block(self, rank: int) -> Window:
        return self.bounds[rank], self.bounds[rank + 1]

    def map(self, f: Callable[[int], int], height: int) -> "Partition":
        """The partition of a map of `height` rows derived from this one:
        each boundary between blocks b goes to f(b)."""
        inner = tuple(f(b) for b in self.bounds[1:-1])
        return Partition((0,) + inner + (height,))


def partition(height: int, world: int, multiple: int = 1) -> Partition:
    """Contiguous blocks of `height` rows over `world` ranks whose
    boundaries are multiples of `multiple`, as even as possible: the
    height // multiple units go out one more to the first ranks, and the
    last block also takes the height % multiple rows left over."""
    units = height // multiple
    if units < world:
        raise ValueError(
            f"an image of {height} rows holds {units} blocks of {multiple} "
            f"rows (the forward's row multiple), fewer than the {world} ranks")
    base, extra = divmod(units, world)
    bounds = [0]
    for r in range(world):
        bounds.append(bounds[-1] + (base + (r < extra)) * multiple)
    bounds[-1] = height
    return Partition(tuple(bounds))


class Exchange:
    """Row exchanges between the ranks of `mesh` (a `parallel.Mesh`).
    `exchanges` and `bytes` count the collectives this rank has made and
    the bytes it has passed to them."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.rank = mesh.rank
        self.exchanges = 0
        self.bytes = 0

    def fetch(self, t: torch.Tensor, part: Partition,
              requests: Sequence[Sequence[Window]]) -> List[torch.Tensor]:
        """Rows of the map whose block `t` (N, h, ...) this rank holds.
        requests[r]: the global row windows rank r asks for, the same list
        on every rank; returns this rank's, in order. Rows a rank holds
        itself are sliced locally; the others travel in one collective."""
        me_lo, me_hi = part.block(self.rank)
        if t.shape[1] != me_hi - me_lo:
            raise ValueError(f"block of {t.shape[1]} rows, the partition "
                             f"gives rank {self.rank} {me_hi - me_lo}")
        # the rows each request needs from other ranks, in buffer order
        segments, offset = [], 0
        for r, windows in enumerate(requests):
            lo_r, hi_r = part.block(r)
            for lo, hi in windows:
                if not 0 <= lo <= hi <= part.height:
                    raise ValueError(f"window [{lo}, {hi}) outside the "
                                     f"{part.height} rows")
                for a, b in ((lo, min(hi, lo_r)), (max(lo, hi_r), hi)):
                    if a < b:
                        segments.append((r, a, b, offset))
                        offset += b - a
        buf = None
        if offset:
            # gloo reduces no bfloat16: such rows travel as fp32 (exact)
            dtype = (torch.float32 if t.dtype == torch.bfloat16
                     and self.mesh.backend == "gloo" else t.dtype)
            buf = t.new_zeros((t.shape[0], offset) + tuple(t.shape[2:]),
                              dtype=dtype)
            for _, a, b, off in segments:
                a2, b2 = max(a, me_lo), min(b, me_hi)
                if a2 < b2:
                    buf[:, off + a2 - a:off + b2 - a] = t[:, a2 - me_lo:
                                                          b2 - me_lo]
            self.exchanges += 1
            self.bytes += buf.numel() * buf.element_size()
            self.mesh.all_reduce_(buf)
            buf = buf.to(t.dtype)
        mine = {(a, b): off for r, a, b, off in segments if r == self.rank}
        out = []
        for lo, hi in requests[self.rank]:
            parts = []
            for a, b in ((lo, min(hi, me_lo)), (max(lo, me_lo),
                                                min(hi, me_hi)),
                         (max(lo, me_hi), hi)):
                if a >= b:
                    continue
                if me_lo <= a and b <= me_hi:
                    parts.append(t[:, a - me_lo:b - me_lo])
                else:
                    off = mine[(a, b)]
                    parts.append(buf[:, off:off + b - a])
            out.append(torch.cat(parts, dim=1))
        return out


@dataclasses.dataclass(frozen=True)
class Block:
    """This rank's rows of an (N, H, W, C) map split over H: `t` holds
    global rows part.block(rank) of `part.height`."""
    t: torch.Tensor
    part: Partition
    ex: Exchange

    @property
    def lo(self) -> int:
        return self.part.block(self.ex.rank)[0]

    @property
    def hi(self) -> int:
        return self.part.block(self.ex.rank)[1]

    @property
    def height(self) -> int:
        return self.part.height

    def like(self, t: torch.Tensor, part: Optional[Partition] = None
             ) -> "Block":
        """Another map of this rank, on `part` (default: this one's)."""
        return Block(t, self.part if part is None else part, self.ex)

    def rows(self, windows: Sequence[Window]) -> torch.Tensor:
        """The global rows windows[rank] of this map for this rank; every
        rank passes every rank's window (a collective)."""
        return self.ex.fetch(self.t, self.part, [[w] for w in windows])[0]

    def halo(self, stride: int = 1
             ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
        """(the row above this block, the row below it) that a 3x3 pad-1
        conv of `stride` reads; None where it reads none or the row lies
        outside the image (the conv zero-pads there). At stride 2 a block
        must start at an even row (the conv samples the global grid), and
        only a block of odd height reads the row below. A collective."""
        requests = []
        for r in range(self.part.world):
            lo, hi = self.part.block(r)
            if stride == 2 and lo % 2:
                raise ValueError(
                    f"a stride-2 conv over a block starting at odd row {lo} "
                    f"would shift the sampling grid: blocks must start at "
                    f"multiples of the forward's row multiple")
            below = (hi - lo - 1) // stride * stride + 1 >= hi - lo
            requests.append(
                ([(lo - 1, lo)] if lo > 0 else [])
                + ([(hi, hi + 1)] if below and hi < self.height else []))
        got = self.ex.fetch(self.t, self.part, requests)
        mine = requests[self.ex.rank]
        above = got.pop(0) if mine and mine[0][1] == self.lo else None
        return above, (got.pop(0) if got else None)


def conv_partition(part: Partition, stride: int) -> Partition:
    """The rows of a pad-1 conv's output at `stride` over the ranks."""
    return part.map(lambda b: (b - 1) // stride + 1,
                    (part.height - 1) // stride + 1)


def conv3x3_bn_relu(x: Block, w, scale, bias, stride: int = 1,
                    relu: bool = True, x2: Optional[Block] = None) -> Block:
    """`kernels.conv3x3_bn_relu` of an image split over H, on this rank's
    block (and x2's, the second input of a concat, whose halo rows travel
    in the same exchange): the halo rows come from the neighbours
    (`Block.halo`) and the kernel runs in halo mode; returns the block of
    the output's rows."""
    ts = [x.t] if x2 is None else [x.t, x2.t]
    joined = x.like(ts[0] if x2 is None else torch.cat(ts, dim=-1))
    above, below = joined.halo(stride)
    if above is not None or below is not None:
        full = torch.cat([r for r in (above, joined.t, below)
                          if r is not None], dim=1)
        ts = ([full] if x2 is None else
              [t.contiguous() for t in torch.split(
                  full, [t.shape[-1] for t in ts], dim=-1)])
    y = _conv3x3_bn_relu(ts[0], w, scale, bias, stride=stride, relu=relu,
                         x2=None if x2 is None else ts[1],
                         halo=(int(above is not None), int(below is not None)))
    return x.like(y, conv_partition(x.part, stride))
