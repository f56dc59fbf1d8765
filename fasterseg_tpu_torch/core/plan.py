"""Network plan: decoded genotypes -> a static execution plan.

Pure-python port of the reference's branch merging and channel bookkeeping
(`train/model_seg.py:205-296` — `build_structure`,
`get_branch_groups_cells`, `build_arm_ffm_head`). The plan is a frozen,
hashable description consumed by `models/derived.py` to build the actual
network; keeping it pure data makes it property-testable and lets the
golden tests pin it against the reference's torch module shapes.

Branch merging: while two output branches share the same (op, next-scale,
width) prefix they execute one shared cell (reference model_seg.py:241-296).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np

from .genotype import Genotype


def num_filters(scale: int, Fch: int, width: float = 1.0) -> int:
    """Channel count at a given scale (reference model_seg.py:202-203)."""
    return int(np.round(scale * Fch * width))


@dataclasses.dataclass(frozen=True)
class CellSpec:
    """One physical cell: op + channel geometry."""

    layer: int
    branch: int          # owning branch (group leader)
    op: int              # PRIMITIVES index
    c_in: int
    c_out: int
    down: bool           # stride-2 cell
    scale: int           # input scale denominator (8/16/32)


@dataclasses.dataclass(frozen=True)
class NetworkPlan:
    """Static plan for a derived (inference) network."""

    lasts: Tuple[int, ...]                   # output scale per branch
    genotypes: Tuple[Genotype, ...]          # per branch, ordered as lasts
    # branch_groups[layer] = groups of branches sharing one cell that layer
    branch_groups: Tuple[Tuple[Tuple[int, ...], ...], ...]
    # cells keyed "(layer, leader_branch)" in declaration order
    cells: Tuple[CellSpec, ...]
    Fch: int
    num_classes: int
    stem_head_width: Tuple[float, float]
    ch_16: int
    ch_8_2: int
    ch_8_1: int

    @property
    def num_branch(self) -> int:
        return len(self.lasts)

    def head_width(self) -> float:
        return self.stem_head_width[1]

    def nf(self, scale: int, width: float = 1.0) -> int:
        return num_filters(scale, self.Fch, width)

    # Fusion/head channel geometry (reference model_seg.py:215-239)
    @property
    def ffm_channels(self) -> int:
        return self.nf(8, self.head_width()) * self.num_branch

    @property
    def heads32_in(self) -> int:
        return self.nf(32, self.head_width())

    @property
    def heads16_in(self) -> int:
        if 1 in self.lasts:
            return self.nf(16, self.head_width()) + self.ch_16
        return self.ch_16

    @property
    def heads8_in(self) -> int:
        return self.ffm_channels

    def cell_map(self) -> Dict[Tuple[int, int], CellSpec]:
        """(layer, branch) -> cell spec, including merged aliases."""
        by_leader = {(c.layer, c.branch): c for c in self.cells}
        out = {}
        for layer, groups in enumerate(self.branch_groups):
            for group in groups:
                spec = by_leader[(layer, group[0])]
                for b in group:
                    out[(layer, b)] = spec
        return out


def build_plan(genotypes: Dict[int, Genotype], lasts: Sequence[int],
               Fch: int = 12, num_classes: int = 19,
               stem_head_width: Tuple[float, float] = (1.0, 1.0)
               ) -> NetworkPlan:
    """Merge branches into shared cells and compute channel geometry.

    Port of reference get_branch_groups_cells (model_seg.py:241-296):
    branches i, j share a cell at layer l iff every earlier layer also
    matched and (next-scale, op, width) agree at l; the running AND is
    `branch_connections`. ch_16 / ch_8_2 / ch_8_1 record the skip-feature
    channel counts consumed by the BiSeNet-style aggregation
    (model_seg.py:289-292).
    """
    lasts = tuple(int(x) for x in lasts)
    genos = tuple(genotypes[l] for l in lasts)
    ops = [list(g.ops) for g in genos]
    paths = [list(g.path) for g in genos]
    downs = [list(g.downs) for g in genos]
    widths = [list(g.widths) for g in genos]

    num_branch = len(lasts)
    layers = max(len(p) for p in paths)
    nf = lambda scale, width=1.0: num_filters(scale, Fch, width)

    ch_16 = ch_8_2 = ch_8_1 = 0
    cells: List[CellSpec] = []
    seen = set()
    groups_all: List[Tuple[Tuple[int, ...], ...]] = []
    branch_connections = np.ones((num_branch, num_branch))

    for l in range(layers):
        connections = np.ones((num_branch, num_branch))
        for i in range(num_branch):
            for j in range(i + 1, num_branch):
                if (len(paths[i]) <= l + 1 or len(paths[j]) <= l + 1
                        or paths[i][l + 1] != paths[j][l + 1]
                        or ops[i][l] != ops[j][l]
                        or widths[i][l] != widths[j][l]):
                    connections[i, j] = connections[j, i] = 0
        branch_connections *= connections

        branch_groups: List[List[int]] = []
        for branch in range(num_branch):
            if len(paths[branch]) < l + 1:
                continue
            inserted = False
            for group in branch_groups:
                if branch_connections[group[0], branch] == 1:
                    group.append(branch)
                    inserted = True
                    continue
            if not inserted:
                branch_groups.append([branch])

        for group in branch_groups:
            g0 = group[0]
            for b in group[1:]:
                assert (ops[g0][l] == ops[b][l]
                        and paths[g0][l + 1] == paths[b][l + 1]
                        and downs[g0][l] == downs[b][l]
                        and widths[g0][l] == widths[b][l])
            op = ops[g0][l]
            scale = 2 ** (paths[g0][l] + 3)
            down = downs[g0][l]
            if l < len(paths[g0]) - 1:
                assert down == paths[g0][l + 1] - paths[g0][l]
            if l == 0:
                c_in = nf(scale, stem_head_width[0])
                c_out = nf(scale * (down + 1), widths[g0][l])
            elif l == len(paths[g0]) - 1:
                assert down == 0
                c_in = nf(scale, widths[g0][l - 1])
                c_out = nf(scale, stem_head_width[1])
            else:
                c_in = nf(scale, widths[g0][l - 1])
                c_out = nf(scale * (down + 1), widths[g0][l])

            if 2 in lasts and lasts.index(2) in group and down:
                if scale == 16:
                    ch_16 = c_in
                elif scale == 8:
                    ch_8_2 = c_in
            if 1 in lasts and lasts.index(1) in group and down and scale == 8:
                ch_8_1 = c_in

            key = (l, g0)
            if key not in seen:
                seen.add(key)
                cells.append(CellSpec(layer=l, branch=g0, op=op, c_in=c_in,
                                      c_out=c_out, down=bool(down),
                                      scale=scale))
        groups_all.append(tuple(tuple(g) for g in branch_groups))

    return NetworkPlan(
        lasts=lasts,
        genotypes=genos,
        branch_groups=tuple(groups_all),
        cells=tuple(cells),
        Fch=Fch,
        num_classes=num_classes,
        stem_head_width=(float(stem_head_width[0]),
                         float(stem_head_width[1])),
        ch_16=ch_16,
        ch_8_2=ch_8_2,
        ch_8_1=ch_8_1,
    )


def objective_acc_lat(acc: float, lat_ms: float,
                      target_ms: float = 8.3) -> float:
    """Accuracy-latency scalarization used for branch selection
    (reference tools/utils/darts_utils.py:343-348)."""
    return acc * (lat_ms / target_ms) ** -0.07


def select_lasts(mIoU02: float, latency02: float, mIoU12: float,
                 latency12: float) -> List[int]:
    """Pick output branch pair [2,0] vs [2,1] (reference train/train.py:102-105)."""
    if objective_acc_lat(mIoU02, latency02) > objective_acc_lat(mIoU12, latency12):
        return [2, 0]
    return [2, 1]
