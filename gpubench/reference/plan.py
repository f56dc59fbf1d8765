"""Channel geometry of a decoded FasterSeg network, from its genotypes.

A frozen copy of the published network's bookkeeping (FasterSeg
train/model_seg.py: `build_structure`, `get_branch_groups_cells`,
`build_arm_ffm_head`): branches that share an (op, next scale, width)
prefix run one cell, and the aggregation reads the skip features whose
channel counts are recorded here. The configuration file states the
genotypes (ops, path, downs, widths per output branch), so nothing here
decodes architecture logits.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np


def num_filters(scale: int, fch: int, width: float = 1.0) -> int:
    return int(np.round(scale * fch * width))


@dataclasses.dataclass(frozen=True)
class Cell:
    layer: int
    branch: int      # the group's leading branch
    op: int          # 0 skip, 1 conv, 2 conv_downup, 3 conv_2x, 4 conv_2x_downup
    c_in: int
    c_out: int
    down: bool
    scale: int       # input scale denominator: 8, 16 or 32


@dataclasses.dataclass(frozen=True)
class Plan:
    lasts: Tuple[int, ...]
    groups: Tuple[Tuple[Tuple[int, ...], ...], ...]   # per layer
    cells: Tuple[Cell, ...]
    fch: int
    num_classes: int
    stem_width: float
    head_width: float
    ch_16: int
    ch_8_2: int
    ch_8_1: int

    def nf(self, scale: int, width: float = 1.0) -> int:
        return num_filters(scale, self.fch, width)

    @property
    def ffm_channels(self) -> int:
        return self.nf(8, self.head_width) * len(self.lasts)

    def cell(self, layer: int, branch: int) -> Cell:
        for c in self.cells:
            if c.layer == layer and c.branch == branch:
                return c
        raise KeyError((layer, branch))


def build_plan(config: Dict) -> Plan:
    """The plan of a configuration file's network (`lasts`, `genotypes`
    keyed by str(last), `Fch`, `num_classes`, `stem_head_width`)."""
    fch = int(config["Fch"])
    sw, hw = (float(v) for v in config["stem_head_width"])
    lasts = tuple(int(v) for v in config["lasts"])
    genos = [config["genotypes"][str(last)] for last in lasts]
    ops = [list(g["ops"]) for g in genos]
    paths = [list(g["path"]) for g in genos]
    downs = [list(g["downs"]) for g in genos]
    widths = [list(g["widths"]) for g in genos]
    nb = len(lasts)
    nf = lambda s, w=1.0: num_filters(s, fch, w)

    ch_16 = ch_8_2 = ch_8_1 = 0
    cells: List[Cell] = []
    groups_all = []
    connected = np.ones((nb, nb))
    for l in range(max(len(p) for p in paths)):
        same = np.ones((nb, nb))
        for i in range(nb):
            for j in range(i + 1, nb):
                if (len(paths[i]) <= l + 1 or len(paths[j]) <= l + 1
                        or paths[i][l + 1] != paths[j][l + 1]
                        or ops[i][l] != ops[j][l]
                        or widths[i][l] != widths[j][l]):
                    same[i, j] = same[j, i] = 0
        connected *= same
        groups: List[List[int]] = []
        for b in range(nb):
            if len(paths[b]) < l + 1:
                continue
            for g in groups:
                if connected[g[0], b] == 1:
                    g.append(b)
                    break
            else:
                groups.append([b])
        for g in groups:
            b0 = g[0]
            scale = 2 ** (paths[b0][l] + 3)
            down = downs[b0][l]
            if l == 0:
                c_in, c_out = nf(scale, sw), nf(scale * (down + 1), widths[b0][l])
            elif l == len(paths[b0]) - 1:
                c_in, c_out = nf(scale, widths[b0][l - 1]), nf(scale, hw)
            else:
                c_in = nf(scale, widths[b0][l - 1])
                c_out = nf(scale * (down + 1), widths[b0][l])
            if 2 in lasts and lasts.index(2) in g and down:
                if scale == 16:
                    ch_16 = c_in
                elif scale == 8:
                    ch_8_2 = c_in
            if 1 in lasts and lasts.index(1) in g and down and scale == 8:
                ch_8_1 = c_in
            cells.append(Cell(l, b0, ops[b0][l], c_in, c_out, bool(down),
                              scale))
        groups_all.append(tuple(tuple(g) for g in groups))
    return Plan(lasts, tuple(groups_all), tuple(cells), fch,
                int(config["num_classes"]), sw, hw, ch_16, ch_8_2, ch_8_1)


def stem_channels(plan: Plan) -> Sequence[int]:
    """Output channels of the stem's three stages."""
    nf = lambda s: num_filters(s, plan.fch, plan.stem_width)
    return nf(2) * 2, nf(4) * 2, nf(8)
