"""Multi-resolution searchable supernet.

Counterpart of the JAX package's models/supernet.py (the reference's
`Network_Multi_Path`, search/model_search.py:131-548): an L-layer grid over
the scales 1/8, 1/16 and 1/32 in which every cell mixes the five slimmable
primitives (alpha-weighted), every inter-scale edge is beta-weighted, and
channel widths are Gumbel-sampled (the ratio parameters).

* The architecture parameters live outside the module (`ArchParamSet`, owned
  by the search engine) and are passed to `forward`; the module owns only
  weights and BN statistics.
* Widths arrive as (index, score) samples (search/gumbel.py), so every
  width mode runs the same graph, and no index is read to the host.
* The grid is unrolled. Both incoming edges of a two-input cell are always
  evaluated (softmax betas are strictly positive, so the reference's
  `if beta > 0` guards always fire too, model_search.py:326-329).
* The stem's output is zero-padded to the grid's maximum width; the refines
  and heads take static slices at the arch's head width. Both equal the
  reference's sliced layout.
* With `remat`, each cell call is checkpointed (`torch.utils.checkpoint`)
  and recomputed in the backward pass under
  `ops.slimmable.frozen_running_statistics`, so the recompute does not move
  the BN running statistics a second time (the JAX package's `nn.remat`
  does not either).

Module names: `cells["{i}_{j}"]` (layer i, scale j) hold `op` (the keep
mixed op) and `down`; each mixed op's `ops[k]` is primitive k.
`stems[a]`, `refines[a][name]` and `heads[a][name]` belong to arch a.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..core.plan import num_filters
from ..latency.estimator import cell_ratio_wiring
from ..ops.conv import ConvNorm
from ..ops.resize import scale_by
from ..ops.seg_heads import Head
from ..ops.slimmable import (SLIM_OP_CLASSES, frozen_running_statistics,
                             width_index)
from ..utils.weights import init_training_
from .derived import Stem

RatioSample = Tuple[torch.Tensor, torch.Tensor]

HEAD_NAMES = ("head0", "head1", "head2", "head02", "head12")


def beta_mix(a: torch.Tensor, b: torch.Tensor, w: torch.Tensor
             ) -> torch.Tensor:
    """a * w[0] + b * w[1]: a two-input cell's beta mix, the fp32 beta row
    rounded to the activations' dtype first, as the JAX package does
    (supernet.py:297-301)."""
    w = w.to(a.dtype)
    return a * w[0] + b * w[1]


class SlimMixedOp(nn.Module):
    """Alpha-weighted sum of the five slimmable primitives
    (model_search.py:46-78). Every primitive runs; each output is scaled by
    alpha_k * score_in * score_out."""

    def __init__(self, c_in: int, c_out: int, stride: int,
                 width_mult_list: Tuple[float, ...]):
        super().__init__()
        self.ops = nn.ModuleList(
            cls(c_in, c_out, stride, width_mult_list)
            for cls in SLIM_OP_CLASSES)

    def forward(self, x, alpha, r_in: RatioSample, r_out: RatioSample):
        in_idx, in_score = r_in
        out_idx, out_score = r_out
        gate = in_score * out_score
        acc = None
        for k, op in enumerate(self.ops):
            y = op(x, in_idx, out_idx)
            # the fp32 mixing weight rounded to the activations' dtype before
            # the product, as the JAX package does (supernet.py:69)
            y = y * (alpha[k] * gate).to(y.dtype)
            acc = y if acc is None else acc + y
        return acc


class SlimCell(nn.Module):
    """The keep mixed op and, except on the last layer and the 1/32 scale,
    the stride-2 down mixed op (model_search.py:102-128)."""

    def __init__(self, c_in: int, down: bool,
                 width_mult_list: Tuple[float, ...]):
        super().__init__()
        self.op = SlimMixedOp(c_in, c_in, 1, width_mult_list)
        self.down = (SlimMixedOp(c_in, c_in * 2, 2, width_mult_list)
                     if down else None)

    def forward(self, x, alpha, r_in, r_out, r_down=None):
        out = self.op(x, alpha, r_in, r_out)
        down = None if self.down is None else self.down(x, alpha, r_in,
                                                        r_down)
        return out, down


@dataclasses.dataclass
class ArchParamSet:
    """The continuous architecture parameters of one arch
    (model_search.py:507-531), the counterpart of the JAX package's
    `ArchParamsPytree`: alphas [(L,5), (L-1,5), (L-2,5)], betas
    [None, (L-2,2), (L-3,2)], ratios [(L-1,nw), (L-1,nw), (L-2,nw)]."""

    alphas: List[torch.Tensor]
    betas: List[Optional[torch.Tensor]]
    ratios: List[torch.Tensor]

    @staticmethod
    def create(layers: int, num_ops: int = 5, num_widths: int = 5,
               init: float = 1e-3, device="cpu") -> "ArchParamSet":
        full = lambda *s: torch.full(s, init, device=device,
                                     requires_grad=True)
        return ArchParamSet(
            alphas=[full(layers, num_ops), full(layers - 1, num_ops),
                    full(layers - 2, num_ops)],
            betas=[None, full(layers - 2, 2), full(layers - 3, 2)],
            ratios=[full(layers - 1, num_widths), full(layers - 1, num_widths),
                    full(layers - 2, num_widths)])

    def tensors(self) -> List[torch.Tensor]:
        """alpha0..2, beta1..2, ratio0..2, in that order."""
        return [*self.alphas, *self.betas[1:], *self.ratios]

    def detached(self) -> "ArchParamSet":
        d = lambda t: None if t is None else t.detach()
        return ArchParamSet([d(a) for a in self.alphas],
                            [d(b) for b in self.betas],
                            [d(r) for r in self.ratios])


class Supernet(nn.Module):
    """The searchable grid and, for each arch, its stem, refines and five
    heads. NHWC input (N, H, W, 3); train mode returns the five heads'
    1/8 logits, eval mode upsamples them x8 to the input's size.

    `dtype` is the compute dtype (the JAX package's `Supernet(dtype=)`;
    None computes in the input's, float64 for a reference): the input is
    cast to it at entry, each conv casts its fp32 weights to it,
    BN takes its statistics in fp32 and returns it, and the alpha, gate and
    beta mixing weights are rounded to it before their products. Parameters,
    BN statistics and the arch parameters stay fp32; so do the logits'
    losses (train/loss.py upcasts)."""

    def __init__(self, layers: int = 16, num_classes: int = 19, Fch: int = 12,
                 width_mult_list: Tuple[float, ...] = (1.0,),
                 stem_head_width: Tuple[Tuple[float, float], ...] = (
                     (1.0, 1.0),),
                 remat: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.layers, self.num_classes, self.Fch = layers, num_classes, Fch
        self.dtype = dtype
        self.wml = tuple(width_mult_list)
        self.stem_head_width = tuple(tuple(s) for s in stem_head_width)
        self.remat = remat
        nf = self.nf
        self.cells = nn.ModuleDict()
        for i in range(layers):
            for j in range(min(i + 1, 3)):
                self.cells[f"{i}_{j}"] = SlimCell(
                    nf(8 * 2 ** j), down=(j < 2 and i < layers - 1),
                    width_mult_list=self.wml)
        self.stems = nn.ModuleList()
        self.refines = nn.ModuleList()
        self.heads = nn.ModuleList()
        for stem_w, hw in self.stem_head_width:
            self.stems.append(Stem(Fch, stem_w))
            c8, c16, c32 = nf(8, hw), nf(16, hw), nf(32, hw)
            self.refines.append(nn.ModuleDict({
                "refine16_0": ConvNorm(c16, c8, 1, padding=0),
                "refine16_1": ConvNorm(2 * c8, c8, 3, padding=1),
                "refine32_0": ConvNorm(c32, c16, 1, padding=0),
                "refine32_1": ConvNorm(2 * c16, c16, 3, padding=1),
                "refine32_2": ConvNorm(c16, c8, 1, padding=0),
                "refine32_3": ConvNorm(2 * c8, c8, 3, padding=1)}))
            self.heads.append(nn.ModuleDict({
                name: Head(c_in, num_classes) for name, c_in in zip(
                    HEAD_NAMES, (c8, c8, c8, 2 * c8, 2 * c8))}))
        # (stem, head) width indices of each arch: pins with score 1
        self.register_buffer("pins", torch.tensor(
            [[width_index(s, self.wml), width_index(h, self.wml)]
             for s, h in self.stem_head_width]), persistent=False)

    def nf(self, scale: int, width: float = 1.0) -> int:
        return num_filters(scale, self.Fch, width)

    def width_pins(self, arch_idx: int) -> Tuple[RatioSample, RatioSample]:
        """The arch's stem and head widths as (index, score 1) samples."""
        one = torch.ones((), device=self.pins.device)
        return ((self.pins[arch_idx, 0], one), (self.pins[arch_idx, 1], one))

    def _cell(self, i: int, j: int, x, alpha, ratio):
        cell = self.cells[f"{i}_{j}"]
        if not (self.remat and self.training and torch.is_grad_enabled()):
            return cell(x, alpha, *ratio)
        return checkpoint(
            cell, x, alpha, *ratio, use_reentrant=False,
            preserve_rng_state=False,
            context_fn=lambda: (contextlib.nullcontext(),
                                frozen_running_statistics()))

    def forward(self, x: torch.Tensor, arch_idx: int, alphas, betas,
                ratios: Sequence[Tuple[torch.Tensor, torch.Tensor]]):
        """alphas / betas: raw logits (softmaxed here, model_search.py:
        275-281); ratios: the three scales' (idx, score) samples from
        `search.gumbel.sample_ratios`."""
        L = self.layers
        _, head_w = self.stem_head_width[arch_idx]
        stem_pin, head_pin = self.width_pins(arch_idx)
        al = [torch.softmax(a, -1) for a in alphas]
        be = [None, torch.softmax(betas[1], -1), torch.softmax(betas[2], -1)]

        if self.dtype is not None:
            x = x.to(self.dtype)
        stem_out = self.stems[arch_idx](x)
        pad_c = self.nf(8) - stem_out.shape[-1]
        if pad_c:
            stem_out = F.pad(stem_out, (0, pad_c))

        out_prev = [(stem_out, None)]
        for i in range(L):
            out = []
            for j in range(min(i + 1, 3)):
                alpha = al[j][i - j]
                ratio = cell_ratio_wiring(ratios, i, j, L, stem_pin, head_pin)
                if j == 0:
                    out.append(self._cell(i, j, out_prev[0][0], alpha, ratio))
                elif i == j:
                    out.append(self._cell(i, j, out_prev[j - 1][1], alpha,
                                          ratio))
                else:
                    o0, d0 = self._cell(i, j, out_prev[j - 1][1], alpha, ratio)
                    o1, d1 = self._cell(i, j, out_prev[j][0], alpha, ratio)
                    w = be[j][i - j - 1]
                    d = None if d0 is None else beta_mix(d0, d1, w)
                    out.append((beta_mix(o0, o1, w), d))
            out_prev = out

        # head-width static slices (grid -> fixed-width refines and heads)
        s8 = out_prev[0][0][..., :self.nf(8, head_w)]
        s16 = out_prev[1][0][..., :self.nf(16, head_w)]
        s32 = out_prev[2][0][..., :self.nf(32, head_w)]

        # refines (model_search.py:172-181, forward :338-344)
        r = self.refines[arch_idx]
        out0 = s8
        out1 = scale_by(r["refine16_0"](s16), 2)
        out1 = r["refine16_1"](torch.cat([out1, s8], -1))
        out2 = scale_by(r["refine32_0"](s32), 2)
        out2 = r["refine32_1"](torch.cat([out2, s16], -1))
        out2 = scale_by(r["refine32_2"](out2), 2)
        out2 = r["refine32_3"](torch.cat([out2, s8], -1))

        h = self.heads[arch_idx]
        preds = [h["head0"](out0), h["head1"](out1), h["head2"](out2),
                 h["head02"](torch.cat([out0, out2], -1)),
                 h["head12"](torch.cat([out1, out2], -1))]
        if not self.training:
            preds = [scale_by(p, 8) for p in preds]
        return tuple(preds)


def init_supernet(model: Supernet, seed: int) -> Supernet:
    """The JAX package's `init_supernet` for every arch at once, drawn from
    a torch.Generator seeded by `seed`: Kaiming-normal convs, zero conv
    biases; the BN rows (slim ones too) keep their construction values,
    scale 1, bias 0, running mean 0 and variance 1."""
    return init_training_(model, seed)
