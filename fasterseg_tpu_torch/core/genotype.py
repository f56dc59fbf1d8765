"""Genotype decoding: architecture parameters -> discrete network description.

Pure-numpy reimplementation of the reference decode pipeline
(`train/model_seg.py:15-135`). The decode turns continuous
architecture parameters (alpha = op logits, beta = downsample-position
logits, ratio = width logits) into, per output scale ("last" in {0,1,2},
meaning 1/8, 1/16, 1/32), a compact branch description:

  ops    — op index per kept cell (PRIMITIVES indexing)
  path   — scale index (0/1/2) per kept cell
  downs  — 1 where the cell downsamples (stride 2), matching path
  widths — width multiplier per cell transition (len(path) - 1 entries)

Behavioral notes replicated deliberately (validated by golden tests against
the shipped `arch_{0,1}.pt` artifacts decoded with the reference code):

* The reference decodes last=0, then 1, then 2 **with shared mutable
  state**: `alphas2ops_path_width` writes -inf into alpha rows in place and
  `network_metas` re-softmaxes the beta list on every call
  (`model_seg.py:127-135`, called thrice from `model_seg.py:198-200`).
  `decode_network` reproduces that sequencing exactly.
* Skip ("FactorizedReduce") cells at constant scale are pruned subject to a
  minimum branch length `min_len = round(L/3) + 2*last_scale`, and a span
  between two consecutive downsamples may not consist entirely of skips
  (`model_seg.py:40-96`).
* `ignore_skip=True` (teacher) disables the skip op entirely by writing
  -inf before each argmax (`model_seg.py:52-54`).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

# Search space: the five primitive op names, index-aligned with alpha logits.
# Reference: search/genotypes.py:5-11.
PRIMITIVES = (
    "skip",          # FactorizedReduce (identity at stride 1)
    "conv",          # 3x3 conv + BN + ReLU
    "conv_downup",   # "zoomed" conv: bilinear /2 -> conv -> bilinear x2
    "conv_2x",       # two 3x3 conv+BN+ReLU blocks
    "conv_2x_downup",  # zoomed double conv
)

NUM_OPS = len(PRIMITIVES)


def _softmax(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x, dtype=np.float64)
    m = np.max(x, axis=-1, keepdims=True)
    # -inf rows: exp(-inf - -inf) would be nan; shift only finite max
    m = np.where(np.isfinite(m), m, 0.0)
    e = np.exp(x - m)
    return e / e.sum(axis=-1, keepdims=True)


@dataclasses.dataclass
class ArchParams:
    """Raw architecture parameters for one searched network.

    alphas[s] has shape (layers - s, NUM_OPS) for scale s in {0,1,2};
    betas[1] (layers-2, 2), betas[2] (layers-3, 2); ratios[s] is
    (layers-1-min(s,1)... , num_widths) following the reference registry
    (search/model_search.py:507-531).
    """

    alphas: List[np.ndarray]
    betas: List[Optional[np.ndarray]]   # [None, beta1, beta2]
    ratios: List[np.ndarray]

    def copy(self) -> "ArchParams":
        return ArchParams(
            alphas=[np.array(a, dtype=np.float64) for a in self.alphas],
            betas=[None if b is None else np.array(b, dtype=np.float64)
                   for b in self.betas],
            ratios=[np.array(r, dtype=np.float64) for r in self.ratios],
        )

    @staticmethod
    def from_npz(path: str) -> "ArchParams":
        d = np.load(path)
        return ArchParams(
            alphas=[d["alpha0"], d["alpha1"], d["alpha2"]],
            betas=[None, d["beta1"], d["beta2"]],
            ratios=[d["ratio0"], d["ratio1"], d["ratio2"]],
        )


@dataclasses.dataclass(frozen=True)
class Genotype:
    """Decoded description of one branch (one output scale)."""

    ops: tuple      # op index per cell
    path: tuple     # scale index per cell
    downs: tuple    # 1 if cell downsamples
    widths: tuple   # width multiplier per transition (len(path)-1)

    def __post_init__(self):
        assert len(self.ops) == len(self.path) == len(self.downs)
        assert len(self.widths) == len(self.path) - 1


def path_to_downs(path: Sequence[int]) -> List[int]:
    """Scale path -> per-cell down flags (reference model_seg.py:15-29)."""
    downs = []
    prev = path[0]
    for node in path[1:]:
        assert node - prev in (0, 1), "path may only stay or descend by 1"
        downs.append(1 if node > prev else 0)
        prev = node
    downs.append(0)
    return downs


def downs_to_path(downs: Sequence[int]) -> List[int]:
    """Per-cell down flags -> scale path (reference model_seg.py:31-38)."""
    path = [0]
    for down in downs[:-1]:
        path.append(path[-1] + int(down))
    return path


def betas_to_path(betas: List[Optional[np.ndarray]], last: int,
                  layers: int) -> List[int]:
    """Pick downsample positions from beta probabilities.

    Reference model_seg.py:98-115: for last=1 the single down position is
    the argmax of beta1[1:-1] down-probabilities (shifted by 1); for last=2
    the pair maximizing the joint probability beta1[i][0]*beta2[j][0] over
    the reference's (i, j) iteration ranges.
    """
    downs = [0] * layers
    if last == 1:
        down_idx = int(np.argmax([b[0] for b in betas[1][1:-1]])) + 1
        downs[down_idx] = 1
    elif last == 2:
        max_prob = 0.0
        max_ij = (0, 1)
        for j in range(layers - 4):
            for i in range(1, j - 1):
                prob = betas[1][i][0] * betas[2][j][0]
                if prob > max_prob:
                    max_ij = (i, j)
                    max_prob = prob
        downs[max_ij[0] + 1] = 1
        downs[max_ij[1] + 2] = 1
    path = downs_to_path(downs)
    assert path[-1] == last
    return path


def path_to_widths(path: Sequence[int], ratios: List[np.ndarray],
                   width_mult_list: Sequence[float]) -> List[float]:
    """Argmax width per transition (reference model_seg.py:117-125)."""
    widths = []
    for layer in range(1, len(path)):
        scale = path[layer]
        row = layer - 1 if scale == 0 else layer - scale
        widths.append(width_mult_list[int(np.argmax(ratios[scale][row]))])
    return widths


def alphas_to_ops_path_width(alphas: List[np.ndarray], path: List[int],
                             widths: List[float],
                             ignore_skip: bool = False):
    """Prune skip cells, keeping branch-length and span invariants.

    Mirrors reference model_seg.py:40-96, including:
      * min_len = round(len(path)/3) + 2*path[-1]
      * a span strictly between consecutive downsamples (and after the last
        down) must retain at least one non-skip cell — the weakest skip in
        an all-skip span is forcibly converted to its next-best op;
      * if too many skips remain, only the highest-softmax-scored
        `len(path) - min_len` are pruned;
      * pruning the final cell also drops the final width entry.
    MUTATES `alphas` in place (-inf writes), as the reference does.
    """
    assert len(path) == len(widths) + 1
    # clamped to the path length: the reference formula (model_seg.py:49)
    # exceeds it for very small supernets (L < 9 with last=2), where its
    # own assert would be unsatisfiable; for the real L=16 they coincide
    min_len = min(int(np.round(len(path) / 3.0)) + path[-1] * 2, len(path))

    pos2alpha_skips = []  # (pos, softmax score of skip) candidates to prune
    for i in range(len(path)):
        scale = path[i]
        if ignore_skip:
            alphas[scale][i - scale][0] = -np.inf
        op = int(np.argmax(alphas[scale][i - scale]))
        if op == 0 and (i == len(path) - 1 or path[i] == path[i + 1]):
            score = _softmax(alphas[scale][i - scale])[0]
            pos2alpha_skips.append((i, score))

    pos_skips = [pos for pos, _ in pos2alpha_skips]
    pos_downs = [p for p in range(len(path) - 1) if path[p] < path[p + 1]]
    if pos_downs:
        pos_downs.append(len(path))
        for k in range(len(pos_downs) - 1):
            pos1, pos2 = pos_downs[k], pos_downs[k + 1]
            if (pos1 + 1 in pos_skips and pos2 - 1 in pos_skips
                    and pos_skips.index(pos2 - 1) - pos_skips.index(pos1 + 1)
                    == (pos2 - 1) - (pos1 + 1)):
                # all-skip span: demote the weakest skip to its runner-up op
                min_skip = [1.0, -1]
                for j in range(pos1 + 1, pos2):
                    scale = path[j]
                    score = _softmax(alphas[scale][j - scale])[0]
                    if score <= min_skip[0]:
                        min_skip = [score, j]
                j = min_skip[1]
                alphas[path[j]][j - path[j]][0] = -np.inf

    if len(pos2alpha_skips) > len(path) - min_len:
        pos2alpha_skips = sorted(pos2alpha_skips, key=lambda t: t[1],
                                 reverse=True)[:len(path) - min_len]
    pos_skips = [pos for pos, _ in pos2alpha_skips]

    ops, path_compact, widths_compact = [], [], []
    for i in range(len(path)):
        scale = path[i]
        op = int(np.argmax(alphas[scale][i - scale]))
        if op == 0:
            if i in pos_skips:
                if i == len(path) - 1:
                    # pruning the terminal skip drops its incoming width
                    widths_compact = widths_compact[:-1]
                continue
            alphas[scale][i - scale][0] = -np.inf
            op = int(np.argmax(alphas[scale][i - scale]))
        path_compact.append(scale)
        if i < len(widths):
            widths_compact.append(widths[i])
        ops.append(op)
    assert len(path_compact) >= min_len
    return ops, path_compact, widths_compact


def network_metas(alphas, betas, ratios, width_mult_list, layers, last,
                  ignore_skip=False):
    """Decode one branch. MUTATES alphas and betas like the reference
    (model_seg.py:127-135): betas are softmaxed in place on every call."""
    betas[1] = _softmax(betas[1])
    betas[2] = _softmax(betas[2])
    path = betas_to_path(betas, last, layers)
    widths = path_to_widths(path, ratios, width_mult_list)
    ops, path, widths = alphas_to_ops_path_width(alphas, path, widths,
                                                 ignore_skip=ignore_skip)
    assert len(ops) == len(path) == len(widths) + 1
    downs = path_to_downs(path)
    return ops, path, downs, widths


def effective_width_mult_list(ratios: List[np.ndarray],
                              width_mult_list: Sequence[float],
                              ignore_skip: bool) -> List[float]:
    """Width list actually used by the derived net.

    When the ratio logits have a single column (teacher search used
    prun_mode 'max', so no width choice), the reference substitutes
    [1.0] for the teacher (ignore_skip) and [4/12] for a 1-wide student
    (train/model_seg.py:182-188)."""
    if ratios[0].shape[1] == 1:
        return [1.0] if ignore_skip else [4.0 / 12]
    return list(width_mult_list)


def decode_network(arch: ArchParams, width_mult_list: Sequence[float],
                   layers: int, ignore_skip: bool = False):
    """Decode all three branches (last = 0, 1, 2) sequentially with shared
    mutable state, exactly as Network_Multi_Path_Infer.__init__ does
    (train/model_seg.py:198-200). Returns {last: Genotype}."""
    a = arch.copy()
    wml = effective_width_mult_list(a.ratios, width_mult_list, ignore_skip)
    genos = {}
    for last in (0, 1, 2):
        ops, path, downs, widths = network_metas(
            a.alphas, a.betas, a.ratios, wml, layers, last,
            ignore_skip=ignore_skip)
        genos[last] = Genotype(ops=tuple(ops), path=tuple(path),
                               downs=tuple(downs), widths=tuple(widths))
    return genos
