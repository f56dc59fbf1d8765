"""Differentiable expected supernet latency.

Counterpart of the JAX package's latency/estimator.py (the reference's
Network_Multi_Path.forward_latency, model_search.py:361-476): the expected
latency under the current architecture distribution, differentiable with
respect to alpha (op mix), beta (downsample topology) and ratio (width)
parameters, as a gather and a contraction over the tensors of
latency/tables.py on the device.

* Per-cell latency = sum_op alpha_op * LUT[op, w_in, w_out] * s_in * s_out,
  (w, s) the hard width index and its straight-through score (the
  reference's MixedOp.forward_latency, model_search.py:80-99).
* The beta-weighted path recurrence follows model_search.py:456-469, with
  its sequential update in which a cell's down-branch accumulator sees its
  own keep-branch latency, and with the JAX package's one fix: the
  reference indexes `betas[j][i-j-1]` with a stale loop variable j
  (model_search.py:468-469); the accumulating scale's own beta,
  betas[ii][i-ii-1], is used (PARITY.md).
* The architect's switches (architect.py:62-74) are `use_alpha` and
  `use_beta`; a term that is off uses uniform alpha or beta. Widths are off
  when the caller passes 'max' samples.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

from .tables import has_down, scales_at

RatioSample = Tuple[torch.Tensor, torch.Tensor]


def cell_ratio_wiring(ratios: Sequence[RatioSample], i: int, j: int,
                      layers: int, stem_pin: RatioSample,
                      head_pin: RatioSample):
    """(in, out, down) width samples of cell (layer i, scale j)
    (model_search.py:297-316). The supernet's forward and this estimator
    share it, so compute and latency always agree."""
    at = lambda s, k: (ratios[s][0][k], ratios[s][1][k])
    if i == 0 and j == 0:
        return (stem_pin, at(0, 0), at(1, 0))
    if i == layers - 1:
        r_in = at(j, i - j - 1) if j == 0 else at(j, i - j)
        return (r_in, head_pin, None)
    if j == 2:
        return (at(2, i - 2), at(2, i - 1), None)
    if j == 0:
        return (at(0, i - 1), at(0, i), at(1, i))
    return (at(1, i - 1), at(1, i), at(2, i - 1))


def _cell_ms(table_ij: torch.Tensor, alpha: torch.Tensor,
             r_in: RatioSample, r_out: RatioSample) -> torch.Tensor:
    # gathers: indexing with the 0-d index tensors would read them to
    # the host
    v = table_ij.index_select(1, r_in[0].reshape(1)).index_select(
        2, r_out[0].reshape(1))[:, 0, 0]            # (num_ops,)
    return torch.dot(alpha, v) * r_in[1] * r_out[1]


def expected_latency_ms(tables: Dict[str, torch.Tensor], stem_ms: float,
                        alphas, betas, ratios: Sequence[RatioSample],
                        layers: int, stem_pin: RatioSample,
                        head_pin: RatioSample, use_alpha: bool = True,
                        use_beta: bool = True) -> torch.Tensor:
    """Expected end-to-end ms (a 0-d tensor). `tables` = {'keep', 'down'}
    tensors (L, 3, 5, nw, nw) on the arch parameters' device; `ratios` are
    (idx, score) per-layer samples of the three scales."""
    keep_t, down_t = tables["keep"], tables["down"]
    num_ops = keep_t.shape[2]
    ref = alphas[0]

    if use_alpha:
        al = [torch.softmax(a, -1) for a in alphas]
    else:
        al = [torch.full_like(a, 1.0 / num_ops) for a in alphas]
    if use_beta:
        be = [None, torch.softmax(betas[1], -1), torch.softmax(betas[2], -1)]
    else:
        be = [None, torch.full_like(betas[1], 0.5),
              torch.full_like(betas[2], 0.5)]

    zero = ref.new_zeros(())
    # accumulators per scale: [keep_path_ms, down_path_ms]
    total = [[ref.new_full((), stem_ms), zero], [zero, zero], [zero, zero]]

    for i in range(layers):
        lat: List[List[Optional[torch.Tensor]]] = []
        for j in range(scales_at(i)):
            alpha = al[j][i - j]
            r_in, r_out, r_down = cell_ratio_wiring(ratios, i, j, layers,
                                                    stem_pin, head_pin)
            k_ms = _cell_ms(keep_t[i, j], alpha, r_in, r_out)
            d_ms = None
            if has_down(i, j, layers):
                d_ms = _cell_ms(down_t[i, j], alpha, r_in, r_down)
            lat.append([k_ms, d_ms])

        for ii, l in enumerate(lat):
            if ii == 0:
                total[0][0] = total[0][0] + l[0]
                if l[1] is not None:
                    total[0][1] = total[0][0] + l[1]
            elif i == ii:
                total[ii][0] = total[ii - 1][1] + l[0]
                if l[1] is not None:
                    total[ii][1] = total[ii - 1][1] + l[1]
            else:
                w = be[ii][i - ii - 1]
                total[ii][0] = (w[1] * total[ii][0] + w[0] * total[ii - 1][1]
                                + l[0])
                if l[1] is not None:
                    total[ii][1] = (w[1] * total[ii][0]
                                    + w[0] * total[ii - 1][1] + l[1])
        # scales beyond the current layer keep their accumulators

    return total[0][0] + total[1][0] + total[2][0]
