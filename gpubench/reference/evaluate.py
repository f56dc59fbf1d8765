"""Plain evaluation arithmetic: normalisation, the confusion hist of the
whole-image protocol, and the logit gap of a served class map.

Frozen copies of the published protocol (FasterSeg tools/engine/evaluator.py
`whole_eval` + `val_func_process`, tools/seg_opr/metric.py `hist_info`):
images /255, minus the ImageNet mean, over its std; probabilities
exp(log_softmax) of the full-resolution logits; the class map their argmax;
hist[label, pred] over pixels whose label is a class.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch



def normalise(images_u8: torch.Tensor, mean: Sequence[float],
              std: Sequence[float]) -> torch.Tensor:
    """uint8 NHWC -> normalised fp32 NCHW."""
    x = images_u8.float() / 255.0
    m = torch.tensor(mean, device=x.device)
    s = torch.tensor(std, device=x.device)
    return ((x - m) / s).permute(0, 3, 1, 2).contiguous()


def hist(pred: torch.Tensor, label: torch.Tensor, n: int,
         ignore: int) -> torch.Tensor:
    """(n, n) int64 counts of (label, pred) over pixels labelled 0..n-1."""
    label = label.long().reshape(-1)
    pred = pred.long().reshape(-1)
    ok = (label >= 0) & (label < n) & (label != ignore)
    return torch.bincount(n * label[ok] + pred[ok], minlength=n * n
                          ).reshape(n, n)


def hist_distance(a: torch.Tensor, b: torch.Tensor) -> float:
    """Half the L1 distance of two hists over the labelled pixels: a lower
    bound on the share of those pixels whose predictions differ."""
    a, b = a.double(), b.double()
    return float((a - b).abs().sum() / 2 / a.sum().clamp(min=1))


def classmap_gap(ref_logits: torch.Tensor, classmap: torch.Tensor) -> Dict:
    """How far a class map's classes lie below the reference's best logit.
    ref_logits (1, C, H, W) fp32, classmap (1, H, W) integer. Returns the
    widest gap, the same in units of the reference logits' standard
    deviation on this frame, the mean gap and the share of pixels whose
    class is not the reference's argmax."""
    best = ref_logits.amax(1)
    got = torch.gather(ref_logits, 1, classmap.long()[:, None])[:, 0]
    gap = best - got
    widest = float(gap.max())
    return {"widest": widest, "widest_rel": widest / float(ref_logits.std()),
            "mean": float(gap.mean()),
            "flipped": float((classmap.long() != ref_logits.argmax(1))
                             .double().mean())}


def hist_of_logits(logits_nhwc: torch.Tensor, labels: torch.Tensor, n: int,
                   ignore: int) -> torch.Tensor:
    """The protocol's hist from NHWC logits: exp(log_softmax) over the last
    axis in fp32, its argmax, the counts."""
    prob = torch.exp(torch.log_softmax(logits_nhwc.float(), -1))
    return hist(torch.argmax(prob, -1), labels, n, ignore)


def logit_error(logits_nhwc: torch.Tensor, ref_nchw: torch.Tensor) -> float:
    """max |logits - reference| in units of the reference's standard
    deviation."""
    diff = (logits_nhwc.float().permute(0, 3, 1, 2) - ref_nchw).abs().max()
    return float(diff) / float(ref_nchw.std())
