"""Post-training int8 quantization of the decoded serving network.

Counterpart of the JAX package's models/quantize.py: every conv weight, 3x3
and 1x1 alike, becomes int8 with per-output-channel symmetric scales (an MSE
search of the clip), and the network serves through the same path as bf16
(weight-only PTQ). Checkpoint weight bytes drop ~4x against fp32.

The quantization runs in numpy float32 on the HWIO layout, as the JAX
package's does, so the int8 values and scales are bit-equal to its on the
same weights. `QuantizedRunner` dequantizes once at construction into a
`DerivedNet` and serves it through `InferenceRunner`: the same kernels,
folding and hi + lo weight packing as the bf16 path. (The JAX runner takes
`qvars` on every call because its weights are a jit argument.)

`qvars` is the storable artifact:

  {"params_q":     the net's state_dict, conv weights as int8 (OIHW),
                   every other entry (BN parameters and statistics, the
                   exempt convs, biases) as it was,
   "params_scale": {key: float32 (O, 1, 1, 1)} for each int8 weight}

and round-trips through `utils.checkpoint.save` / `load`.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple, Union

import numpy as np
import torch

from ..core.plan import NetworkPlan
from ..utils.weights import load_reference_state_dict
from .derived import DerivedNet
from .infer import InferenceRunner

# the clip is searched over absmax * CLIP_RATIOS (quantize.py:69)
CLIP_RATIOS = np.linspace(0.80, 1.0, 11)


def is_exempt(w_oihw, num_classes: int = None) -> bool:
    """The JAX package's shape rule (quantize.py:56), HWIO `shape[2] == 3 or
    shape[3] == num_classes`, in OIHW: the image-entry conv (3 inputs) and
    any conv with `num_classes` outputs stay in the compute dtype, whatever
    its name."""
    shape = np.shape(w_oihw)
    return shape[1] == 3 or (num_classes is not None
                             and shape[0] == num_classes)


def quantize_weight(w_hwio: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(int8 HWIO, float32 (1, 1, 1, O) scale) of one HWIO kernel: the
    per-output-channel clip of least reconstruction MSE over absmax *
    CLIP_RATIOS, round, clip to +-127. The JAX package's arithmetic,
    operation for operation."""
    w = np.asarray(w_hwio, np.float32)
    absmax = np.abs(w).max(axis=(0, 1, 2), keepdims=True)
    absmax = np.where(absmax > 0, absmax, 1.0)
    best_scale, best_err = absmax / 127.0, None
    for r in CLIP_RATIOS:
        scale = absmax * r / 127.0
        qw = np.clip(np.round(w / scale), -127, 127)
        err = ((qw * scale - w) ** 2).sum(axis=(0, 1, 2), keepdims=True)
        if best_err is None:
            best_err, best_scale = err, scale
        else:
            take = err < best_err
            best_err = np.where(take, err, best_err)
            best_scale = np.where(take, scale, best_scale)
    qw = np.clip(np.round(w / best_scale), -127, 127).astype(np.int8)
    return qw, np.asarray(best_scale, np.float32)


def quantize_params(state_dict: Mapping[str, torch.Tensor],
                    num_classes: int = None
                    ) -> Tuple[Dict[str, torch.Tensor],
                               Dict[str, torch.Tensor]]:
    """(q, scales): `state_dict` with every non-exempt 4-D conv weight as
    int8 (OIHW), and its float32 (O, 1, 1, 1) scale under the same key.
    Every other entry passes through, on the CPU."""
    q, scales = {}, {}
    for k, v in state_dict.items():
        v = v.detach().cpu()
        if not (k.endswith(".weight") and v.ndim == 4) or is_exempt(
                v, num_classes):
            q[k] = v
            continue
        # the JAX package's arithmetic on its own (contiguous HWIO) layout,
        # so its sums run in the same order
        w = np.ascontiguousarray(v.float().permute(2, 3, 1, 0).numpy())
        qw, s = quantize_weight(w)
        q[k] = torch.from_numpy(qw).permute(3, 2, 0, 1).contiguous()
        scales[k] = torch.from_numpy(s).permute(3, 2, 0, 1).contiguous()
    return q, scales


def dequantize_params(q: Mapping[str, torch.Tensor],
                      scales: Mapping[str, torch.Tensor],
                      dtype: torch.dtype = torch.bfloat16
                      ) -> Dict[str, torch.Tensor]:
    """The inverse, rounded as the JAX package's (quantize.py:100):
    `(q.float() * s).to(dtype)` for each int8 weight; the rest as it is."""
    return {k: ((v.float() * scales[k]).to(dtype) if v.dtype == torch.int8
                else v) for k, v in q.items()}


class QuantizedRunner(InferenceRunner):
    """An `InferenceRunner` over int8 weights, with its outputs and knobs.
    The weights are dequantized to `dtype` once, here, into a `DerivedNet`,
    which the runner folds as it folds any net."""

    def __init__(self, plan: NetworkPlan, qvars: Mapping,
                 dtype: torch.dtype = torch.bfloat16,
                 device: Union[str, torch.device] = "cuda",
                 fast_stem_enabled: bool = True):
        sd = dequantize_params(qvars["params_q"], qvars["params_scale"],
                               dtype)
        # bf16 weights held exactly in the net's fp32
        net = DerivedNet(plan)
        load_reference_state_dict(net, {k: v.float() if v.is_floating_point()
                                        else v for k, v in sd.items()})
        super().__init__(plan, net, dtype=dtype, device=device,
                         fast_stem_enabled=fast_stem_enabled)


def quantize_variables(plan: NetworkPlan, net: DerivedNet,
                       dtype: torch.dtype = torch.bfloat16,
                       device: Union[str, torch.device] = "cuda",
                       fast_stem_enabled: bool = True
                       ) -> Tuple[Dict, QuantizedRunner]:
    """`net`'s weights -> (int8 qvars, QuantizedRunner)."""
    q, scales = quantize_params(net.state_dict(),
                                num_classes=plan.num_classes)
    qvars = {"params_q": q, "params_scale": scales}
    return qvars, QuantizedRunner(plan, qvars, dtype=dtype, device=device,
                                  fast_stem_enabled=fast_stem_enabled)

