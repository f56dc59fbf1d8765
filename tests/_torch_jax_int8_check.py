"""The JAX package's int8 acceptance on a state_dict the port trained.

    JAX_PLATFORMS=cpu python tests/_torch_jax_int8_check.py CKPT [CKPT ...]

CKPT is a student state_dict written by `fasterseg_tpu_torch.cli.miou_study`
(8 classes). Each is imported into the JAX package's DerivedNet
(`utils/torch_import.import_derived_state_dict`) and put through
scripts/int8_check.py's measurement as that script runs it off the TPU (the
plain flax network): over the study's 40 val scenes at 256x512, the bf16
path's class maps against the int8 path's and against the fp32 control,
the mIoU of each, and the acceptance floor. One JSON line a checkpoint.
This tells a port fault from a property of the weights: the same bar, the
same weights, the JAX package's own int8 path.
"""

import dataclasses
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from fasterseg_tpu.data.preprocess import eval_preprocess  # noqa: E402
from fasterseg_tpu.eval.metrics import compute_score, confusion_hist  # noqa: E402
from fasterseg_tpu.models import (InferenceRunner, create_derived,  # noqa: E402
                                  student_plan)
from fasterseg_tpu.models.quantize import quantize_variables  # noqa: E402
from fasterseg_tpu.utils.torch_import import import_derived_state_dict  # noqa: E402
from fasterseg_tpu_torch.cli.miou_study import HW, N_VAL, render  # noqa: E402

MEAN, STD = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)


def check(ckpt: str, val) -> dict:
    plan = dataclasses.replace(student_plan(), num_classes=8)
    sd = {k: v.numpy() for k, v in torch.load(
        ckpt, map_location="cpu", weights_only=True).items()}
    variables = jax.tree_util.tree_map(jnp.asarray,
                                       import_derived_state_dict(sd, plan))
    runner = InferenceRunner(plan, variables, dtype=jnp.bfloat16,
                             fast_stem_enabled=False)
    qvars, qrunner = quantize_variables(plan, variables,
                                        fast_stem_enabled=False)
    model32, _ = create_derived(plan, jax.random.PRNGKey(0), input_hw=HW,
                                dtype=jnp.float32)
    cm_fn = jax.jit(lambda v, x: jnp.argmax(runner.logits_fn(v, x), -1))
    qcm_fn = jax.jit(lambda v, x: jnp.argmax(qrunner.logits_fn(v, x), -1))
    f32_fn = jax.jit(lambda v, x: jnp.argmax(
        model32.apply(v, x.astype(jnp.float32), train=False), -1))
    hist_bf, hist_q = np.zeros((8, 8), np.int64), np.zeros((8, 8), np.int64)
    agree = agree_ctrl = total = 0
    for s in val:
        x = jnp.asarray(eval_preprocess(s["data"], MEAN, STD)[None])
        cm = np.asarray(cm_fn(variables, x))[0]
        qcm = np.asarray(qcm_fn(qvars, x))[0]
        ctrl = np.asarray(f32_fn(variables, x))[0]
        lab = s["label"].astype(np.int64)
        agree += int((cm == qcm).sum())
        agree_ctrl += int((cm == ctrl).sum())
        total += cm.size
        hist_bf += np.asarray(confusion_hist(cm, lab, 8), np.int64)
        hist_q += np.asarray(confusion_hist(qcm, lab, 8), np.int64)
    miou_bf, miou_q = compute_score(hist_bf)[1], compute_score(hist_q)[1]
    out = {"ckpt": ckpt, "classmap_agreement_pct": 100.0 * agree / total,
           "bf16_vs_f32_agreement_pct": 100.0 * agree_ctrl / total,
           "mIoU_bf16": float(miou_bf), "mIoU_int8": float(miou_q),
           "mIoU_delta_points": 100.0 * float(miou_q - miou_bf)}
    out["agreement_floor_pct"] = max(
        min(99.9, out["bf16_vs_f32_agreement_pct"] - 0.05), 99.5)
    return out


if __name__ == "__main__":
    scenes = render(N_VAL, "val")
    for path in sys.argv[1:]:
        print(json.dumps(check(path, scenes)), flush=True)
