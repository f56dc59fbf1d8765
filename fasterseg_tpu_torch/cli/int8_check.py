"""CLI: int8 PTQ acceptance on the mIoU study's trained student.

Counterpart of scripts/int8_check.py, through the port's kernels:

  python -m fasterseg_tpu_torch.cli.int8_check \\
      [--ckpt artifacts/miou_study_torch/student_ckpt] [--device cuda]

The student is the study's (cli/miou_study.py): the shipped arch_1 genotype,
its branches picked by the stored search objective, stem/head width 8/12, 8
classes. Over the 40 val scenes at 256x512 it compares the bf16 class maps of
`InferenceRunner` and of `QuantizedRunner` (both through the kernels on the
card) with each other and with a plain fp32 control (the plain net, TF32
off), and scores each against the labels. The JAX acceptance
(scripts/int8_check.py:140-142): int8-vs-bf16 agreement >= max(min(99.9,
bf16-vs-fp32 - 0.05), 99.5) %, and |mIoU(int8) - mIoU(bf16)| < 0.2 points.
The same acceptance is also read in the JAX package's arithmetic (the plain
bf16 nets, conv weights rounded to bf16) on the same weights. The port
holds its own agreement bar (`agreement_bar`): the JAX floor, or, where the
JAX arithmetic misses that floor on the same weights too, no more than
0.05 pp below the JAX arithmetic's agreement. Prints one JSON line, writes
it to --out, and exits 1 when the JAX acceptance of the kernel paths is
missed.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
from typing import Dict, List, Mapping, Sequence, Tuple, Union

import torch

from .miou_study import N_VAL, OUT, gpu_line, render, study_config


@contextlib.contextmanager
def no_tf32():
    """fp32 products and convs in full fp32 while the block runs."""
    before = (torch.backends.cudnn.allow_tf32,
              torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = before


def load_student(ckpt: str):
    """(plan, net) of the study's student, its weights from `ckpt` (a
    state_dict written by the study)."""
    from ..models import DerivedNet, student_plan
    from ..utils.checkpoint import load
    plan = student_plan(num_classes=8)
    net = DerivedNet(plan)
    net.load_state_dict(load(ckpt))
    return plan, net


def tensor_bytes(tree) -> int:
    """Bytes of the tensors of a (nested) dict of tensors."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    return sum(tensor_bytes(v) for v in tree.values())


def inputs(scenes: Sequence[Mapping], device: Union[str, torch.device]
           ) -> List[torch.Tensor]:
    """The study's eval preprocessing of each scene: (1, H, W, 3) fp32 on
    `device`."""
    from ..data.preprocess import eval_preprocess
    data = study_config("student").data
    return [torch.from_numpy(eval_preprocess(s["data"], data.image_mean,
                                             data.image_std)[None]).to(device)
            for s in scenes]


def classmaps(fn, xs) -> List[torch.Tensor]:
    """(H, W) class map of each input."""
    return [fn(x)[0] for x in xs]


def agreement_pct(maps_a: Sequence[torch.Tensor],
                  maps_b: Sequence[torch.Tensor]) -> float:
    """Share of pixels, in %, on which two lists of class maps agree."""
    same = sum(int((p == q).sum()) for p, q in zip(maps_a, maps_b))
    return 100.0 * same / sum(p.numel() for p in maps_a)


def check(plan, net, scenes: Sequence[Mapping],
          device: Union[str, torch.device] = "cuda") -> Tuple:
    """Class maps of `scenes` from the bf16 kernel path, the int8 kernel
    path (`QuantizedRunner`), the plain fp32 net (the control) and the int8
    weights' own plain fp32 net; agreements in % of pixels, mIoU of each
    against the labels, and the kernel launches of each kernel path.

    The same comparison also runs in the JAX package's arithmetic: the
    plain bf16 nets, whose conv weights are rounded to bf16 as the JAX
    runners round them ("bf16_plain", and "int8_plain" on the dequantized
    weights); `result["jax_arithmetic"]` holds its agreements and delta.

    Returns (result, qvars, runner, maps): the JSON-ready result, the int8
    weights and their bf16 `QuantizedRunner`, and the class maps of each
    path ("bf16", "int8", "fp32", "int8_fp32", "bf16_plain", "int8_plain"),
    for callers that read more from the same run."""
    from .. import kernels
    from ..eval import compute_score, confusion_hist
    from ..models import InferenceRunner, QuantizedRunner, quantize_variables
    data = study_config("student").data
    n = plan.num_classes
    sync = (torch.cuda.synchronize if torch.device(device).type == "cuda"
            else lambda: None)
    xs = inputs(scenes, device)
    labels = [torch.from_numpy(s["label"]).to(device) for s in scenes]
    qvars, qrunner = quantize_variables(plan, net, dtype=torch.bfloat16,
                                        device=device)
    maps, launches = {}, {}
    with no_tf32():
        maps["fp32"] = classmaps(InferenceRunner(
            plan, net, dtype=torch.float32, device=device,
            fast_stem_enabled=False).classmap, xs)
        maps["int8_fp32"] = classmaps(QuantizedRunner(
            plan, qvars, dtype=torch.float32, device=device,
            fast_stem_enabled=False).classmap, xs)
        maps["bf16_plain"] = classmaps(InferenceRunner(
            plan, net, dtype=torch.bfloat16, device=device,
            fast_stem_enabled=False).classmap, xs)
        maps["int8_plain"] = classmaps(QuantizedRunner(
            plan, qvars, dtype=torch.bfloat16, device=device,
            fast_stem_enabled=False).classmap, xs)
        for name, runner in (("bf16", InferenceRunner(
                plan, net, dtype=torch.bfloat16, device=device)),
                ("int8", qrunner)):
            sync()
            kernels.reset_launch_counts()
            maps[name] = classmaps(runner.classmap, xs)
            sync()
            launches[name] = kernels.launch_counts()

    def agree(a, b) -> float:
        return agreement_pct(maps[a], maps[b])

    def miou(name) -> float:
        hist = sum(confusion_hist(p, lab, n, data.ignore_label)
                   for p, lab in zip(maps[name], labels))
        return compute_score(hist)[1]

    mious = {name: miou(name) for name in ("bf16", "int8", "fp32",
                                           "bf16_plain", "int8_plain")}
    result = {
        "images": len(scenes), "hw": list(scenes[0]["label"].shape),
        "classmap_agreement_pct": agree("int8", "bf16"),
        "bf16_vs_f32_agreement_pct": agree("bf16", "fp32"),
        "int8_vs_int8_fp32_plain_pct": agree("int8", "int8_fp32"),
        "mIoU_bf16": mious["bf16"], "mIoU_int8": mious["int8"],
        "mIoU_fp32": mious["fp32"],
        "mIoU_delta_points": 100.0 * (mious["int8"] - mious["bf16"]),
        "jax_arithmetic": {
            "classmap_agreement_pct": agree("int8_plain", "bf16_plain"),
            "bf16_vs_f32_agreement_pct": agree("bf16_plain", "fp32"),
            "mIoU_delta_points": 100.0 * (mious["int8_plain"]
                                          - mious["bf16_plain"])},
        "launches": launches,
        "qvars_bytes": tensor_bytes(qvars),
        "fp32_state_dict_bytes": tensor_bytes(net.state_dict()),
    }
    return result, qvars, qrunner, maps


def acceptance(result: Mapping) -> Dict:
    """The JAX acceptance (scripts/int8_check.py:140-142) on `result`: the
    agreement floor, and whether each of its two bars is met."""
    floor = max(min(99.9, result["bf16_vs_f32_agreement_pct"] - 0.05), 99.5)
    return {"agreement_floor_pct": floor,
            "agreement_met": result["classmap_agreement_pct"] >= floor,
            "delta_met": abs(result["mIoU_delta_points"]) < 0.2}


JAX_ARITHMETIC_MARGIN_PP = 0.05


def agreement_bar(result: Mapping) -> Dict:
    """The int8-vs-bf16 agreement bar the port holds on `result`: the JAX
    acceptance's floor, unless the JAX package's arithmetic
    (`result["jax_arithmetic"]`) misses that floor on the same weights too
    (the quantizer, bit-equal to the JAX package's, then sets the miss);
    there the kernel path's agreement may lie no more than 0.05 pp below
    the JAX arithmetic's, the rule the bf16 phases hold against the plain
    bf16 path. Returns the rule, the floor and whether it is met."""
    acc = acceptance(result)
    jax_own = result["jax_arithmetic"]
    if acc["agreement_met"] or acceptance(jax_own)["agreement_met"]:
        rule, floor = "jax_floor", acc["agreement_floor_pct"]
    else:
        rule = "jax_arithmetic_less_0.05pp"
        floor = jax_own["classmap_agreement_pct"] - JAX_ARITHMETIC_MARGIN_PP
    return {"rule": rule, "floor_pct": floor,
            "met": result["classmap_agreement_pct"] >= floor}


def failures(result: Mapping) -> List[str]:
    """What `result` misses of the JAX acceptance: empty when it is met."""
    acc = acceptance(result)
    out = []
    if not acc["agreement_met"]:
        out.append(f"int8 vs bf16 class maps agree on "
                   f"{result['classmap_agreement_pct']} % < "
                   f"{acc['agreement_floor_pct']} %")
    if not acc["delta_met"]:
        out.append(f"mIoU delta {result['mIoU_delta_points']} points, "
                   f"not < 0.2")
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--ckpt", default=os.path.join(OUT, "student_ckpt"),
                   help="the study's student state_dict")
    p.add_argument("--out", default=os.path.join(OUT, "int8_check.json"))
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the plain "
                        "versions of the kernels)")
    args = p.parse_args(argv)

    from ..kernels import resolve_device
    device = resolve_device(args.device)
    plan, net = load_student(args.ckpt)
    res = check(plan, net, render(N_VAL, "val"), device)[0]
    result = {"ckpt": args.ckpt, "gpu": gpu_line(device), **res}
    result["failures"] = failures(result)
    result["jax_arithmetic_failures"] = failures(result["jax_arithmetic"])
    result["agreement_bar"] = agreement_bar(result)
    print(json.dumps(result), flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f)
    if result["failures"]:
        sys.exit(1)
    return result


if __name__ == "__main__":
    main()
