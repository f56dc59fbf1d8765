"""CLI: the ProcCity mIoU convergence study, trained and evaluated by the port.

Counterpart of scripts/miou_study.py's `tpu` stage, with a report that sets
the port's rows beside the JAX package's columns of MIOU.md:

  python -m fasterseg_tpu_torch.cli.miou_study train --stage teacher --epochs 8
  python -m fasterseg_tpu_torch.cli.miou_study train --stage student \\
      --teacher artifacts/miou_study_torch/teacher_ckpt --epochs 8
  python -m fasterseg_tpu_torch.cli.miou_study report

The protocol is the JAX script's: 160 train / 40 val ProcCity scenes at
256x512 (seed 0, 8 classes, ignore 255 on boundaries), batch 8, 20 steps an
epoch, the shipped genotypes and the full recipe (teacher arch_0 with OHEM +
0.2 aux; student arch_1 adding KL from the frozen teacher), whole-image
single-scale eval after every epoch. The scenes are rendered once into
memory, since reading the PNG lists needs cv2; they equal the PNG round
trip, and the loader's batches equal the JAX loader's. Evaluation is
`TrainSession.evaluate`, the fp32 `InferenceRunner`: on the card, the conv
kernels. One JSON row an epoch goes to the log (the JAX schema, side
"torch", with the card's name and power limit), and the trained state_dict
to --out. `--device` defaults to cuda.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
# the JAX script's data root: its config names it, the port reads no file
ROOT = os.path.join(REPO, "artifacts", "proccity")
OUT = os.path.join(REPO, "artifacts", "miou_study_torch")
ASSETS = os.path.join(REPO, "tests", "assets")

HW = (256, 512)
N_TRAIN, N_VAL = 160, 40
BATCH = 8
NITERS = N_TRAIN // BATCH          # 20 steps an epoch
DATA_SEED = 0

# The JAX package's val mIoU after each epoch (steps 20, 40, ...), from
# MIOU.md: "tpu / teacher" and "tpu / student" (40 epochs each, the student
# from the 40-epoch teacher), "tpu / teacher8" and "tpu / student8" (8
# epochs, the student from the 8-epoch teacher). teacher8 is the first 8
# epochs of teacher.
JAX_VAL_MIOU = {
    "teacher": (
        0.1252, 0.2516, 0.4696, 0.5212, 0.5199, 0.5267, 0.5529, 0.5724,
        0.5665, 0.5889, 0.5881, 0.6030, 0.5784, 0.5993, 0.6049, 0.6065,
        0.6041, 0.6127, 0.6068, 0.6195, 0.6250, 0.6161, 0.6267, 0.6395,
        0.6362, 0.6389, 0.6389, 0.6300, 0.6490, 0.6413, 0.6365, 0.6463,
        0.6482, 0.6403, 0.6500, 0.6492, 0.6603, 0.6603, 0.6548, 0.6560),
    "student": (
        0.2899, 0.3684, 0.5211, 0.5780, 0.5725, 0.5824, 0.6072, 0.6268,
        0.6308, 0.6347, 0.6286, 0.6207, 0.6428, 0.6410, 0.6553, 0.6577,
        0.6576, 0.6616, 0.6481, 0.6690, 0.6680, 0.6634, 0.6754, 0.6752,
        0.6813, 0.6853, 0.6824, 0.6773, 0.6775, 0.6724, 0.6758, 0.6928,
        0.6964, 0.6989, 0.6948, 0.6978, 0.7161, 0.7188, 0.7218, 0.7285),
    "teacher8": (0.1252, 0.2516, 0.4696, 0.5212, 0.5199, 0.5267, 0.5529,
                 0.5724),
    "student8": (0.2174, 0.4538, 0.5183, 0.5612, 0.5712, 0.5618, 0.5985,
                 0.6111),
}


def jax_val_miou(column: str, step: int) -> Optional[float]:
    """The JAX column's val mIoU at `step`, or None beyond it."""
    epoch, rest = divmod(step, NITERS)
    vals = JAX_VAL_MIOU[column]
    return vals[epoch - 1] if rest == 0 and 1 <= epoch <= len(vals) else None


def study_config(mode: str, hw: Tuple[int, int] = HW, batch: int = BATCH,
                 niters: int = NITERS):
    """scripts/miou_study.py's `study_config`, field by field (at its
    defaults): 8 classes, scales (0.75, 1, 1.25), single-scale eval without
    flip after every epoch, the teacher or student recipe."""
    from ..core.config import (DataConfig, EvalConfig,
                               cityscapes_student_config,
                               cityscapes_teacher_config)
    data = DataConfig(dataset_path=ROOT, train_source="train.txt",
                      eval_source="val.txt", test_source="val.txt",
                      num_classes=8, image_height=hw[0], image_width=hw[1],
                      batch_size=batch, train_scale_array=(0.75, 1.0, 1.25))
    ev = EvalConfig(eval_height=hw[0], eval_width=hw[1],
                    eval_scale_array=(1.0,), eval_flip=False)
    ctor = (cityscapes_teacher_config if mode == "teacher"
            else cityscapes_student_config)
    return ctor(data=data, eval=ev, niters_per_epoch=niters, eval_every=1)


def render(n: int, split: str, hw: Tuple[int, int] = HW,
           threads: int = 8) -> List[Dict]:
    """The first `n` ProcCity scenes of `split` (seed 0), rendered once
    into memory on `threads` threads: the samples `write_dataset` would
    write as PNGs and the file-list dataset would read back."""
    from ..data.procgen import ProcCity
    scenes = ProcCity(length=n, hw=hw, seed=DATA_SEED, split=split)
    with ThreadPoolExecutor(threads) as ex:
        return list(ex.map(scenes.__getitem__, range(n)))


def train_loader(cfg, scenes: Sequence[Dict]):
    """`get_train_loader`'s TrainPre and TrainLoader over in-memory scenes."""
    from ..data import TrainLoader, TrainPre
    d = cfg.data
    pre = TrainPre(d.image_mean, d.image_std, (d.image_height, d.image_width),
                   d.train_scale_array, d.gt_down_sampling, d.ignore_label)
    return TrainLoader(scenes, pre, d.batch_size, seed=cfg.seed)


def gpu_line(device: torch.device) -> Optional[str]:
    """The card's name and power limit as nvidia-smi prints them; None on
    the CPU."""
    if device.type != "cuda":
        return None
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def run_stage(stage: str, epochs: int, train_scenes: Sequence[Dict],
              val_scenes: Sequence[Dict], teacher_ckpt: Optional[str] = None,
              out: Optional[str] = None, log: Optional[str] = None,
              tag: Optional[str] = None, cfg=None,
              device: Union[str, torch.device] = "cuda",
              on_row: Callable[[Dict], None] = print):
    """Train `stage` ("teacher" or "student" from `teacher_ckpt`) for
    `epochs` epochs, evaluating after each. Each row goes to `on_row` and is
    appended to `log` (JSON lines); the trained state_dict is saved to
    `out`. The nets start from the JAX package's own draw for the config's
    seed (`weights.init_jax_draw_`). Returns (rows, session)."""
    from ..train import TrainSession
    from ..utils.checkpoint import save
    cfg = cfg or study_config(stage)
    session = TrainSession(cfg, ASSETS, device=device)
    if stage == "student" and teacher_ckpt is None:
        raise ValueError("the student stage needs a teacher checkpoint")
    if stage == "student":
        res = session.load_teacher_weights(teacher_ckpt)
        if res.missing or res.mismatched:
            raise ValueError(f"teacher checkpoint {teacher_ckpt}: "
                             f"{len(res.missing)} missing, "
                             f"{len(res.mismatched)} mismatched")
    gpu = gpu_line(session.device)
    niters = cfg.niters_per_epoch
    loader = train_loader(cfg, train_scenes)
    rows = []
    t0 = time.perf_counter()
    try:
        for epoch in range(epochs):
            t = time.perf_counter()
            stats = session.train_epoch(loader, epoch, niters)
            t_train = time.perf_counter() - t
            res = session.evaluate(val_scenes)
            row = {"side": "torch", "stage": tag or stage, "epoch": epoch,
                   "step": (epoch + 1) * niters, "loss": stats["loss"],
                   "train_mIoU": stats["train_mIoU"],
                   "val_mIoU": float(res.mean_iu),
                   "wall_s": time.perf_counter() - t0, "train_s": t_train,
                   "eval_s": time.perf_counter() - t - t_train,
                   "backend": session.device.type, "gpu": gpu}
            rows.append(row)
            on_row(row)
            if log:
                os.makedirs(os.path.dirname(os.path.abspath(log)),
                            exist_ok=True)
                with open(log, "a") as f:
                    f.write(json.dumps(row) + "\n")
    finally:
        loader.close()
    if out:
        save(out, session.model.state_dict())
    return rows, session


def read_rows(log_dir: str) -> List[Dict]:
    """Every row of the `torch_*.jsonl` logs in `log_dir`."""
    rows = []
    for name in sorted(os.listdir(log_dir)):
        if name.startswith("torch_") and name.endswith(".jsonl"):
            with open(os.path.join(log_dir, name)) as f:
                rows += [json.loads(line) for line in f if line.strip()]
    return rows


def report(rows: Sequence[Dict]) -> str:
    """A markdown table a stage: the port's val mIoU at each step beside the
    JAX package's 8-epoch and 40-epoch columns (MIOU.md) and the deltas.
    A student's right column is the one its teacher's length matches."""
    by: Dict[str, Dict[int, Dict]] = {}
    for r in rows:
        by.setdefault(r["stage"], {})[r["step"]] = r  # the last run wins
    lines = []
    for stage, steps in sorted(by.items()):
        base = "teacher" if stage.startswith("teacher") else "student"
        gpu = next((r["gpu"] for r in steps.values() if r.get("gpu")), None)
        lines += [f"## torch / {stage} ({gpu or 'cpu'})", "",
                  f"| step | loss | port val mIoU | JAX {base}8 | delta | "
                  f"JAX {base} (40 epochs) | delta |",
                  "|---|---|---|---|---|---|---|"]
        for step, r in sorted(steps.items()):
            cells = []
            for col in (base + "8", base):
                want = jax_val_miou(col, step)
                cells += (["—", "—"] if want is None else
                          [f"{want:.4f}", f"{r['val_mIoU'] - want:+.4f}"])
            lines.append(f"| {step} | {r['loss']:.3f} | {r['val_mIoU']:.4f} "
                         f"| " + " | ".join(cells) + " |")
        lines.append("")
    return "\n".join(lines)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = p.add_subparsers(dest="cmd", required=True)
    tp = sub.add_parser("train")
    tp.add_argument("--stage", choices=("teacher", "student"),
                    default="teacher")
    tp.add_argument("--epochs", type=int, default=40)
    tp.add_argument("--tag", default=None,
                    help="log and checkpoint tag (default: the stage)")
    tp.add_argument("--teacher", default=os.path.join(OUT, "teacher_ckpt"),
                    help="the teacher's state_dict, for the student stage")
    tp.add_argument("--out", default=None,
                    help="where the trained state_dict goes (default "
                         "LOG_DIR/TAG_ckpt)")
    tp.add_argument("--log-dir", default=OUT)
    tp.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "versions of the kernels)")
    rp = sub.add_parser("report")
    rp.add_argument("--log-dir", default=OUT)
    args = p.parse_args(argv)

    if args.cmd == "report":
        text = report(read_rows(args.log_dir))
        print(text)
        return text
    torch.backends.cudnn.benchmark = True    # as cli/train.py sets it
    tag = args.tag or args.stage
    t0 = time.perf_counter()
    train, val = render(N_TRAIN, "train"), render(N_VAL, "val")
    print(json.dumps({"rendered": N_TRAIN + N_VAL, "hw": list(HW),
                      "seconds": time.perf_counter() - t0}), flush=True)
    rows, _ = run_stage(
        args.stage, args.epochs, train, val, teacher_ckpt=args.teacher,
        out=args.out or os.path.join(args.log_dir, f"{tag}_ckpt"),
        log=os.path.join(args.log_dir, f"torch_{tag}.jsonl"), tag=tag,
        device=args.device,
        on_row=lambda r: print(json.dumps(r), flush=True))
    print(f"done: final val mIoU {rows[-1]['val_mIoU']:.4f}")
    return rows


if __name__ == "__main__":
    main()
