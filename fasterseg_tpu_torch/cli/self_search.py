"""CLI: FasterSeg's whole loop on ProcCity, run by the port.

Counterpart of scripts/self_search.py, with its stages, defaults and
configurations (16 layers, Fch 12, five widths; ProcCity 160 train / 40 val
scenes at 256x512, 8 classes):

  pretrain  supernet weight pretraining (the sandwich rule, no arch steps)
  search    bi-level search with the latency term and the FPS-band
            controller; validation and decoded FPS every epoch
            -> search/arch_{0,1}.npz, search/band.json
  train     the teacher, then the distilled student, decoded from this
            run's own genotypes (--plan searched) or from the shipped ones
            through the same recipe (--plan shipped, the control arm)
  fps       the searched student's FPS at 1024x2048: the LUT's estimate and
            the graph-slope time of `.logits` through the kernels
  report    SEARCH.md in --out: the band, the search trajectory, the
            genotype plots, the outcome against the control arm
  chain     every stage in scripts/self_search_chain.sh's order, each
            resuming where it stopped, then both control arms, fps, report

  python -m fasterseg_tpu_torch.cli.self_search pretrain [--epochs 20]
  python -m fasterseg_tpu_torch.cli.self_search search [--epochs 30]
  python -m fasterseg_tpu_torch.cli.self_search train --stage teacher \\
      [--plan searched|shipped] [--epochs 40]
  python -m fasterseg_tpu_torch.cli.self_search fps
  python -m fasterseg_tpu_torch.cli.self_search report
  python -m fasterseg_tpu_torch.cli.self_search chain

Every subcommand takes --out (default artifacts/self_search_torch/),
--device (default cuda; cpu runs the kernels' plain versions), --niters (steps
an epoch; default the config's), --max-eval-items (val scenes a validation;
default all 40) and --lut (default the H100 table, latency/h100_lut.json).
--layers, --Fch, --scenes, --hw, --search-crop and --fps-hw shrink the run
for a CPU smoke (the tests run `chain` at 5 layers, Fch 8, 64x128).

Deliberate differences from the JAX script:

* Data in memory. The ProcCity scenes are rendered once into memory
  (cli/miou_study.py `render`) instead of read from PNG file lists, which
  need cv2 (the GPU host has none). The loaders take them through
  `data.InMemoryDataset`, which selects as the file-list dataset does (the
  same permutation, the same `portion` halves, the same shard), so every
  batch equals the file-list route's over `write_dataset`'s PNGs.
* Table and band. The H100 table and `latency.fps_band` (the reference's
  relative band around the shipped student's estimate) replace the v5e
  table and `tpu_fps_band`. The table holds every key of the supernet, the
  stems and the shipped and round-4 searched students' 8-class walks; a key
  it lacks (a newly searched genotype's refine width) is measured through
  the kernels on the card and priced by `H100CostModel` on the CPU, as the
  JAX script's `TpuCostModel` prices it; neither is written to the table.
  The band the search ran with goes to search/band.json.
* bf16 search, as the JAX script's: pretrain and search set
  `compute_dtype="bfloat16"`.
* fps has no fallback. The JAX script falls back to its XLA body when its
  fused path fails (scripts/self_search.py:250-259); here any failure
  raises, and fps.json records the path served (`serving_path`: "kernels"
  on the card, where both conv kernels launched; "plain" on the CPU, which
  runs their plain versions), the kernels' launch counts and the card's name
  and power limit.
* report writes OUT/SEARCH.md and its plots beside it, never the repo's
  SEARCH.md; without matplotlib it says so in one line and writes the rest.
* chain makes no git commits and has no deadline, and it trains the
  control arms (the report needs them; the JAX chain leaves them to a
  separate run). Checkpoints are the port's state_dicts.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
# the JAX script's data root: its configs name it, the port reads no file
ROOT = os.path.join(REPO, "artifacts", "proccity")
OUT = os.path.join(REPO, "artifacts", "self_search_torch")
ASSETS = os.path.join(REPO, "tests", "assets")

HW = (256, 512)
SEARCH_CROP = (224, 448)    # search crops as the reference's
N_TRAIN, N_VAL = 160, 40
NUM_CLASSES = 8
FPS_HW = (1024, 2048)
# the JAX report's band where the search wrote none (its round-4 run)
HAND_PICKED_BAND = (250.0, 290.0)
STUDENT_SHW = (8.0 / 12, 8.0 / 12)


@dataclasses.dataclass(frozen=True)
class Setup:
    """What a run shares across its stages: where it writes, the device,
    the search geometry and the scenes' size (the JAX script's constants
    unless a smoke run shrinks them)."""

    out: str = OUT
    device: str = "cuda"
    layers: int = 16
    Fch: int = 12
    hw: Tuple[int, int] = HW
    search_crop: Tuple[int, int] = SEARCH_CROP
    scenes: Tuple[int, int] = (N_TRAIN, N_VAL)
    fps_hw: Tuple[int, int] = FPS_HW
    niters: Optional[int] = None
    max_eval_items: Optional[int] = None
    lut_path: Optional[str] = None


def lut(setup: Setup):
    """The latency table, read-only: a key it lacks is measured through the
    kernels on the card (`measured_provider`) and priced by the H100 cost
    model elsewhere, and kept in memory."""
    from ..latency import H100CostModel, LatencyLUT
    from ..latency.lut import H100_LUT
    from ..kernels import resolve_device
    device = resolve_device(setup.device)
    if device.type == "cuda":
        from ..latency.measure import measured_provider
        provider = measured_provider(device=device)
    else:
        provider = H100CostModel().provider
    table = LatencyLUT(setup.lut_path or H100_LUT, provider=provider)
    table.path = None
    return table


def shipped_student_plan(num_classes: int = NUM_CLASSES):
    """The shipped student genotype decoded with the ProcCity head."""
    from ..models import student_plan
    return student_plan(num_classes=num_classes)


def band(table) -> Tuple[float, float]:
    """The student's FPS band on `table`'s scale: `latency.fps_band` around
    the shipped student, rounded to 0.1 FPS as the JAX script rounds it."""
    from ..latency import fps_band
    lo, hi = fps_band(table, shipped_student_plan())
    return (round(lo, 1), round(hi, 1))


def search_config(pretrain: bool, fps: Tuple[float, float],
                  setup: Setup = Setup()):
    """scripts/self_search.py's `search_config`: ProcCity at `hw`, batch 2
    (search crops `search_crop`), pretrain batch 3 at `hw`, bf16 compute,
    the student's band `fps`; search starts from the pretrained weights."""
    from ..core.config import DataConfig, EvalConfig, SearchConfig
    hw, crop = setup.hw, setup.search_crop
    data = DataConfig(
        dataset_path=ROOT, train_source="train.txt", eval_source="val.txt",
        test_source="val.txt", num_classes=NUM_CLASSES,
        num_train_imgs=setup.scenes[0], num_eval_imgs=setup.scenes[1],
        image_height=hw[0] if pretrain else crop[0],
        image_width=hw[1] if pretrain else crop[1],
        batch_size=2, gt_down_sampling=8, down_sampling=1)
    return SearchConfig(
        data=data, eval=EvalConfig(eval_height=hw[0], eval_width=hw[1]),
        layers=setup.layers, Fch=setup.Fch,
        pretrain=pretrain, num_classes=NUM_CLASSES,
        compute_dtype="bfloat16",
        pretrain_image_hw=hw, pretrain_batch_size=3,
        fps_min=(0.0, fps[0]), fps_max=(0.0, fps[1]),
        load_path=os.path.join(setup.out, "pretrain") if not pretrain
        else None)


def train_config(mode: str, plan: str = "searched", setup: Setup = Setup()):
    """scripts/self_search.py's `train_config`: batch 8 at `hw`, an epoch a
    pass over the train scenes, evaluation every epoch. The shipped plan's
    genotypes are 16-layer Fch-12 ones whatever the search's size."""
    from ..core.config import (DataConfig, EvalConfig,
                               cityscapes_student_config,
                               cityscapes_teacher_config)
    hw, (n_train, n_val) = setup.hw, setup.scenes
    data = DataConfig(
        dataset_path=ROOT, train_source="train.txt", eval_source="val.txt",
        test_source="val.txt", num_classes=NUM_CLASSES,
        num_train_imgs=n_train, num_eval_imgs=n_val,
        image_height=hw[0], image_width=hw[1], batch_size=8)
    ev = EvalConfig(eval_height=hw[0], eval_width=hw[1])
    ctor = (cityscapes_teacher_config if mode == "teacher"
            else cityscapes_student_config)
    size = {} if plan == "shipped" else {"layers": setup.layers,
                                         "Fch": setup.Fch}
    return ctor(data=data, eval=ev, niters_per_epoch=n_train // 8,
                eval_every=1, **size)


def scenes(setup: Setup) -> Tuple[List[Dict], List[Dict]]:
    """The train and val scenes (ProcCity, seed 0), rendered into memory:
    the samples `write_dataset` writes as PNGs."""
    from .miou_study import render
    return (render(setup.scenes[0], "train", setup.hw),
            render(setup.scenes[1], "val", setup.hw))


def _search(setup: Setup, pretrain: bool, epochs: int, train, val,
            fps: Tuple[float, float]):
    from ..data import InMemoryDataset
    from ..search import run_search
    name = "pretrain" if pretrain else "search"
    return run_search(search_config(pretrain, fps, setup), val_dataset=val,
                      epochs=epochs, niters=setup.niters,
                      save_dir=os.path.join(setup.out, name),
                      max_eval_items=setup.max_eval_items, lut=lut(setup),
                      resume=True,
                      dataset_cls=InMemoryDataset.bind(train), save_every=3,
                      device=setup.device)


def stage_pretrain(setup: Setup, epochs: int, train, val):
    """Supernet pretrain (resumes); returns the engine."""
    return _search(setup, True, epochs, train, val, band(lut(setup)))


def stage_search(setup: Setup, epochs: int, train, val):
    """Bi-level search from the pretrained weights (resumes), after writing
    the band it runs with to search/band.json; returns the engine."""
    fps = band(lut(setup))
    sdir = os.path.join(setup.out, "search")
    os.makedirs(sdir, exist_ok=True)
    with open(os.path.join(sdir, "band.json"), "w") as f:
        json.dump({"fps_band": list(fps), "fps_min": [0.0, fps[0]],
                   "fps_max": [0.0, fps[1]]}, f)
    return _search(setup, False, epochs, train, val, fps)


def _suffix(plan: str) -> str:
    return "" if plan == "searched" else f"_{plan}"


def stage_train(setup: Setup, stage: str, plan: str, epochs: int, train,
                val, on_row=print) -> List[Dict]:
    """The teacher or the student (from this plan's teacher checkpoint)
    for `epochs` epochs (resumes), evaluated after each; a JSON row an
    epoch to train_{stage}{suffix}.jsonl and `on_row`; the teacher's
    state_dict to teacher_ckpt{suffix}. Returns this call's rows."""
    from ..data import InMemoryDataset, get_train_loader
    from ..train import TrainSession
    from ..utils.checkpoint import save
    cfg = train_config(stage, plan, setup)
    suffix = _suffix(plan)
    arch_dir = (os.path.join(setup.out, "search") if plan == "searched"
                else ASSETS)
    session = TrainSession(cfg, arch_dir, device=setup.device)
    if stage == "student":
        tpath = os.path.join(setup.out, f"teacher_ckpt{suffix}")
        if not os.path.exists(tpath):
            raise FileNotFoundError(
                f"{tpath}: run `train --stage teacher --plan {plan}` first")
        res = session.load_teacher_weights(tpath)
        if res.missing or res.mismatched:
            raise ValueError(f"teacher checkpoint {tpath}: "
                             f"{len(res.missing)} missing, "
                             f"{len(res.mismatched)} mismatched")
    sdir = os.path.join(setup.out, f"train_{stage}{suffix}")
    start = session.restore(sdir)
    if start:
        print(f"resumed {stage}{suffix} at epoch {start}", flush=True)
    loader = get_train_loader(cfg, InMemoryDataset.bind(train))
    niters = setup.niters or cfg.niters_per_epoch
    log = os.path.join(setup.out, f"train_{stage}{suffix}.jsonl")
    os.makedirs(setup.out, exist_ok=True)
    rows, t0 = [], time.perf_counter()
    try:
        for epoch in range(start, epochs):
            stats = session.train_epoch(loader, epoch, niters)
            res = session.evaluate(val, max_items=setup.max_eval_items)
            row = {"stage": stage, "plan": plan, "epoch": epoch,
                   "step": (epoch + 1) * niters, "loss": stats["loss"],
                   "val_mIoU": float(res.mean_iu),
                   "wall_s": time.perf_counter() - t0,
                   "backend": session.device.type}
            rows.append(row)
            on_row(row)
            with open(log, "a") as f:
                f.write(json.dumps(row) + "\n")
            if (epoch + 1) % 3 == 0 or epoch == epochs - 1:
                session.save(sdir, epoch)
    finally:
        loader.close()
    if stage == "teacher":
        save(os.path.join(setup.out, f"teacher_ckpt{suffix}"),
             session.model.state_dict())
    return rows


def searched_student_plan(arch_path: str, layers: int = 16, Fch: int = 12,
                          num_classes: int = NUM_CLASSES):
    """The searched student (arch_1.npz) decoded as the JAX script's
    `_searched_student_plan` does: skips kept, branches chosen by the
    stored objective, the student's stem and head width. Returns (plan,
    lasts)."""
    import numpy as np
    from ..core import ArchParams
    from ..core.config import WIDTH_MULT_LIST
    from ..core.genotype import decode_network
    from ..core.plan import build_plan, select_lasts
    d = np.load(arch_path)
    genos = decode_network(ArchParams.from_npz(arch_path), WIDTH_MULT_LIST,
                           layers=layers, ignore_skip=False)
    lasts = select_lasts(float(d["mIoU02"]), float(d["latency02"]),
                         float(d["mIoU12"]), float(d["latency12"]))
    return build_plan(genos, list(lasts), Fch=Fch, num_classes=num_classes,
                      stem_head_width=STUDENT_SHW), list(lasts)


def stage_fps(setup: Setup) -> Dict:
    """The searched student's FPS at `fps_hw`: the LUT's estimate and
    `.logits` in bf16 through the kernels (their plain versions on the
    CPU), timed by `graph_slope_ms` (seeded weights: the JAX package's draw
    for seed 0). No fallback: a failure raises. Writes fps.json."""
    from .. import kernels
    from ..latency import derived_latency_ms
    from ..latency.measure import graph_slope_ms
    from ..models import DerivedNet, InferenceRunner
    from ..kernels import resolve_device
    from ..utils.weights import init_jax_draw_
    from .miou_study import gpu_line
    device = resolve_device(setup.device)
    plan, lasts = searched_student_plan(
        os.path.join(setup.out, "search", "arch_1.npz"), setup.layers,
        setup.Fch)
    est_ms = derived_latency_ms(lut(setup), plan, setup.fps_hw)
    net = init_jax_draw_(DerivedNet(plan), 0)
    runner = InferenceRunner(plan, net, dtype=torch.bfloat16, device=device)
    x = torch.randn((1, *setup.fps_hw, 3),
                    generator=torch.Generator().manual_seed(1)
                    ).to(device=device, dtype=torch.bfloat16)
    kernels.reset_launch_counts()
    ms, spread, kind = graph_slope_ms(lambda: runner.logits(x), n1=1, n2=6,
                                      reps=5, device=device)
    launches = kernels.launch_counts()
    served = ("kernels" if device.type == "cuda"
              and launches["conv3x3_bn_relu_s1"] > 0
              and launches["conv3x3_bn_relu_s2"] > 0 else "plain")
    row = {"lasts": lasts, "lut_est_ms": est_ms,
           "lut_est_fps": 1000.0 / est_ms, "measured_ms": ms,
           "measured_fps": 1000.0 / ms, "spread_pct": spread,
           "spread_kind": kind, "serving_path": served,
           "launches": launches, "device": device.type,
           "input_hw": list(setup.fps_hw), "gpu": gpu_line(device)}
    os.makedirs(setup.out, exist_ok=True)
    with open(os.path.join(setup.out, "fps.json"), "w") as f:
        json.dump(row, f)
    return row


# ---- report ----


def trajectory_lines(metrics_path: str, fps: Tuple[float, float]
                     ) -> List[str]:
    """The student's search trajectory table and its in-band epochs line,
    from the search run's metrics.jsonl, as the JAX report writes them."""
    with open(metrics_path) as f:
        rows = [json.loads(line) for line in f if line.strip()]
    tags = ("arch/fps0_student", "arch/fps1_student",
            "arch/latency_weight_student", "mIoU/val_student_16s_32s")
    traj: Dict[int, Dict[str, float]] = {}
    for r in rows:
        if r.get("tag") in tags:
            traj.setdefault(r["step"], {})[r["tag"]] = r["value"]
    if not traj:
        return []

    def cell(t, k, f):
        return (f % t[k]) if k in t else "-"

    lines = ["## Search trajectory (student)", "",
             "| epoch | LUT FPS [2,0] | LUT FPS [2,1] | "
             "latency weight (next) | val mIoU (16s_32s) |",
             "|---|---|---|---|---|"]
    for step in sorted(traj):
        t = traj[step]
        lines.append("| %d | %s | %s | %s | %s |" % (
            step, cell(t, tags[0], "%.1f"), cell(t, tags[1], "%.1f"),
            cell(t, tags[2], "%g"), cell(t, tags[3], "%.4f")))
    in_band = [s for s in sorted(traj) if tags[1] in traj[s]
               and fps[0] <= traj[s][tags[1]] <= fps[1]]
    return lines + ["", f"Epochs with the [2,1] student inside the {fps} "
                        f"band: {in_band}.", ""]


def genotype_lines(arch_path: str, out: str, layers: int = 16
                   ) -> List[str]:
    """The searched student's genotype plots (written into `out`) and its
    decoded cells per branch. Without matplotlib, one line says the plots
    were not rendered; no other error is caught."""
    from ..core import ArchParams
    from ..core.config import WIDTH_MULT_LIST
    from ..core.genotype import decode_network
    genos = decode_network(ArchParams.from_npz(arch_path), WIDTH_MULT_LIST,
                           layers=layers, ignore_skip=False)
    lines = ["## Searched student genotype", ""]
    try:
        import matplotlib.pyplot as plt
    except ImportError:
        plt = None
    if plt is None:
        lines.append("(genotype plots not rendered: matplotlib is not "
                     "installed on this host)")
    else:
        from ..utils.plotting import plot_op, plot_path_width
        figures = {f"searched_ops{last}.png": plot_op(g.ops, g.path,
                                                      g.widths)
                   for last, g in genos.items()}
        figures["searched_path_width.png"] = plot_path_width(
            [2, 1, 0], [genos[b].path for b in (2, 1, 0)],
            [genos[b].widths for b in (2, 1, 0)])
        for name, fig in figures.items():
            fig.savefig(os.path.join(out, name), dpi=90,
                        bbox_inches="tight")
            plt.close(fig)
        lines += ["![ops](searched_ops1.png)",
                  "![path](searched_path_width.png)"]
    lines += ["", "Decoded cells per branch: " + ", ".join(
        f"1/{8 * 2 ** s}s: {genos[s].ops}" for s in sorted(genos)), ""]
    return lines


def final_miou(out: str, name: str) -> Tuple[float, int]:
    """(val mIoU, epochs) of a train log's last row; a missing arm
    raises, naming the stage to run."""
    path = os.path.join(out, name)
    rows = []
    if os.path.exists(path):
        with open(path) as f:
            rows = [json.loads(line) for line in f if line.strip()]
    if not rows:
        raise FileNotFoundError(
            f"report: {name} not found in {out}: run the missing chain "
            "stage (searched arms: `train --stage teacher|student`; control "
            "arms: `train --stage teacher|student --plan shipped`)")
    return rows[-1]["val_mIoU"], rows[-1]["epoch"] + 1


def report(setup: Setup) -> str:
    """OUT/SEARCH.md with the JAX report's sections; returns its text."""
    out, hw = setup.out, setup.hw
    sdir = os.path.join(out, "search")
    band_path = os.path.join(sdir, "band.json")
    if os.path.exists(band_path):
        with open(band_path) as f:
            fps = tuple(json.load(f)["fps_band"])
        band_src = ("latency/derived.py fps_band: the reference's relative "
                    "band around the shipped student's estimate on the "
                    "H100 table")
    else:
        fps = HAND_PICKED_BAND
        band_src = "hand-picked, as the JAX chain's round-4 run"
    lines = ["# End-to-end NAS self-search (ProcCity), PyTorch port", "",
             "The FasterSeg loop run by fasterseg_tpu_torch: supernet "
             "pretrain -> bi-level search (latency term priced by the H100 "
             "table, FPS-band controller) -> decode this run's own genotypes "
             "-> teacher training -> KL-distilled student -> eval, by "
             "fasterseg_tpu_torch/cli/self_search.py; stage logs, fps.json "
             f"and the decoded arch_*.npz in {out}.", "",
             "All mIoU numbers below are whole-image eval on ProcCity val "
             f"({setup.scenes[1]} images at {hw[0]}x{hw[1]}, at most "
             f"{setup.max_eval_items or setup.scenes[1]} a validation).", "",
             f"Search space/config: {setup.layers} layers, Fch {setup.Fch}, "
             f"5 widths, ProcCity {hw[0]}x{hw[1]} {NUM_CLASSES}-class, bf16 "
             f"compute, pretrain batch 3 @{hw[0]}x{hw[1]}, search batch 2 "
             f"@{setup.search_crop[0]}x{setup.search_crop[1]}, student FPS "
             f"band {fps} ({band_src}; it plays the role the reference's "
             "[155,175] plays around its 159.7 LUT-FPS shipped student, "
             "config_search.py:85-86).", ""]
    mpath = os.path.join(sdir, "metrics.jsonl")
    if os.path.exists(mpath):
        lines += trajectory_lines(mpath, fps)
    lines += genotype_lines(os.path.join(sdir, "arch_1.npz"), out,
                            setup.layers)

    searched_t, ep_t = final_miou(out, "train_teacher.jsonl")
    searched_s, ep_s = final_miou(out, "train_student.jsonl")
    shipped_t, ep_ct = final_miou(out, "train_teacher_shipped.jsonl")
    shipped_s, ep_cs = final_miou(out, "train_student_shipped.jsonl")
    fps_row = None
    if os.path.exists(os.path.join(out, "fps.json")):
        with open(os.path.join(out, "fps.json")) as f:
            fps_row = json.load(f)
    lines += [
        "## Outcome vs shipped genotype (same-session control)", "",
        "Both columns are one study: identical recipe, config, seeds, data "
        f"and epochs (searched teacher/student {ep_t}/{ep_s}, control "
        f"{ep_ct}/{ep_cs}); the control arm trains the reference's shipped "
        "genotypes (tests/assets arch_{0,1}) through the same stages "
        "(`train --plan shipped`).", "",
        "| | searched (this run) | shipped genotype (same-session "
        "control) |", "|---|---|---|",
        f"| teacher val mIoU | {searched_t:.4f} | {shipped_t:.4f} |",
        f"| student val mIoU (distilled) | {searched_s:.4f} | "
        f"{shipped_s:.4f} |"]
    if fps_row:
        h, w = fps_row["input_hw"]
        lines.append(
            f"| student FPS @{h}x{w} (LUT est / measured, "
            f"{fps_row['serving_path']}, {fps_row['gpu'] or 'cpu'}) | "
            f"{fps_row['lut_est_fps']:.1f} / {fps_row['measured_fps']:.1f} "
            "| - |")
    lines.append("")
    text = "\n".join(lines) + "\n"
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "SEARCH.md"), "w") as f:
        f.write(text)
    return text


def chain(setup: Setup, epochs: Dict[str, int], train, val) -> str:
    """pretrain -> search -> teacher -> student (searched), then the
    control arms, fps and the report (scripts/self_search_chain.sh's
    order); each stage resumes where an earlier run stopped."""
    stage_pretrain(setup, epochs["pretrain"], train, val)
    stage_search(setup, epochs["search"], train, val)
    for plan in ("searched", "shipped"):
        for stage in ("teacher", "student"):
            stage_train(setup, stage, plan, epochs["train"], train, val)
    print(json.dumps(stage_fps(setup)), flush=True)
    return report(setup)


def _pair(text: str) -> Tuple[int, int]:
    a, b = (int(v) for v in text.split(","))
    return a, b


def main(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    common = argparse.ArgumentParser(add_help=False)
    common.add_argument("--out", default=OUT)
    common.add_argument("--device", default="cuda",
                        help="torch device (default cuda)")
    common.add_argument("--niters", type=int, default=None,
                        help="steps an epoch (default the config's)")
    common.add_argument("--max-eval-items", type=int, default=None,
                        help="val scenes a validation (default all)")
    common.add_argument("--lut", default=None,
                        help="latency table (default latency/h100_lut.json)")
    common.add_argument("--layers", type=int, default=16)
    common.add_argument("--Fch", type=int, default=12)
    common.add_argument("--scenes", type=_pair, default=(N_TRAIN, N_VAL),
                        metavar="TRAIN,VAL")
    common.add_argument("--hw", type=_pair, default=HW, metavar="H,W")
    common.add_argument("--search-crop", type=_pair, default=SEARCH_CROP,
                        metavar="H,W")
    common.add_argument("--fps-hw", type=_pair, default=FPS_HW,
                        metavar="H,W")
    sub = p.add_subparsers(dest="cmd", required=True)
    sub.add_parser("pretrain", parents=[common]).add_argument(
        "--epochs", type=int, default=20)
    sub.add_parser("search", parents=[common]).add_argument(
        "--epochs", type=int, default=30)
    tp = sub.add_parser("train", parents=[common])
    tp.add_argument("--stage", choices=("teacher", "student"),
                    default="teacher")
    tp.add_argument("--plan", choices=("searched", "shipped"),
                    default="searched",
                    help="'shipped': the control arm, the shipped genotypes "
                         "through the same recipe")
    tp.add_argument("--epochs", type=int, default=40)
    sub.add_parser("fps", parents=[common])
    sub.add_parser("report", parents=[common])
    cp = sub.add_parser("chain", parents=[common])
    cp.add_argument("--pretrain-epochs", type=int, default=20)
    cp.add_argument("--search-epochs", type=int, default=30)
    cp.add_argument("--train-epochs", type=int, default=40)
    args = p.parse_args(argv)

    setup = Setup(out=args.out, device=args.device, layers=args.layers,
                  Fch=args.Fch, hw=args.hw, search_crop=args.search_crop,
                  scenes=args.scenes, fps_hw=args.fps_hw, niters=args.niters,
                  max_eval_items=args.max_eval_items, lut_path=args.lut)
    if args.cmd == "fps":
        row = stage_fps(setup)
        print(json.dumps(row))
        return row
    if args.cmd == "report":
        text = report(setup)
        print(text)
        return text
    torch.backends.cudnn.benchmark = True    # as cli/train.py sets it
    train, val = scenes(setup)
    if args.cmd == "pretrain":
        return stage_pretrain(setup, args.epochs, train, val)
    if args.cmd == "search":
        return stage_search(setup, args.epochs, train, val)
    if args.cmd == "train":
        rows = stage_train(setup, args.stage, args.plan, args.epochs, train,
                           val, on_row=lambda r: print(json.dumps(r),
                                                       flush=True))
        if rows:
            print(f"done: final val mIoU {rows[-1]['val_mIoU']:.4f}")
        return rows
    text = chain(setup, {"pretrain": args.pretrain_epochs,
                         "search": args.search_epochs,
                         "train": args.train_epochs}, train, val)
    print(text)
    return text


if __name__ == "__main__":
    main()
