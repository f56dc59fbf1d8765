"""CLI: supernet pretrain and architecture search.

Counterpart of the JAX package's cli/train_search.py (the reference's
`python search/train_search.py`, config-file driven):

  python -m fasterseg_tpu_torch.cli.train_search --pretrain          # stage 1
  python -m fasterseg_tpu_torch.cli.train_search --load RUN_DIR      # stage 2
  python -m fasterseg_tpu_torch.cli.train_search --synthetic --device cpu \\
      --layers 5 --epochs 1 --niters 2 --height 64 --width 128

Runs on CUDA unless `--device cpu`, with cuDNN autotuning its convs. The
latency LUT is the reference's own table (1080Ti, TensorRT) unless `--lut`
names another (for example the H100 table,
fasterseg_tpu_torch/latency/h100_lut.json); on the card, keys missing from
it are measured through the kernels (latency/measure.py) and saved into it
(not under `--devices`, where the table must hold every key).
The student's FPS band is the reference's [155, 175] (`--fps-band ref`, the
default), the reference's relative band around the shipped student's
estimate on the LUT in use (`auto`, latency/derived.py `fps_band`), or an
explicit MIN,MAX. `--devices N` searches data-parallel on N ranks: NCCL on
cuda:0..N-1 (more ranks than cards raise) or gloo with `--device cpu`; the
global batch must divide by N. `--bf16` runs the supernet in bf16 on fp32
parameters (`SearchConfig.compute_dtype`).
"""

from __future__ import annotations

import argparse
import dataclasses
import os


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--pretrain", action="store_true",
                   help="supernet pretrain stage (no arch updates)")
    p.add_argument("--load", default=None,
                   help="pretrained weights dir to start the search from")
    p.add_argument("--data-root", default=None)
    p.add_argument("--synthetic", action="store_true",
                   help="synthetic data (smoke runs without Cityscapes)")
    p.add_argument("--save", default="runs/search")
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--niters", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--height", type=int, default=None,
                   help="override the train crop height (smoke runs)")
    p.add_argument("--width", type=int, default=None)
    p.add_argument("--layers", type=int, default=None)
    p.add_argument("--Fch", type=int, default=None)
    p.add_argument("--bf16", action="store_true",
                   help="supernet compute in bf16 (parameters, optimizer "
                        "state and arch parameters stay fp32)")
    p.add_argument("--lut", default=None,
                   help="latency LUT json path (default: the reference's "
                        "table, latency/reference_lut.json)")
    p.add_argument("--resume", default=None, metavar="RUN_DIR",
                   help="resume bit-exactly from an existing run dir "
                        "(weights, both optimizers, controller, epoch)")
    p.add_argument("--fps-band", default="ref", metavar="REF|AUTO|MIN,MAX",
                   help="student FPS band of the latency-weight controller: "
                        "'ref' keeps the reference's [155, 175] "
                        "(config_search.py:85-86); 'auto' scales the "
                        "reference's relative band by the LUT's estimate of "
                        "the shipped student; MIN,MAX sets it")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda)")
    p.add_argument("--devices", type=int, default=None, metavar="N",
                   help="data-parallel over N ranks (parameters replicated, "
                        "each global batch sharded); the global batch must "
                        "divide by N")
    args = p.parse_args(argv)

    from ..parallel import launch, rank_devices
    from ..utils.logging import create_exp_dir
    ranks = rank_devices(args.devices, args.device) if args.devices else None
    save_dir = args.resume or create_exp_dir(
        args.save, "pretrain" if args.pretrain else "search")
    if ranks is None:
        return _run(args, save_dir)
    launch(_run_rank, args.devices, *ranks, args=(args, save_dir))


def _run_rank(mesh, args, save_dir) -> None:
    _run(args, save_dir, mesh)


def _run(args, save_dir: str, mesh=None):
    import torch
    torch.backends.cudnn.benchmark = True

    from ..core.config import (cityscapes_pretrain_config,
                               cityscapes_search_config)
    from ..data import Cityscapes, DataSetting
    from ..latency import LatencyLUT, fps_band, reference_lut
    from ..models import student_plan
    from ..models.infer import resolve_device
    from ..search import run_search
    from ..utils.logging import get_logger

    device = resolve_device(args.device if mesh is None else mesh.device)
    lut = None
    if args.lut:
        provider = None
        # ranks would each measure a missing key anew and price the archs
        # apart: under --devices the table must hold every key
        if device.type == "cuda" and mesh is None:
            from ..latency.measure import measured_provider
            provider = measured_provider(device=device)
        lut = LatencyLUT(args.lut, provider=provider)
    band = args.fps_band.lower()

    cfg = (cityscapes_pretrain_config() if args.pretrain
           else cityscapes_search_config())
    data = cfg.data
    if args.data_root:
        data = dataclasses.replace(data, dataset_path=args.data_root)
    if args.synthetic:
        data = dataclasses.replace(data, synthetic=True)
    if args.batch_size:
        data = dataclasses.replace(data, batch_size=args.batch_size)
    if args.height:
        data = dataclasses.replace(data, image_height=args.height)
    if args.width:
        data = dataclasses.replace(data, image_width=args.width)
    overrides = dict(data=data)
    if args.load:
        overrides["load_path"] = args.load
    if args.layers:
        overrides["layers"] = args.layers
    if args.Fch:
        overrides["Fch"] = args.Fch
    if args.bf16:
        overrides["compute_dtype"] = "bfloat16"
    if band != "ref":
        if band == "auto":
            lo, hi = fps_band(lut if lut is not None else reference_lut(),
                              student_plan())
        else:
            lo, hi = (float(v) for v in args.fps_band.split(","))
        overrides.update(fps_min=(0.0, lo), fps_max=(0.0, hi))
    cfg = dataclasses.replace(cfg, **overrides)

    logger = get_logger(log_file=os.path.join(save_dir, "log.txt")
                        if mesh is None or mesh.rank == 0 else None)
    logger.info("config: %s", cfg)
    logger.info("student FPS band: [%.1f, %.1f]", cfg.fps_min[-1],
                cfg.fps_max[-1])

    val_dataset = None
    if not args.synthetic and args.data_root:
        setting = DataSetting(
            img_root=data.dataset_path, gt_root=data.dataset_path,
            train_source=os.path.join(data.dataset_path, data.train_source),
            eval_source=os.path.join(data.dataset_path, data.eval_source),
            down_sampling=data.down_sampling)
        val_dataset = Cityscapes(setting, "val")

    engine = run_search(cfg, val_dataset=val_dataset, epochs=args.epochs,
                        niters=args.niters, save_dir=save_dir, lut=lut,
                        resume=bool(args.resume), device=device,
                        mesh=mesh)
    logger.info("done; artifacts in %s", save_dir)
    return engine


if __name__ == "__main__":
    main()
