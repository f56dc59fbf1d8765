"""CLI: evaluate a trained network on the validation set.

Counterpart of the JAX package's cli/eval.py (the reference's eval-only
path, train/train.py:155-176 with C.is_eval=True):

  python -m fasterseg_tpu_torch.cli.eval --arch-dir DIR --ckpt CKPT \\
      --data-root ROOT [--scales 0.75 1 1.25] [--flip] [--device cpu]

The forward is the fp32 `InferenceRunner` of the checkpoint's weights, so
on CUDA (the default) it runs the hand-written conv kernels. Reading the
file-list dataset's PNGs needs cv2. `--devices N` shards the images over N
ranks (NCCL on cuda:0..N-1, more ranks than cards raise; gloo with `--device
cpu`) and reduces the counts; with `--spatial` each image is split over H
across the N ranks instead (every conv with its neighbours' halo rows), the
batch-1 full-resolution protocol.
"""

from __future__ import annotations

import argparse
import dataclasses
import os


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--mode", choices=["teacher", "student"],
                   default="student")
    p.add_argument("--arch-dir", required=True)
    p.add_argument("--ckpt", required=True)
    p.add_argument("--data-root", required=True)
    p.add_argument("--scales", type=float, nargs="+", default=[1.0])
    p.add_argument("--flip", action="store_true")
    p.add_argument("--max-items", type=int, default=None)
    p.add_argument("--show-dir", default=None, metavar="DIR",
                   help="also write [image|gt|pred] overlay PNGs for the "
                        "evaluated images (train/eval.py:43-50)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the plain "
                        "versions of the kernels)")
    p.add_argument("--devices", type=int, default=None, metavar="N",
                   help="evaluate over N ranks, the images sharded")
    p.add_argument("--spatial", action="store_true",
                   help="partition each image over H across the --devices "
                        "ranks instead of sharding the images")
    args = p.parse_args(argv)

    from ..parallel import launch, rank_devices
    if args.spatial and not args.devices:
        p.error("--spatial splits each image over the ranks of --devices N")
    if args.devices:
        if args.show_dir:
            p.error("--show-dir writes its panels in one process")
        return launch(_run, args.devices,
                      *rank_devices(args.devices, args.device),
                      args=(args,))[0]
    return _run(None, args)


def _run(mesh, args):
    """The evaluation on this rank (`mesh`) or alone (None); returns the
    EvalResult."""
    from ..core.config import (cityscapes_student_config,
                               cityscapes_teacher_config)
    from ..data import Cityscapes, DataSetting
    from ..train import TrainSession
    from ..utils.logging import get_logger
    from ..utils.visualize import print_iou

    get_logger()
    cfg = (cityscapes_teacher_config() if args.mode == "teacher"
           else cityscapes_student_config())
    ev = dataclasses.replace(cfg.eval, eval_scale_array=tuple(args.scales),
                             eval_flip=args.flip)
    cfg = dataclasses.replace(cfg, eval=ev, is_eval=True)

    session = TrainSession(cfg, args.arch_dir, device=args.device,
                           mesh=mesh)
    session.load_weights(args.ckpt)
    setting = DataSetting(
        img_root=args.data_root, gt_root=args.data_root,
        train_source=os.path.join(args.data_root, cfg.data.train_source),
        eval_source=os.path.join(args.data_root, cfg.data.eval_source))
    val = Cityscapes(setting, "val")
    res = session.evaluate(val, max_items=args.max_items,
                           spatial=args.spatial)
    if mesh is None or mesh.rank == 0:
        print(print_iou(res.iou_per_class, res.pixel_acc,
                        Cityscapes.class_names))

    if args.show_dir:
        import cv2
        import torch
        from ..data.preprocess import eval_preprocess
        from ..utils.visualize import show_img

        os.makedirs(args.show_dir, exist_ok=True)
        runner = session.runner()
        n = min(len(val), args.max_items or len(val))
        for i in range(n):
            s = val[i]
            x = eval_preprocess(s["data"], cfg.data.image_mean,
                                cfg.data.image_std)
            pred = runner.classmap(torch.from_numpy(x[None]))[0].cpu().numpy()
            panel = show_img(s["data"].astype("uint8"),
                             s["label"].astype("int32"), pred,
                             Cityscapes.colors)
            name = os.path.splitext(os.path.basename(s["fn"]))[0] + ".png"
            cv2.imwrite(os.path.join(args.show_dir, name), panel[..., ::-1])
    return res


if __name__ == "__main__":
    main()
