"""CLI: train decoded networks from scratch (teacher, then student).

Counterpart of the JAX package's cli/train.py (the reference's
`python train/train.py` with its mode switch, config_train.py:77-104):

  python -m fasterseg_tpu_torch.cli.train --mode teacher --arch-dir DIR
  python -m fasterseg_tpu_torch.cli.train --mode student --arch-dir DIR \\
      --teacher-ckpt RUN/weights0_ckpt
  python -m fasterseg_tpu_torch.cli.train --mode student --eval ...  # eval only
  python -m fasterseg_tpu_torch.cli.train --mode student --test ...  # submission
  python -m fasterseg_tpu_torch.cli.train --synthetic --device cpu \\
      --arch-dir tests/assets --epochs 1 --niters 2 --height 64 --width 128

Runs on CUDA unless `--device cpu`, with cuDNN autotuning its convs
(`torch.backends.cudnn.benchmark`). `--devices N` trains data-parallel on N
ranks (`parallel.launch`): NCCL on cuda:0..N-1 (more ranks than cards
raise) or gloo with `--device cpu`; the global batch must divide by N.
"""

from __future__ import annotations

import argparse
import dataclasses
import os


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--mode", choices=["teacher", "student"],
                   default="student")
    p.add_argument("--arch-dir", required=True,
                   help="dir with arch_{0,1}.npz (or reference .pt)")
    p.add_argument("--teacher-ckpt", default=None)
    p.add_argument("--data-root", default=None)
    p.add_argument("--dataset",
                   choices=["cityscapes", "bdd", "camvid", "proccity"],
                   default="cityscapes",
                   help="dataset schema for --data-root (file-list layout; "
                        "proccity: data/procgen.py write_dataset)")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--save", default="runs/train")
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--niters", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--height", type=int, default=None,
                   help="override the train crop height (smoke runs)")
    p.add_argument("--width", type=int, default=None)
    p.add_argument("--eval", action="store_true", dest="is_eval")
    p.add_argument("--test", action="store_true", dest="is_test")
    p.add_argument("--eval-ckpt", default=None)
    p.add_argument("--resume", default=None, metavar="RUN_DIR",
                   help="resume bit-exactly from an existing run dir "
                        "(weights, optimizer incl. LR position, epoch)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the plain "
                        "versions of the kernels)")
    p.add_argument("--devices", type=int, default=None, metavar="N",
                   help="data-parallel over N ranks (parameters replicated, "
                        "each global batch sharded); the global batch must "
                        "divide by N")
    args = p.parse_args(argv)
    if args.is_test and not args.data_root:
        p.error("--test needs --data-root")
    if args.is_test and args.devices:
        p.error("--test writes its predictions in one process")

    from ..parallel import launch, rank_devices
    from ..utils.logging import create_exp_dir
    ranks = rank_devices(args.devices, args.device) if args.devices else None
    save_dir = args.resume or create_exp_dir(args.save,
                                             f"train-{args.mode}")
    if ranks is None:
        return _run(args, save_dir)
    launch(_run_rank, args.devices, *ranks, args=(args, save_dir))


def _run_rank(mesh, args, save_dir) -> None:
    _run(args, save_dir, mesh)


def _run(args, save_dir: str, mesh=None):
    import torch
    # cuDNN's heuristic choice for fp32 convs without TF32 (FFT) made a
    # student step at batch 12, 512x1024 6.5x slower than the autotuned one
    # (PERF.md)
    torch.backends.cudnn.benchmark = True

    from ..core.config import (cityscapes_student_config,
                               cityscapes_teacher_config)
    from ..data import BDD, CamVid, Cityscapes, DataSetting
    from ..train import TrainSession, run_train, write_test_predictions
    from ..utils.logging import get_logger

    if args.dataset == "proccity":
        from ..data.procgen import make_dataset_cls
        dataset_cls = make_dataset_cls()
    else:
        dataset_cls = {"cityscapes": Cityscapes, "bdd": BDD,
                       "camvid": CamVid}[args.dataset]

    cfg = (cityscapes_teacher_config() if args.mode == "teacher"
           else cityscapes_student_config())
    data = cfg.data
    if args.data_root:
        data = dataclasses.replace(data, dataset_path=args.data_root)
    if args.dataset != "cityscapes":
        data = dataclasses.replace(
            data, num_classes=dataset_cls.num_classes,
            ignore_label=dataset_cls.ignore_label)
    if args.dataset == "proccity":
        data = dataclasses.replace(data, train_source="train.txt",
                                   eval_source="val.txt",
                                   test_source="val.txt")
    if args.synthetic:
        data = dataclasses.replace(data, synthetic=True)
    if args.batch_size:
        data = dataclasses.replace(data, batch_size=args.batch_size)
    if args.height:
        data = dataclasses.replace(data, image_height=args.height)
    if args.width:
        data = dataclasses.replace(data, image_width=args.width)
    cfg = dataclasses.replace(cfg, data=data, is_eval=args.is_eval,
                              is_test=args.is_test)

    logger = get_logger(log_file=os.path.join(save_dir, "log.txt")
                        if mesh is None or mesh.rank == 0 else None)
    logger.info("config: %s", cfg)
    if mesh is not None:
        logger.info("%s", mesh)

    setting = val_dataset = None
    if args.data_root:
        setting = DataSetting(
            img_root=data.dataset_path, gt_root=data.dataset_path,
            train_source=os.path.join(data.dataset_path, data.train_source),
            eval_source=os.path.join(data.dataset_path, data.eval_source),
            test_source=os.path.join(data.dataset_path, data.test_source),
            down_sampling=data.down_sampling)
        val_dataset = dataset_cls(setting, "val")

    if args.is_test:
        session = TrainSession(cfg, args.arch_dir, device=args.device)
        if args.eval_ckpt:
            session.load_weights(args.eval_ckpt)
        write_test_predictions(session, dataset_cls(setting, "test"),
                               os.path.join(save_dir, "test"),
                               remap=getattr(dataset_cls,
                                             "train_id_to_label_id", None))
        logger.info("submission PNGs in %s/test", save_dir)
        return session

    return run_train(cfg, args.arch_dir, val_dataset=val_dataset,
                     epochs=args.epochs, niters=args.niters,
                     save_dir=save_dir, teacher_ckpt=args.teacher_ckpt,
                     resume=bool(args.resume), dataset_cls=dataset_cls,
                     device=args.device, mesh=mesh)


if __name__ == "__main__":
    main()
