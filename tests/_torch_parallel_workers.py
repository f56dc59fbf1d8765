"""The rank side of tests/test_torch_parallel.py.

Spawned ranks import this module, which imports torch and the port only:
they never import JAX or tests/conftest.py. Each case function takes a
`parallel.Mesh` (a rank's view of its shard of the global batch) or None
(the one process on the whole batch), so the test runs the same function
for both and compares.
"""

import numpy as np
import torch

from fasterseg_tpu_torch.parallel import dryrun, shard_batch, sync_batchnorm_

BN_SHAPE = (4, 6, 5, 8)              # global N, H, W, C
LOGIT_SHAPE = (4, 6, 8, 19)          # 96 pixels a rank at two ranks
EVAL_SCENES = 5                      # odd: the last global batch is padded
EVAL_HW = (128, 256)
SHARED_CLASSES = 8
SHARED_HW = (48, 96)
MEAN, STD = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)


def rank_job(mesh, jax_train_payload) -> dict:
    """Every case on this rank, at two torch threads a rank."""
    torch.set_num_threads(2)
    return {"bn": bn_case(mesh), "losses": loss_case(mesh),
            "loader": loader_case(mesh), "steps": dryrun.run_steps(mesh),
            "eval": eval_case(mesh), "shared_eval": shared_eval_case(mesh),
            "jax_train": train_from_payload(mesh, jax_train_payload)}


# ---- (a) sync BN ----


def bn_inputs():
    """float64 activations whose channels have means up to ~4 and standard
    deviations down to 0.01, and a random cotangent."""
    rng = np.random.default_rng(10)
    c = BN_SHAPE[-1]
    x = (rng.standard_normal(BN_SHAPE) * rng.uniform(0.01, 3.0, c)
         + rng.normal(0.0, 2.0, c))
    return (torch.from_numpy(x),
            torch.from_numpy(rng.standard_normal(BN_SHAPE)))


def bn_case(mesh) -> dict:
    """Train-mode forward and backward of a plain BN and of a slim BN's
    row 1 (its last two channels zero, as a masked width leaves them) from
    seeded non-trivial parameters and statistics; the parameter gradients
    summed over ranks."""
    from fasterseg_tpu_torch.ops.conv import BatchNorm
    from fasterseg_tpu_torch.ops.slimmable import SlimBatchNorm
    x, cot = shard_batch(bn_inputs(), mesh)
    c = BN_SHAPE[-1]
    g = torch.Generator().manual_seed(3)
    out = {}
    for kind in ("plain", "slim"):
        bn = (BatchNorm(c) if kind == "plain"
              else SlimBatchNorm(c, num_widths=3)).double()
        with torch.no_grad():
            for t in (bn.weight, bn.bias, bn.running_mean):
                t.copy_(torch.rand(t.shape, generator=g, dtype=t.dtype) + 0.5)
            bn.running_var.copy_(torch.rand(bn.running_var.shape,
                                            generator=g, dtype=torch.float64)
                                 + 0.5)
        sync_batchnorm_(bn, mesh).train()
        xin = x.clone()
        if kind == "slim":
            xin[..., -2:] = 0.0
        xin.requires_grad_(True)
        y = bn(xin) if kind == "plain" else bn(xin, torch.tensor(1))
        (y * cot).sum().backward()
        grads = [bn.weight.grad, bn.bias.grad]
        if mesh is not None:
            mesh.reduce_grads_(grads)
        out[kind] = {"y": y.detach(), "x_grad": xin.grad,
                     "weight_grad": grads[0], "bias_grad": grads[1],
                     "running_mean": bn.running_mean.clone(),
                     "running_var": bn.running_var.clone()}
    return out


# ---- (b) global-batch losses ----


def loss_inputs():
    """float64 logits, labels whose image i ignores a share 0.05 + 0.2 i of
    its pixels (so the ranks' valid and kept counts differ), teacher logits
    and a soft target."""
    rng = np.random.default_rng(11)
    n, h, w, c = LOGIT_SHAPE
    logits = rng.standard_normal(LOGIT_SHAPE) * 2.0
    labels = rng.integers(0, c, (n, h, w))
    for i in range(n):
        labels[i][rng.random((h, w)) < 0.05 + 0.2 * i] = 255
    teacher = rng.standard_normal(LOGIT_SHAPE) * 2.0
    soft = rng.random(LOGIT_SHAPE)
    soft /= soft.sum(-1, keepdims=True)
    return tuple(torch.from_numpy(a) for a in (logits, labels, teacher, soft))


def loss_case(mesh) -> dict:
    """Each loss's value (this rank's share) and its gradient on this rank's
    logits, and OHEM's threshold. min_kept 100 and n_min 100 exceed a
    rank's 96 pixels, so the global k-th value needs both ranks' heads; the
    100th smallest p_true lies among the ~125 valid pixels."""
    from fasterseg_tpu_torch.train import loss as L
    logits, labels, teacher, soft = shard_batch(loss_inputs(), mesh)
    cw = torch.tensor(L.CITYSCAPES_CLASS_WEIGHTS, dtype=torch.float64)
    cases = {
        "ohem": lambda z: L.ohem_cross_entropy(z, labels, 255, 0.02, 100,
                                               mesh=mesh),
        "ohem_weighted": lambda z: L.ohem_cross_entropy(
            z, labels, 255, 0.7, 40, class_weight=cw, mesh=mesh),
        "topk": lambda z: L.ohem_ce_topk(z, labels, 100, 0.7, mesh=mesh),
        "topk_thresh": lambda z: L.ohem_ce_topk(z, labels, 4, 0.7,
                                                mesh=mesh),
        "ce": lambda z: L.cross_entropy(z, labels, class_weight=cw,
                                        mesh=mesh),
        "focal": lambda z: L.focal_loss(z, labels, mesh=mesh),
        "kl": lambda z: L.kl_distillation(z, teacher, mesh=mesh),
        "soft": lambda z: L.soft_cross_entropy(z, soft, mesh=mesh),
    }
    out = {}
    for name, fn in cases.items():
        z = logits.clone().requires_grad_(True)
        value = fn(z)
        value.backward()
        out[name] = {"value": value.detach(), "grad": z.grad}
    valid = labels != 255
    p_true = torch.gather(torch.softmax(logits, -1), -1,
                          torch.where(valid, labels, 0)[..., None])[..., 0]
    out["threshold"] = L.ohem_threshold(torch.where(valid, p_true, 1.0),
                                        0.02, 100, mesh)
    return out


# ---- (f) the loader's shards ----


def loader_case(mesh) -> list:
    """Batches (epoch 1, steps 0 and 1) of a global batch of 4, 32x64
    crops of ProcCity scenes: this rank's rows."""
    from fasterseg_tpu_torch.data import TrainLoader, TrainPre
    from fasterseg_tpu_torch.data.procgen import ProcCity
    shard = (0, 1) if mesh is None else (mesh.rank, mesh.world)
    loader = TrainLoader(ProcCity(length=6, hw=(48, 96), seed=2,
                                  split="train"),
                         TrainPre(MEAN, STD, (32, 64)), 4, seed=5,
                         shard=shard)
    try:
        return [loader.make_batch(1, step) for step in (0, 1)]
    finally:
        loader.close()


# ---- (e) the evaluator over the tiny student ----


def eval_case(mesh) -> dict:
    """`Evaluator.run` over 5 ProcCity scenes with the tiny decoded student
    (the JAX draw, seed 0): through an fp32 `InferenceRunner` (batch 1, the
    conv wrapper's) at single scale and multi-scale (0.75, 1, 1.25) + flip,
    and through the plain net at batch 2, the last batch padded."""
    from fasterseg_tpu_torch.data.procgen import ProcCity
    from fasterseg_tpu_torch.eval import Evaluator
    from fasterseg_tpu_torch.models import DerivedNet, InferenceRunner
    from fasterseg_tpu_torch.utils.weights import init_jax_draw_
    plan = dryrun.distill_plans()[0]
    net = init_jax_draw_(DerivedNet(plan), 0).eval()
    runner = InferenceRunner(plan, net, dtype=torch.float32, device="cpu")
    ds = ProcCity(length=EVAL_SCENES, hw=EVAL_HW, seed=4, split="val")
    out = {}
    for name, fwd, kw in (
            ("single", runner.logits, {}),
            ("single_batch2", net, {"batch_size": 2}),
            ("multi_flip", runner.logits, {"eval_scales": (0.75, 1.0, 1.25),
                                           "eval_flip": True})):
        res = Evaluator(ds, 19, MEAN, STD, fwd, device="cpu", mesh=mesh,
                        **kw).run()
        out[name] = {"hist": res.hist, "pixel_acc": res.pixel_acc,
                     "mean_iu": res.mean_iu}
    return out


# ---- against the JAX package ----


class SharedForward:
    """logits = x @ M + bias(H, W), term by term (numpy constants): the
    forward of tests/test_torch_eval.py's shared protocol tests, whose JAX
    form the test builds from the same constants."""

    def __init__(self, num_classes: int = SHARED_CLASSES, seed: int = 0):
        rng = np.random.default_rng(seed)
        self.m = (rng.standard_normal((3, num_classes)) * 3).astype(
            np.float32)
        self.c, self.seed = num_classes, seed

    def bias(self, h: int, w: int) -> np.ndarray:
        rng = np.random.default_rng((self.seed, h, w))
        return (rng.standard_normal((h, w, self.c)) * 2).astype(np.float32)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        m = torch.from_numpy(self.m)
        out = x[..., 0:1] * m[0] + x[..., 1:2] * m[1] + x[..., 2:3] * m[2]
        return out + torch.from_numpy(self.bias(x.shape[1], x.shape[2]))


def shared_dataset():
    from fasterseg_tpu_torch.data.procgen import ProcCity
    return ProcCity(length=EVAL_SCENES, hw=SHARED_HW, seed=3, split="val")


def shared_eval_case(mesh) -> dict:
    """The shared forward's evaluation: single scale + flip, and
    multi-scale (0.5, 1, 1.5) + flip."""
    from fasterseg_tpu_torch.eval import Evaluator
    out = {}
    for name, scales in (("single_flip", (1.0,)),
                         ("multi_flip", (0.5, 1.0, 1.5))):
        res = Evaluator(shared_dataset(), SHARED_CLASSES, MEAN, STD,
                        SharedForward(), eval_scales=scales, eval_flip=True,
                        device="cpu", mesh=mesh).run()
        out[name] = {"hist": res.hist, "pixel_acc": res.pixel_acc,
                     "mean_iu": res.mean_iu}
    return out


def train_from_payload(mesh, payload) -> dict:
    """One fp32 distill `train_step` of the nets in `payload` (the JAX
    package's init as state_dicts) on this rank's shard of its batch;
    returns the state and the metrics."""
    from fasterseg_tpu_torch.models import DerivedNet
    from fasterseg_tpu_torch.train import TrainState, make_optimizer, train_step
    from fasterseg_tpu_torch.utils.weights import load_reference_state_dict
    nets = []
    for plan, sd in ((payload["plan"], payload["student"]),
                     (payload["plan"], payload["teacher"])):
        net = DerivedNet(plan)
        load_reference_state_dict(net, sd)
        nets.append(net)
    student, teacher = nets
    teacher.eval().requires_grad_(False)
    state = TrainState(student, make_optimizer(student.parameters(),
                                               **payload["opt"]))
    x, y = shard_batch((payload["x"], payload["y"]), mesh)
    m = train_step(state, x, y, teacher, mesh=mesh, **payload["step"])
    return {"state": {k: v.clone() for k, v in student.state_dict().items()},
            "metrics": {k: v.clone() for k, v in m.items()}}
