"""The rank side of tests/test_torch_spatial.py, and ranks as threads of one
process (`on_threads`, also used by tests/test_torch_cuda.py).

Spawned ranks import this module, which imports torch and the port only:
they never import JAX or tests/conftest.py. Each case function takes a
`parallel.Mesh` (a rank of an image split over H) or None (one process on
whole images), so the test runs the same function for both and compares.
"""

import threading

import numpy as np
import torch

from fasterseg_tpu_torch.kernels import conv3x3_bn_relu_plain
from fasterseg_tpu_torch.parallel import SPATIAL_AXIS, make_mesh, spatial
from fasterseg_tpu_torch.parallel.spatial import Block, Exchange, partition

STUDENT_HW = (256, 128)          # 4 blocks of the student's 64 rows
TOY_CLASSES = 5
TOY_MEAN, TOY_STD = (0.5, 0.5, 0.5), (0.25, 0.25, 0.25)
MULTI_SCALES = (0.75, 1.0, 1.25)
EVAL_ITEMS = 2


# ---- ranks as threads of one process (no process group) ----


class ThreadMesh:
    """Rank `rank` of `world` threads: `all_reduce_` sums every thread's
    tensor in rank order, as a process group's would."""
    backend = "gloo"

    def __init__(self, shared, rank: int, world: int):
        self.shared, self.rank, self.world = shared, rank, world

    def all_reduce_(self, t):
        bufs, barrier = self.shared
        bufs[self.rank] = t.clone()
        barrier.wait()
        total = bufs[0].clone()
        for b in bufs[1:]:
            total += b
        barrier.wait()
        return t.copy_(total)


def on_threads(world: int, fn):
    """[fn(Exchange of rank r) for r in range(world)], the ranks on
    threads."""
    shared = ([None] * world, threading.Barrier(world, timeout=60))
    out, errors = [None] * world, []

    def run(r):
        try:
            out[r] = fn(Exchange(ThreadMesh(shared, r, world)))
        except BaseException as e:     # noqa: BLE001 (re-raised below)
            errors.append(e)
            shared[1].abort()

    threads = [threading.Thread(target=run, args=(r,)) for r in range(world)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return out


# ---- ranks in processes ----


def rank_job(mesh, payload) -> dict:
    """Every case on this rank (two torch threads), on the spatial mesh of
    the process group."""
    torch.set_num_threads(2)
    mesh = make_mesh(mesh.world, axis_names=(SPATIAL_AXIS,))
    out = {"logits": student_logits(mesh, payload),
           "toy": toy_eval(mesh, payload["toy_w"])}
    if payload.get("student_eval"):
        out["student_eval"] = student_eval(mesh, payload)
    return out


def runner(payload):
    """The fp32 kernel-path runner of the student whose state_dict (the
    JAX package's draw, converted) the payload holds."""
    from fasterseg_tpu_torch.models import (DerivedNet, InferenceRunner,
                                            student_plan)
    from fasterseg_tpu_torch.utils import load_reference_state_dict
    plan = student_plan()
    net = DerivedNet(plan)
    load_reference_state_dict(net, payload["state"])
    return InferenceRunner(plan, net.eval(), dtype=torch.float32,
                           device="cpu")


def student_logits(mesh, payload) -> dict:
    """This rank's block of the student's logits of the payload's image,
    the largest distance of its rows from the same rank's unsplit forward,
    and the exchanges it made."""
    r = runner(payload)
    x = payload["x"]
    part = partition(x.shape[1], mesh.world, r.row_multiple)
    lo, hi = part.block(mesh.rank)
    ex = Exchange(mesh)
    got = r.logits(Block(x[:, lo:hi].contiguous(), part, ex))
    assert got.part == part and got.t.shape[1] == hi - lo
    whole = r.logits(x)
    return {"block": got.t, "rows": (lo, hi), "bounds": part.bounds,
            "vs_unsplit": (got.t - whole[:, lo:hi]).abs().max().item(),
            "exchanges": ex.exchanges, "bytes": ex.bytes}


class ToyConv:
    """One 3x3 SAME conv without bias: the forward of the JAX package's
    spatial evaluator tests (tests/test_parallel.py), on images or on a
    Block of them (its halo rows exchanged)."""
    row_multiple = 1

    def __init__(self, w: np.ndarray):
        self.w = torch.from_numpy(w)
        co = self.w.shape[-1]
        self.scale, self.bias = torch.ones(co), torch.zeros(co)

    def __call__(self, x):
        if isinstance(x, Block):
            return spatial.conv3x3_bn_relu(x, self.w, self.scale, self.bias,
                                           relu=False)
        return conv3x3_bn_relu_plain(x, self.w, self.scale, self.bias,
                                     relu=False)


def toy_datasets():
    """The JAX spatial tests' datasets: (name, dataset, scales)."""
    from fasterseg_tpu_torch.data.datasets import SyntheticDataset
    return [("single_flip", SyntheticDataset(length=3, hw=(64, 32),
                                             num_classes=TOY_CLASSES,
                                             seed=11), (1.0,)),
            ("multi_flip", SyntheticDataset(length=10, hw=(64, 32),
                                            num_classes=TOY_CLASSES, seed=9),
             MULTI_SCALES)]


def toy_eval(mesh, ws: dict) -> dict:
    """The toy conv's evaluation with the flip TTA, at single scale and at
    MULTI_SCALES (ws: the conv's weights for each), each image split over
    the mesh's ranks (None: whole)."""
    from fasterseg_tpu_torch.eval import Evaluator
    out = {}
    for name, ds, scales in toy_datasets():
        res = Evaluator(ds, TOY_CLASSES, TOY_MEAN, TOY_STD, ToyConv(ws[name]),
                        eval_scales=scales, eval_flip=True, device="cpu",
                        mesh=mesh, spatial=mesh is not None).run()
        out[name] = {"hist": res.hist, "pixel_acc": res.pixel_acc,
                     "mean_iu": res.mean_iu}
    return out


def student_eval(mesh, payload) -> dict:
    """The student's evaluation through the runner with the flip TTA, at
    single scale and at MULTI_SCALES, over EVAL_ITEMS synthetic images at
    STUDENT_HW; each image split over the mesh's ranks (None: whole); the
    exchanges of a spatial run."""
    from fasterseg_tpu_torch.data.datasets import SyntheticDataset
    from fasterseg_tpu_torch.eval import Evaluator
    r = runner(payload)
    ds = SyntheticDataset(length=EVAL_ITEMS, hw=STUDENT_HW, seed=5)
    out = {}
    for name, scales in (("single_flip", (1.0,)),
                         ("multi_flip", MULTI_SCALES)):
        ev = Evaluator(ds, 19, TOY_MEAN, TOY_STD, r.logits,
                       eval_scales=scales, eval_flip=True, device="cpu",
                       mesh=mesh, spatial=mesh is not None)
        res = ev.run()
        out[name] = {"hist": res.hist,
                     "exchanges": 0 if mesh is None else ev.exchange.exchanges}
    return out
