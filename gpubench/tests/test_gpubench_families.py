"""A configuration of another architecture family is added with new files
and appended entries alone: a toy family, written into a tiny checkout, runs
the `stream` and `eval` kinds on the CPU and comes out correct; with its
program's logits perturbed it comes out not correct (the check holds the
program to the family's reference, not to itself); the `train` kind refuses
it by name. The FasterSeg family gives the weights and cost terms the
harness gave before the seam (pinned below)."""

import hashlib
import json
import os

import pytest

from gpubench import harness

from .rehearse import REPO, run_cell, tiny_root

TOY_FAMILY = '''"""A toy family: a 3x3 stride-2 conv with ReLU, a 1x1
classifier, a half-pixel bilinear x2 to full resolution."""

import torch
import torch.nn.functional as F

PERTURB = {perturb}


def plan(config):
    return {{"classes": config["num_classes"], "width": config["width"]}}


def weights(plan, seed, device):
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    w, c = plan["width"], plan["classes"]
    return {{"conv": torch.randn(w, 3, 3, 3, generator=g, device=device)
                    * (2 / 27) ** 0.5,
            "bias": 0.1 * torch.randn(w, generator=g, device=device),
            "cls": torch.randn(c, w, 1, 1, generator=g, device=device)
                   * (2 / w) ** 0.5}}


def _fp8(t):
    s = 448.0 / t.abs().max().clamp_min(1e-12)
    return (t * s).to(torch.float8_e4m3fn).float() / s


def reference_logits(plan, weights, x, precision=None):
    if precision not in (None, "fp8"):
        raise ValueError(precision)
    q = _fp8 if precision == "fp8" else (lambda t: t)
    with torch.no_grad():
        h = F.relu(F.conv2d(q(x), q(weights["conv"]), weights["bias"],
                            stride=2, padding=1))
        y = F.conv2d(q(h), q(weights["cls"]))
        return F.interpolate(y, size=x.shape[-2:], mode="bilinear",
                             align_corners=False)


class Program:
    """NHWC in, NHWC logits out, convs in `dtype`."""

    def __init__(self, weights, device, dtype):
        self.w = {{k: v.to(device, dtype) for k, v in weights.items()}}
        self.dtype = dtype

    @torch.inference_mode()
    def logits(self, x):
        t = x.to(self.dtype).permute(0, 3, 1, 2)
        h = F.relu(F.conv2d(t, self.w["conv"], self.w["bias"], stride=2,
                            padding=1))
        y = F.interpolate(F.conv2d(h, self.w["cls"]).float(),
                          size=tuple(x.shape[1:3]), mode="bilinear",
                          align_corners=False).permute(0, 2, 3, 1)
        if PERTURB:
            y = y.clone()
            y[:, :4, :, 0] += PERTURB * y.std()
        return y

    def classmap(self, x):
        return self.logits(x).argmax(-1)


def program(config, weights, device, dtype):
    return Program(weights, device, dtype)


def costs(plan, hw, elem_bytes):
    h, w = hw[0] // 2, hw[1] // 2
    flops = 2 * h * w * plan["width"] * (27 + plan["classes"])
    return {{"flops_per_unit": flops,
            "conv_bound_s": None, "convs3x3": 0,
            "upsample_bound_s": None, "upsamples": 0,
            "toy_bytes": float(elem_bytes * hw[0] * hw[1] * 3)}}
'''

TOY_READER = '''"""The toy family's own cost term, read from `Outcome.costs`."""


def read(out):
    return out.costs.get("toy_bytes", 0.0) / 1e6
'''

TOY_CELLS = {"toy-stream": "graph-stream-1024x2048",
             "toy-eval": "eval-single-scale-1024x2048",
             "toy-train": "train-b12-512x1024"}
E2E = {"toy-stream": "fps", "toy-eval": "eval_images_per_s"}


def _toy_root(dst, perturb=0.0):
    """A tiny checkout with the toy family added: new files, and entries
    appended to BENCHMARK.json's lists."""
    root = tiny_root(str(dst))
    gb = os.path.join(root, "gpubench")
    with open(os.path.join(gb, "families", "toy.py"), "w") as f:
        f.write(TOY_FAMILY.format(perturb=perturb))
    with open(os.path.join(gb, "metrics", "toy_mbytes.stream.py"), "w") as f:
        f.write(TOY_READER)
    with open(os.path.join(REPO, "gpubench", "configs",
                           "fasterseg-student.json")) as f:
        student = json.load(f)
    toy = {"name": "toy", "family": "toy", "num_classes": 19, "width": 8,
           "ignore_label": 255, "image_mean": student["image_mean"],
           "image_std": student["image_std"]}
    with open(os.path.join(gb, "configs", "toy.json"), "w") as f:
        json.dump(toy, f)
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as f:
        bench = json.load(f)
    bench["configs"].append({
        "name": "toy", "source": "https://example.org/toy",
        "file": "gpubench/configs/toy.json", "reduced": [],
        "why": "a toy network of another family"})
    for cell, traffic in TOY_CELLS.items():
        bench["workloads"].append({"name": cell, "config": "toy",
                                   "traffic": traffic, "chips": 1,
                                   "why": "the toy family"})
    for m in bench["end_to_end"]:
        for cell, name in E2E.items():
            if m["name"] == name:
                m["workloads"].append(cell)
    bench["per_layer"].append({
        "name": "toy_mbytes.stream", "unit": "MB", "better": "lower",
        "source": "program_counter", "layer": "kernels", "moves": "fps",
        "workloads": ["toy-stream"]})
    with open(path, "w") as f:
        json.dump(bench, f)
    return root


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    return _toy_root(tmp_path_factory.mktemp("toy"))


@pytest.fixture(scope="module")
def toy_perturbed(tmp_path_factory):
    return _toy_root(tmp_path_factory.mktemp("toy_perturbed"), perturb=3.0)


@pytest.mark.parametrize("cell", sorted(E2E))
def test_toy_family_is_correct(toy, cell):
    code, last, _ = run_cell(toy, cell, seed=2 ** 31 + 7)
    assert code == 0
    assert last["correct"] is True and last["failed"] == 0
    assert set(last["metrics"]) == {E2E[cell], "setup_s"}
    assert all(c["value"] is not None for c in last["check"].values())


def test_a_further_cost_term_reaches_its_reader(toy):
    code, last, _ = run_cell(toy, "toy-stream", trace=1)
    assert code == 0 and last["correct"] is True
    # the tiny traffic's 64x128 frames in bf16: 2 * 64 * 128 * 3 bytes
    assert last["metrics"]["toy_mbytes.stream"]["value"] == 64 * 128 * 6 / 1e6


@pytest.mark.parametrize("cell", sorted(E2E))
def test_perturbed_program_is_not_correct(toy_perturbed, cell):
    code, last, _ = run_cell(toy_perturbed, cell)
    assert code == 0
    assert last["correct"] is False


def test_train_refuses_another_family_by_name(toy):
    with pytest.raises(SystemExit, match="'toy'"):
        run_cell(toy, "toy-train")


def test_an_unknown_family_is_refused(tmp_path):
    root = _toy_root(tmp_path)
    path = os.path.join(root, "gpubench", "configs", "toy.json")
    with open(path) as f:
        c = json.load(f)
    c["family"] = "absent"
    with open(path, "w") as f:
        json.dump(c, f)
    with pytest.raises(SystemExit, match="'absent'"):
        run_cell(root, "toy-stream")


# ---- the FasterSeg family gives what the harness gave before the seam ----

def _fasterseg(name):
    fam = harness.load_family(REPO, "fasterseg")
    with open(os.path.join(REPO, "gpubench", "configs", f"{name}.json")) as f:
        config = json.load(f)
    assert harness.family_name(config) == "fasterseg"
    return fam, fam.plan(config)


# sha256 over each parameter's name and bytes, in order, of the CPU draw
WEIGHTS = {
    ("fasterseg-student", 5):
        "9e5d166b64182c9547d8241618b02bae799b258d32201bdd0a6aebb907e07e60",
    ("fasterseg-student", 2 ** 31 + 12345):
        "109b6139e3f316974f83a09c41fbbdd21311b7fd6cc77cbcd886fe769aab51df",
    ("fasterseg-teacher", 5):
        "69ca70b06a554ebb9841e5af5d78bd17dda858a05c9d766487a31d4f901743d9",
    ("fasterseg-teacher", 2 ** 31 + 12345):
        "3f0098f17c01e4c17b3c5282c551eb101b31daf7a93e6f707fe011174c9bce5e",
}


@pytest.mark.parametrize("name,seed", sorted(WEIGHTS))
def test_fasterseg_weights_pinned(name, seed):
    fam, plan = _fasterseg(name)
    h = hashlib.sha256()
    for k, v in fam.weights(plan, seed, "cpu").items():
        h.update(k.encode())
        h.update(v.contiguous().numpy().tobytes())
    assert h.hexdigest() == WEIGHTS[(name, seed)]


# (flops_per_unit, conv_bound_s, convs3x3, upsample_bound_s)
COSTS = {
    ("fasterseg-student", (1024, 2048), 2): (
        55540973568, 8.735020638027255e-05, 40, 2.875758805970149e-06),
    ("fasterseg-student", (1024, 2048), 4): (
        55540973568, 0.00015619146707972776, 40, 3.2474555223880597e-06),
    ("fasterseg-student", (512, 1024), 2): (
        13885243392, 2.2708205621840244e-05, 40, 7.189397014925373e-07),
    ("fasterseg-teacher", (1024, 2048), 2): (
        215557865472, 0.00024727421312430766, 62, 2.875758805970149e-06),
    ("fasterseg-teacher", (1024, 2048), 4): (
        215557865472, 0.0003152428923261549, 62, 3.2474555223880597e-06),
    ("fasterseg-teacher", (512, 1024), 4): (
        53889466368, 9.338865436940676e-05, 62, 8.118638805970149e-07),
}


@pytest.mark.parametrize("name,hw,elem", sorted(COSTS))
def test_fasterseg_costs_pinned(name, hw, elem):
    fam, plan = _fasterseg(name)
    got = fam.costs(plan, hw, elem)
    assert (got["flops_per_unit"], got["conv_bound_s"], got["convs3x3"],
            got["upsample_bound_s"]) == COSTS[(name, hw, elem)]
    assert got["upsamples"] == 1
    fields = harness.cost_fields(got)
    assert fields["costs"] == got
    assert {k: fields[k] for k in harness.COST_FIELDS} == got
