"""What the cell modules share: the run's context, the configuration's
family module, what a run hands to the metric readers, the program's network
built from a FasterSeg configuration file, and the clock and synchronisation
of the run's device.

A family module, `gpubench/families/<family>.py` in the checkout (the
configuration file's `"family"`, `fasterseg` where it names none), holds
what depends on the architecture:

- `plan(config)`: the reference's plan of the network;
- `weights(plan, seed, device)`: seeded parameters made on the device;
- `reference_logits(plan, weights, x, precision=None)`: fp32 full-resolution
  logits (N, classes, H, W) of an NCHW fp32 image, plain and importing
  nothing of the port; `precision` other than None is the traffic's control;
- `program(config, weights, device, dtype)`: the port's entry point, an
  object with `.classmap(x)` and `.logits(x)` of NHWC images (the only place
  a family imports the port);
- `costs(plan, hw, elem_bytes)`: a unit's cost terms at input `hw`, at least
  `COST_FIELDS`; a reader of a further term reads `Outcome.costs`.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import os
import re
import sys
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

DEFAULT_FAMILY = "fasterseg"
COST_FIELDS = ("flops_per_unit", "conv_bound_s", "convs3x3",
               "upsample_bound_s", "upsamples")


def load_file(path: str, module_name: str):
    """The module of the Python file at `path`, loaded by path."""
    spec = importlib.util.spec_from_file_location(module_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def family_name(config: Dict) -> str:
    return config.get("family", DEFAULT_FAMILY)


def load_family(root: str, name: str):
    """The family module `gpubench/families/<name>.py` of the checkout."""
    path = os.path.join(root, "gpubench", "families", f"{name}.py")
    if not re.fullmatch(r"[A-Za-z0-9_][A-Za-z0-9_.-]*", name) or (
            not os.path.isfile(path)):
        raise SystemExit(f"gpubench: no module for the family {name!r} "
                         f"(gpubench/families/{name}.py)")
    return load_file(path, "gpubench_family_" + re.sub(r"\W", "_", name))


@dataclasses.dataclass
class Ctx:
    root: str
    workload: Dict
    config: Dict
    traffic: Dict
    check: Dict                # the traffic's control and limits
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t_start: float
    control: bool = False    # judge the reference in lower precision instead
    family: Optional[object] = None   # the configuration's family module
    plan: Optional[object] = None     # the family's plan of the network

    def __post_init__(self):
        self.family = load_family(self.root, family_name(self.config))
        self.plan = self.family.plan(self.config)

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def log(self, msg: str) -> None:
        print(f"[gpubench {time.perf_counter() - self.t_start:7.2f}s] {msg}",
              file=sys.stderr, flush=True)

    def rng(self, *keys: int) -> np.random.Generator:
        return np.random.default_rng((self.seed,) + keys)

    def generator(self, key: int) -> torch.Generator:
        g = torch.Generator(device=self.device)
        g.manual_seed((self.seed * 1_000_003 + key) % 2 ** 63)
        return g


@dataclasses.dataclass
class Outcome:
    """What a cell's run measured: the window (host clock), the traced
    sub-window, the work's size and the comparison with the reference."""

    setup_s: float
    window_s: float
    units: int                      # frames, steps or images completed
    items: int                      # images (frames) in them
    unit_s: List[float]             # host seconds of each unit
    attempted: int
    failed: int
    memory_peak_bytes: int
    checks: Dict[str, float]        # numbers compared, by name
    readings: Dict[str, float] = dataclasses.field(default_factory=dict)
    spans: Dict[str, List[float]] = dataclasses.field(default_factory=dict)
    trace: Optional[object] = None  # trace.Trace of the traced sub-window
    flops_per_unit: float = 0.0     # FLOPs of one unit (forward convs)
    conv_bound_s: Optional[float] = None   # least time of a unit's 3x3 convs
    convs3x3: int = 0                      # 3x3 convs a unit launches
    upsample_bound_s: Optional[float] = None
    upsamples: int = 0
    costs: Dict[str, float] = dataclasses.field(default_factory=dict)
    device_type: str = "cuda"


def cost_fields(costs: Dict[str, float]) -> Dict:
    """`Outcome` keywords of a family's cost terms: the named fields, and
    every term under `costs`."""
    return dict({k: costs[k] for k in COST_FIELDS if k in costs},
                costs=dict(costs))


def program_plan(config: Dict):
    """FasterSeg: the port's plan of the configuration's network, decoded
    by the port from the architecture logits the file holds; it must decode
    to the genotypes the file states."""
    from fasterseg_tpu_torch.core.genotype import ArchParams, decode_network
    from fasterseg_tpu_torch.core.plan import build_plan as port_build_plan
    a = {k: np.asarray(v, np.float32) for k, v in config["arch"].items()}
    arch = ArchParams(alphas=[a["alpha0"], a["alpha1"], a["alpha2"]],
                      betas=[None, a["beta1"], a["beta2"]],
                      ratios=[a["ratio0"], a["ratio1"], a["ratio2"]])
    genos = decode_network(arch, config["width_mult_list"], config["layers"],
                           ignore_skip=config["ignore_skip"])
    check_genotypes(config, {k: genos[k] for k in config["lasts"]})
    return port_build_plan(genos, config["lasts"], Fch=config["Fch"],
                           num_classes=config["num_classes"],
                           stem_head_width=tuple(config["stem_head_width"]))


def check_genotypes(config: Dict, genos: Dict) -> None:
    for last in config["lasts"]:
        want = config["genotypes"][str(last)]
        got = genos[last]
        got = {"ops": list(got.ops), "path": list(got.path),
               "downs": list(got.downs), "widths": list(got.widths)}
        if got != want:
            raise RuntimeError(f"the port decodes branch {last} as {got}, "
                               f"the configuration states {want}")


def program_net(config: Dict, weights: Dict[str, torch.Tensor], device):
    """FasterSeg: (plan, DerivedNet) of the port with the benchmark's
    weights."""
    from fasterseg_tpu_torch.models import DerivedNet
    plan = program_plan(config)
    net = DerivedNet(plan).to(device)
    net.load_state_dict(weights, strict=True)
    return plan, net


def sample_frames(images: int, height: int, width: int, g: torch.Generator,
                  device, ignore_share: float = 0.0, classes: int = 19
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Seeded uint8 images (N, H, W, 3) and labels (N, H, W) uint8: classes
    drawn uniformly, `ignore_share` of the pixels 255."""
    x = torch.randint(0, 256, (images, height, width, 3), generator=g,
                      device=device, dtype=torch.uint8)
    y = torch.randint(0, classes, (images, height, width), generator=g,
                      device=device, dtype=torch.uint8)
    if ignore_share > 0:
        drop = torch.rand((images, height, width), generator=g,
                          device=device) < ignore_share
        y = torch.where(drop, torch.full_like(y, 255), y)
    return x, y


def normalised(x_u8: torch.Tensor, config: Dict) -> torch.Tensor:
    """uint8 NHWC -> normalised fp32 NHWC."""
    m = torch.tensor(config["image_mean"], device=x_u8.device)
    s = torch.tensor(config["image_std"], device=x_u8.device)
    return (x_u8.float() / 255.0 - m) / s


def window(ctx: Ctx, unit, on_unit=None):
    """Run `unit(i)` (which returns when its work is complete) until
    `ctx.seconds` have passed; returns (seconds, units, per-unit seconds).
    `on_unit(i, result)` runs after a unit's clock has stopped."""
    times: List[float] = []
    t0 = time.perf_counter()
    i = 0
    while True:
        a = time.perf_counter()
        out = unit(i)
        b = time.perf_counter()
        times.append(b - a)
        if on_unit is not None:
            on_unit(i, out)
        i += 1
        if b - t0 >= ctx.seconds:
            return b - t0, i, times


def free(device) -> None:
    import gc
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def memory_peak(device) -> int:
    return (int(torch.cuda.max_memory_allocated(device))
            if device.type == "cuda" else 0)
