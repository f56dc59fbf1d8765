import os

import numpy as np

from ..core import WIDTH_MULT_LIST, ArchParams, build_plan, decode_network
from ..core.plan import NetworkPlan, select_lasts
from .derived import DerivedNet, Stem
from .infer import InferenceRunner, fast_stem

_ASSETS = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "tests", "assets")


def _shipped_plan(name: str, ignore_skip: bool, shw, assets_dir: str = None,
                  arch_npz: str = None) -> NetworkPlan:
    if arch_npz is None:
        arch_npz = os.path.join(assets_dir or _ASSETS, name)
    d = np.load(arch_npz)
    genos = decode_network(ArchParams.from_npz(arch_npz), WIDTH_MULT_LIST,
                           layers=16, ignore_skip=ignore_skip)
    lasts = select_lasts(float(d["mIoU02"]), float(d["latency02"]),
                         float(d["mIoU12"]), float(d["latency12"]))
    return build_plan(genos, lasts, Fch=12, num_classes=19,
                      stem_head_width=shw)


def student_plan(assets_dir: str = None, arch_npz: str = None) -> NetworkPlan:
    """Decode the shipped student genotype (arch_1) into a NetworkPlan with
    the student width list / stem-head width (config_train.py:95-104),
    selecting branches by the stored search-time objective."""
    return _shipped_plan("arch_1.npz", False, (8.0 / 12, 8.0 / 12),
                         assets_dir, arch_npz)


def teacher_plan(assets_dir: str = None, arch_npz: str = None) -> NetworkPlan:
    """Decode the shipped teacher genotype (arch_0, ignore_skip=True)."""
    return _shipped_plan("arch_0.npz", True, (1.0, 1.0), assets_dir, arch_npz)
