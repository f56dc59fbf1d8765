"""Latency lookup table: a persistent op-latency store.

Copy of the JAX package's latency/lut.py (numpy-free, torch-free), the
counterpart of the reference's `latency_lookup_table.npy`
(latency/latency_lookup_table.py, search/operations.py:33-36,115-123): the
same key scheme, JSON persistence, and measure-on-miss through an optional
provider (latency/measure.py `measured_provider` on the card); without one a
miss raises `KeyError`. Two tables ship beside this module: the reference's
own (1080Ti, TensorRT; `reference_lut()`, the search's default) and the one
measured on an H100 through the port's kernels (`h100_lut()`).

Key formats (reference parity):
  {Op}_H{h}_W{w}_Cin{cin}_Cout{cout}_stride{s}_dilation{d}
  ConvNorm_H{h}_W{w}_Cin{cin}_Cout{cout}_kernel{k}_stride{s}
  FactorizedReduce_H{h}_W{w}_Cin{cin}_Cout{cout}_stride{s}
  ff_H{h}_W{w}_C{c}
  head_H{h}_W{w}_Cin{cin}_Cout{cout}
"""

from __future__ import annotations

import json
import os
import warnings
from typing import Callable, Dict, Optional, Tuple

OP_LUT_NAMES = (
    "FactorizedReduce",
    "BasicResidual1x",
    "BasicResidual_downup_1x",
    "BasicResidual2x",
    "BasicResidual2x",  # downup_2x reuses the 2x key — reference quirk we
                        # keep for LUT compatibility (operations.py:426-431)
)

OP_TRUE_NAMES = (
    "FactorizedReduce",
    "BasicResidual1x",
    "BasicResidual_downup_1x",
    "BasicResidual2x",
    "BasicResidual_downup_2x",
)


def op_key(op_idx: int, h: int, w: int, c_in: int, c_out: int,
           stride: int, dilation: int = 1, true_name: bool = False) -> str:
    """`true_name=False` keeps the reference quirk of pricing downup_2x
    under the BasicResidual2x key (operations.py:426-431), which resolves
    the reference's tables. Measured tables store op 4 under its true key,
    so the zoomed double conv gets its own timing; `LatencyLUT.get_op`
    tries the true key first and falls back to the alias."""
    name = (OP_TRUE_NAMES if true_name else OP_LUT_NAMES)[op_idx]
    if op_idx == 0:
        return f"{name}_H{h}_W{w}_Cin{c_in}_Cout{c_out}_stride{stride}"
    return (f"{name}_H{h}_W{w}_Cin{c_in}_Cout{c_out}"
            f"_stride{stride}_dilation{dilation}")


def convnorm_key(h, w, c_in, c_out, kernel, stride) -> str:
    return f"ConvNorm_H{h}_W{w}_Cin{c_in}_Cout{c_out}_kernel{kernel}_stride{stride}"


def ffm_key(h, w, c) -> str:
    return f"ff_H{h}_W{w}_C{c}"


def head_key(h, w, c_in, c_out) -> str:
    return f"head_H{h}_W{w}_Cin{c_in}_Cout{c_out}"


# how far a plan's width may lie from a calibrated family before
# `factor_for` warns
FAMILY_TOLERANCE = 0.1


class LatencyLUT:
    """name -> milliseconds, JSON-backed, measure-on-miss."""

    def __init__(self, path: Optional[str] = None,
                 provider: Optional[Callable[[str], float]] = None,
                 alias_op4: bool = False):
        self.path = path
        self.table: Dict[str, float] = {}
        self.provider = provider
        # reference-import mode: price downup_2x under the BasicResidual2x
        # key even though true-name entries exist, replicating the
        # reference's lookup quirk (operations.py:426-431) so walks over
        # imported tables reproduce its stored latencies bit-for-bit
        self.alias_op4 = alias_op4
        # end-to-end correction of the per-op sum (a whole compiled network
        # is faster than the sum of its ops timed alone), stored in the
        # table file under a reserved key; derived_latency_ms applies it.
        # The reference's table carries none (1.0).
        self.fusion_factor = 1.0
        if path and os.path.isfile(path):
            with open(path) as f:
                self.table = json.load(f)
        self.fusion_factor = float(self.table.pop("__fusion_factor__", 1.0))
        # per-width-family factors, keyed by the network's stem/head width
        # multiplier ("1.0" teacher family, "0.667" student family)
        self.fusion_factors = {
            float(k): float(v) for k, v in
            self.table.pop("__fusion_factor_by_width__", {}).items()}

    def factor_for(self, width: float) -> float:
        """Fusion factor for a plan whose stem/head width multiplier is
        `width`; nearest family match, else the scalar default. The snap is
        unbounded, as in the JAX package; a width more than
        FAMILY_TOLERANCE from every calibrated family warns."""
        if self.fusion_factors:
            key = min(self.fusion_factors, key=lambda k: abs(k - width))
            if abs(key - width) > FAMILY_TOLERANCE:
                warnings.warn(
                    f"width {width:.4f} lies {abs(key - width):.4f} from the "
                    f"nearest calibrated family {key}; its fusion factor "
                    f"{self.fusion_factors[key]} is an extrapolation",
                    stacklevel=2)
            return self.fusion_factors[key]
        return self.fusion_factor

    def save(self, path: Optional[str] = None):
        path = path or self.path
        if path:
            out = dict(self.table)
            if self.fusion_factor != 1.0:
                out["__fusion_factor__"] = self.fusion_factor
            if self.fusion_factors:
                out["__fusion_factor_by_width__"] = {
                    repr(k): v for k, v in self.fusion_factors.items()}
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(out, f, indent=0, sort_keys=True)
            os.replace(tmp, path)

    def __contains__(self, name: str) -> bool:
        return name in self.table

    def __len__(self):
        return len(self.table)

    def get(self, name: str) -> float:
        """Latency in ms; on miss, consult the provider and persist
        (reference operations.py:115-123 measure-on-miss)."""
        if name in self.table:
            return self.table[name]
        if self.provider is None:
            raise KeyError(f"latency LUT miss with no provider: {name}")
        ms = float(self.provider(name))
        self.table[name] = ms
        self.save()
        return ms

    def update(self, entries: Dict[str, float]):
        self.table.update(entries)

    def get_op(self, op_idx: int, h: int, w: int, c_in: int, c_out: int,
               stride: int, dilation: int = 1) -> float:
        """Op latency: true-name key first (measured tables), then the
        reference alias (the reference's tables), then measure-on-miss under
        the true key."""
        true = op_key(op_idx, h, w, c_in, c_out, stride, dilation,
                      true_name=True)
        if true in self.table and not (self.alias_op4 and op_idx == 4):
            return self.table[true]
        alias = op_key(op_idx, h, w, c_in, c_out, stride, dilation)
        # the alias (op 4 priced as op 3's BasicResidual2x key) is only an
        # acceptable answer when there is no way to measure the true key:
        # with a provider attached, falling back here would never measure
        # downup_2x (the alias key exists once op 3 is measured)
        use_alias = self.provider is None or (self.alias_op4 and op_idx == 4)
        if use_alias and alias in self.table:
            return self.table[alias]
        return self.get(true)

    @staticmethod
    def from_reference_npy(npy_path: str) -> "LatencyLUT":
        """Load a reference latency_lookup_table.npy (GPU-measured)."""
        import numpy as np
        lut = LatencyLUT(alias_op4=True)
        lut.table = {k: float(v) for k, v in
                     np.load(npy_path, allow_pickle=True).item().items()}
        return lut


def parse_key(name: str) -> Tuple[str, dict]:
    """Inverse of the key builders — used by measurement providers."""
    parts = name.split("_")
    fields = {}
    op_parts = []
    for p in parts:
        for prefix in ("H", "W", "Cin", "Cout", "kernel", "stride",
                       "dilation", "C"):
            if p.startswith(prefix) and p[len(prefix):].isdigit():
                fields[prefix] = int(p[len(prefix):])
                break
        else:
            op_parts.append(p)
    return "_".join(op_parts), fields


REFERENCE_LUT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "reference_lut.json")


def reference_lut() -> LatencyLUT:
    """The paper's own table (1080Ti, TensorRT; 667 entries) with the
    reference's op-4 alias: the search's default. It holds every key the
    supernet tables and both stems need at 1024x2048."""
    return LatencyLUT(REFERENCE_LUT, alias_op4=True)


H100_LUT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "h100_lut.json")


def h100_lut(provider: Optional[Callable[[str], float]] = None
             ) -> LatencyLUT:
    """The table measured on an NVIDIA H100 through the port's serving route
    (`cli/latency_lut.py`, calibrated by `cli/calibrate_latency.py`; the
    card's name and power limit are in `h100_lut_calibration.json`). It
    holds every key the supernet tables, both stems and the shipped
    genotypes' walks need at 1024x2048. Read-only: misses that `provider`
    measures stay in memory."""
    lut = LatencyLUT(H100_LUT, provider=provider)
    lut.path = None
    return lut
