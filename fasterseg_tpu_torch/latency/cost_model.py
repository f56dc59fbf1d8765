"""Analytical latency model of the NVIDIA H100 (a roofline) for LUT keys.

Counterpart of the JAX package's `TpuCostModel` (latency/cost_model.py),
with the same structure (`conv_ms`, `resize_ms`, `op_ms`, `provider`) and the
H100's constants. Its numbers are ESTIMATES, not measurements: a standalone
op costs max(FLOPs / peak rate, bytes / memory rate) plus a fixed launch
overhead, with the tensor cores' rate scaled down where the channels are
narrower than one tile of the conv kernel. The measured table
(`cli/latency_lut.py`, `latency/h100_lut.json`) replaces it key for key.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple, Union

import torch

from .lut import parse_key


@dataclasses.dataclass
class H100CostModel:
    """Estimated ms of LUT keys on one H100. Constructed with the TPU
    model's constants (peak 90 TFLOP/s, 180 GB/s, 15 us, 128 channels) it
    computes exactly what `TpuCostModel` does."""
    peak_tflops: float = 989.0      # dense bf16 tensor cores (data sheet)
    hbm_gbps: float = 3350.0        # HBM3 (data sheet)
    overhead_us: float = 5.0        # a launch in a CUDA graph plus a tile's
                                    # fill and epilogue (a one-tile conv
                                    # replays in ~7 us)
    bytes_per_elem: int = 2         # bf16 activations
    full_rate_channels: int = 64    # the conv kernel's tile: 64 input
                                    # channels a chunk, 64 outputs a block

    def conv_terms(self, h: int, w: int, c_in: int, c_out: int, k: int,
                   stride: int) -> Tuple[float, float]:
        """(compute seconds, memory seconds) of one conv."""
        ho, wo = h // stride, w // stride
        # channels narrower than a tile leave the tensor cores partly idle
        eff_in = min(c_in / self.full_rate_channels, 1.0)
        eff_out = min(c_out / self.full_rate_channels, 1.0)
        eff = max(eff_in * eff_out, 0.02)
        flops = 2.0 * ho * wo * k * k * c_in * c_out
        t_compute = flops / (self.peak_tflops * 1e12 * eff)
        bytes_ = (h * w * c_in + ho * wo * c_out) * self.bytes_per_elem \
            + k * k * c_in * c_out * self.bytes_per_elem
        return t_compute, bytes_ / (self.hbm_gbps * 1e9)

    def conv_ms(self, h: int, w: int, c_in: int, c_out: int, k: int,
                stride: int, n_convs: int = 1) -> float:
        """One conv (+BN+ReLU fused): compute and memory roofline."""
        t_compute, t_mem = self.conv_terms(h, w, c_in, c_out, k, stride)
        return ((max(t_compute, t_mem) + self.overhead_us * 1e-6) * 1e3
                * n_convs)

    def resize_ms(self, h: int, w: int, c: int, out_h: int,
                  out_w: int) -> float:
        bytes_ = (h * w + out_h * out_w) * c * self.bytes_per_elem
        return (bytes_ / (self.hbm_gbps * 1e9)
                + self.overhead_us * 1e-6) * 1e3

    def op_ms(self, op_idx: int, h: int, w: int, c_in: int, c_out: int,
              stride: int) -> float:
        """A searchable primitive, structured as ops/primitives.py."""
        if op_idx == 0:  # FactorizedReduce
            if stride == 1:
                return self.conv_ms(h, w, c_in, c_out, 1, 1)
            return 2 * self.conv_ms(h, w, c_in, c_out // 2, 1, 2)
        if op_idx == 1:  # conv
            return self.conv_ms(h, w, c_in, c_out, 3, stride)
        if op_idx == 2:  # zoomed conv: /2, conv, (x2 back)
            t = self.resize_ms(h, w, c_in, h // 2, w // 2)
            t += self.conv_ms(h // 2, w // 2, c_in, c_out, 3, 1)
            if stride == 1:
                t += self.resize_ms(h // 2, w // 2, c_out, h, w)
            return t
        if op_idx == 3:  # conv_2x
            return (self.conv_ms(h, w, c_in, c_out, 3, stride)
                    + self.conv_ms(h // stride, w // stride, c_out, c_out, 3,
                                   1))
        if op_idx == 4:  # zoomed conv_2x
            t = self.resize_ms(h, w, c_in, h // 2, w // 2)
            t += self.conv_ms(h // 2, w // 2, c_in, c_out, 3, 1)
            t += self.conv_ms(h // 2, w // 2, c_out, c_out, 3, 1)
            if stride == 1:
                t += self.resize_ms(h // 2, w // 2, c_out, h, w)
            return t
        raise ValueError(op_idx)

    def provider(self, name: str) -> float:
        """LUT provider: the estimate of a parsed key."""
        op, f = parse_key(name)
        if op == "ConvNorm":
            return self.conv_ms(f["H"], f["W"], f["Cin"], f["Cout"],
                                f.get("kernel", 3), f.get("stride", 1))
        if op == "ff":
            return self.conv_ms(f["H"], f["W"], f["C"], f["C"], 1, 1)
        if op == "head":
            c_in = f["Cin"]
            mid = c_in if c_in <= 256 else c_in // 2
            return (self.conv_ms(f["H"], f["W"], c_in, mid, 3, 1)
                    + self.conv_ms(f["H"], f["W"], mid, f["Cout"], 1, 1))
        names = {"FactorizedReduce": 0, "BasicResidual1x": 1,
                 "BasicResidual_downup_1x": 2, "BasicResidual2x": 3,
                 "BasicResidual_downup_2x": 4}
        if op in names:
            return self.op_ms(names[op], f["H"], f["W"], f["Cin"],
                              f["Cout"], f.get("stride", 1))
        raise KeyError(f"cannot model key: {name}")

    @classmethod
    def calibrate(cls, sample_shape: Tuple[int, int, int, int] = (
            256, 512, 64, 64), device: Union[str, torch.device] = "cuda"
                  ) -> "H100CostModel":
        """A model whose `peak_tflops` makes `conv_ms` equal one
        `graph_slope_ms` reading of the port's 3x3 conv kernel (bf16,
        weights packed once) at `sample_shape` = (H, W, Cin, Cout),
        stride 1.

        Nothing is swallowed (the JAX version returns its defaults on any
        error): a failed build, launch or measurement raises, and so does a
        reading that the memory roofline alone cannot explain."""
        from ..kernels.conv import conv3x3_bn_relu, split_weights
        from ..kernels import resolve_device
        from .measure import graph_slope_ms
        device = resolve_device(device)
        model = cls()
        h, w, ci, co = sample_shape
        g = torch.Generator().manual_seed(0)
        x = torch.randn((1, h, w, ci), generator=g).bfloat16().to(device)
        wt = torch.randn((3, 3, ci, co), generator=g) \
            * (2.0 / (9 * ci)) ** 0.5
        cw = split_weights(wt).to(device)
        scale = torch.ones(co, device=device)
        bias = torch.zeros(co, device=device)
        with torch.inference_mode():
            measured, _, _ = graph_slope_ms(
                lambda: conv3x3_bn_relu(x, cw, scale, bias), device=device)
        compute_s = measured * 1e-3 - model.overhead_us * 1e-6
        t_compute, t_mem = model.conv_terms(h, w, ci, co, 3, 1)
        if compute_s <= t_mem:
            raise RuntimeError(
                f"conv reading {measured:.5f} ms is within the memory "
                f"roofline plus overhead "
                f"({t_mem * 1e3 + model.overhead_us * 1e-3:.5f} ms): it "
                f"cannot fit peak_tflops")
        model.peak_tflops *= t_compute / compute_s
        return model
