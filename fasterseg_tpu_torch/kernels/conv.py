"""3x3 conv + folded BN (+ReLU): wrapper of csrc/conv3x3_bn_relu.cu.

Counterpart of the JAX package's pallas/conv.py (`conv3x3_bn_relu_planar`
and `conv3x3s2_bn_relu_s2d`). The port keeps NHWC activations and HWIO
weights, the JAX package's public layouts; the planar, lane-padded and
space-to-depth layouts of the Pallas kernels are not reproduced.

Routes (csrc/conv3x3_bn_relu.cu, `_plan`), by dtype and channel count:

* channel counts that are multiples of 16: the tensor-core kernel, bf16
  activations in bf16 (route 2), fp32 activations as 3xTF32 (route 3: each
  operand split into tf32 hi + lo, three products, fp32-level accuracy);
* Ci = 3 at stride 2 with Co in {32, 48, 64} (the stem entry): the stem
  kernel, either dtype (route 1);
* any other channel count, either dtype: the CUDA-core kernel (route 0).

The tensor-core kernel takes its weights split into hi + lo and packed in
the layout of its B operand (`split_weights`: bf16 halves for bf16
activations, tf32 halves in fp32 words for fp32 ones), prepared once where
the weights are folded.

Halo mode (`halo=(top, bottom)`): the input is one block of an image split
over H (parallel/spatial.py) with `top` rows of the block above and `bottom`
rows of the block below around it (0 or 1 each); the conv reads them where
it would zero-pad, and returns the block's own output rows.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from ..ops.conv import fold_bn  # noqa: F401  (pallas/conv.py:38 counterpart)
from . import build

# launches of the CUDA kernel, by stride (the Pallas originals are two
# kernels: the planar stride-1 one and the space-to-depth stride-2 one), of
# those the launches in halo mode, and the same launches by route
launches = {1: 0, 2: 0}
halo_launches = {1: 0, 2: 0}
ROUTES = {0: "cuda_cores", 1: "stem", 2: "wgmma_bf16", 3: "wgmma_tf32x3"}
route_launches = {r: 0 for r in ROUTES}

_DTYPES = (torch.float32, torch.bfloat16)
_SIZE = {torch.float32: 4, torch.bfloat16: 2}   # bytes of an element
_MAX_GRID_Y = 65535     # the CUDA-core kernels: one block row per output row
# split-K tile counters kept per device, zero between launches; launches
# that split K must not overlap on two streams of one device
_COUNTERS = 4096
_fns = None
_plans: Dict[tuple, Tuple[int, ...]] = {}
_counters: Dict[torch.device, torch.Tensor] = {}


@dataclass(frozen=True)
class ConvWeights:
    """A 3x3 conv's weights as the kernels take them.

    w: (3, 3, Ci, Co) HWIO float32, Ci the sum of `ci_parts`.
    packed: (n blocks, chunks, 9 taps, 2, bn, ck) in the activations' dtype
    (`dtype`): for each block of `bn` output channels, chunk of `ck` input
    channels (each part of `ci_parts` padded to whole chunks) and tap, the
    hi and lo slabs [output channel][input channel], their 16-byte pieces
    swizzled as the tensor cores read them from shared memory. bfloat16:
    hi = bf16(w), lo = bf16(w - hi); float32: hi = tf32(w), lo = tf32(w -
    hi) (`round_tf32`), for the 3xTF32 route."""
    w: torch.Tensor
    packed: torch.Tensor
    ci_parts: Tuple[int, ...]
    ck: int
    bn: int

    @property
    def dtype(self) -> torch.dtype:
        """The activation dtype the packing serves."""
        return self.packed.dtype

    def to(self, device) -> "ConvWeights":
        return ConvWeights(self.w.to(device).contiguous(),
                           self.packed.to(device).contiguous(),
                           self.ci_parts, self.ck, self.bn)


def _tile(ci_parts: Sequence[int], co: int,
          dtype: torch.dtype) -> Tuple[int, int]:
    """(ck, bn): input channels per chunk (128 bytes a pixel where every
    part fills whole chunks of that, else 64) and output channels per
    block."""
    wide = 128 // _SIZE[dtype]
    ck = wide if all(c % wide == 0 for c in ci_parts) else wide // 2
    return ck, (32 if co <= 32 else 64)


def _swizzle_index(bn: int, ck: int, size: int = 2) -> torch.Tensor:
    """For row n (ck elements of `size` bytes, in pieces of 16 bytes) the
    piece that lands in slot j: the 128-byte or 64-byte shared-memory
    swizzle (by the row's bytes), byte address bits [4, 7) ^= bits [7, 10)
    (masked to the row width). An involution, so it also undoes itself."""
    row = ck * size
    n = torch.arange(bn)[:, None]
    j = torch.arange(row // 16)[None, :]
    off = n * row + j * 16
    mask = 7 if row == 128 else 3
    return (((off ^ (((off >> 7) & mask) << 4)) - n * row) // 16)


def input_parts(ci1: int, ci2: int = 0) -> Tuple[int, ...]:
    """The inputs' channel counts as the kernel reads them, which
    `split_weights` packs for: a second input (ci2 > 0) is read in place
    where both counts are multiples of 16, else the wrapper concatenates
    the two and the kernel reads one input of ci1 + ci2."""
    if not ci2:
        return (ci1,)
    return (ci1, ci2) if ci1 % 16 == 0 and ci2 % 16 == 0 else (ci1 + ci2,)


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (10 mantissa bits, ties away from
    zero), as float32: PTX's cvt.rna.tf32.f32, which the fp32 route applies
    to its activations."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split_weights(w: torch.Tensor,
                  ci_parts: Optional[Sequence[int]] = None,
                  dtype: torch.dtype = torch.bfloat16) -> ConvWeights:
    """HWIO float32 weights -> `ConvWeights` packed for the tensor-core
    kernel with activations of `dtype`: bfloat16, hi = bf16(w), lo =
    bf16(w - hi) (hi + lo keeps ~16 mantissa bits of w); float32, hi =
    tf32(w), lo = tf32(w - hi) (~22 bits, the 3xTF32 route).
    `ci_parts` are the channel counts of the inputs the conv is applied to
    (a concat read from several tensors); default one input."""
    if w.ndim != 4 or tuple(w.shape[:2]) != (3, 3) or w.dtype != torch.float32:
        raise ValueError(f"w must be (3, 3, Ci, Co) float32, got "
                         f"{tuple(w.shape)} {w.dtype}")
    if dtype not in _DTYPES:
        raise ValueError(f"dtype must be one of {_DTYPES}, got {dtype}")
    ci, co = w.shape[2], w.shape[3]
    ci_parts = (ci,) if ci_parts is None else tuple(int(c) for c in ci_parts)
    if sum(ci_parts) != ci or any(c <= 0 for c in ci_parts):
        raise ValueError(f"ci_parts {ci_parts} do not add up to Ci = {ci}")
    ck, bn = _tile(ci_parts, co, dtype)
    if dtype == torch.bfloat16:
        hi = w.bfloat16()
        lo = (w - hi.float()).bfloat16()
    else:
        hi = round_tf32(w)
        lo = round_tf32(w - hi)
    both = torch.stack([hi, lo], dim=0).reshape(2, 9, ci, co)
    # pad every part to whole chunks and the output channels to whole blocks
    parts, start = [], 0
    for c in ci_parts:
        parts.append(F.pad(both[:, :, start:start + c],
                           (0, -co % bn, 0, -c % ck)))
        start += c
    both = torch.cat(parts, dim=2)                   # (2, 9, chunks*ck, nb*bn)
    nch, nb = both.shape[2] // ck, both.shape[3] // bn
    both = both.reshape(2, 9, nch, ck, nb, bn).permute(4, 2, 1, 0, 5, 3)
    per = 16 // _SIZE[dtype]                         # elements a 16-byte piece
    pieces = both.reshape(nb, nch, 9, 2, bn, ck // per, per)
    idx = _swizzle_index(bn, ck, _SIZE[dtype]).to(w.device)
    packed = pieces[..., torch.arange(bn, device=w.device)[:, None], idx, :]
    return ConvWeights(w.contiguous(),
                       packed.reshape(nb, nch, 9, 2, bn, ck).contiguous(),
                       ci_parts, ck, bn)


def unpack_weights(cw: ConvWeights) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) as (3, 3, Ci, Co) float32 from `cw.packed`: the inverse of
    the packing in `split_weights`."""
    nb, nch, _, _, bn, ck = cw.packed.shape
    per = 16 // _SIZE[cw.dtype]
    pieces = cw.packed.reshape(nb, nch, 9, 2, bn, ck // per, per)
    idx = _swizzle_index(bn, ck, _SIZE[cw.dtype]).to(cw.packed.device)
    rows = torch.arange(bn, device=cw.packed.device)[:, None]
    both = pieces[..., rows, idx, :].reshape(nb, nch, 9, 2, bn, ck)
    both = both.permute(3, 2, 1, 5, 0, 4).reshape(2, 9, nch * ck, nb * bn)
    co = cw.w.shape[3]
    parts, start = [], 0
    for c in cw.ci_parts:
        parts.append(both[:, :, start:start + c, :co])
        start += -(-c // ck) * ck
    both = torch.cat(parts, dim=2).float()
    return (both[0].reshape(3, 3, -1, co), both[1].reshape(3, 3, -1, co))


def _kernel():
    global _fns
    if _fns is None:
        lib = build.load("conv3x3_bn_relu")
        run, plan = lib.conv3x3_bn_relu, lib.conv3x3_bn_relu_plan
        run.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 12 + [
            ctypes.c_void_p]
        run.restype = ctypes.c_int
        plan.argtypes = [ctypes.c_int] * 11 + [ctypes.POINTER(ctypes.c_int)]
        plan.restype = ctypes.c_int
        _fns = (run, plan)
    return _fns


def _plan(key: tuple) -> Tuple[int, ...]:
    """(route, scratch floats, counters) of the conv `key` = (H, W, ci1,
    ci2, co, stride, is_bf16, ck, bn, top, bottom), H with the halo rows,
    from the library's own tile choice; `ROUTES` names the route."""
    got = _plans.get(key)
    if got is None:
        out = (ctypes.c_int * 3)()
        rc = _kernel()[1](*key, out)
        if rc != 0:
            raise RuntimeError(f"conv3x3_bn_relu: no kernel for {key}")
        got = _plans[key] = tuple(out)
    return got


def _check(x, w, scale, bias, stride, x2, halo):
    if x.dtype not in _DTYPES:
        raise TypeError(f"x must be one of {_DTYPES}, got {x.dtype}")
    if any(t.dtype != torch.float32 for t in (w, scale, bias)):
        raise TypeError("w, scale and bias must be float32")
    if x.ndim != 4 or x.shape[0] != 1:
        raise ValueError(f"x must be (1, H, W, Ci), got {tuple(x.shape)}")
    ci = x.shape[3]
    if x2 is not None:
        if x2.dtype != x.dtype:
            raise TypeError(f"x2 must have x's dtype {x.dtype}, got {x2.dtype}")
        if x2.ndim != 4 or tuple(x2.shape[:3]) != tuple(x.shape[:3]):
            raise ValueError(f"x2 must be (1, {x.shape[1]}, {x.shape[2]}, "
                             f"Ci2), got {tuple(x2.shape)}")
        ci += x2.shape[3]
    if w.ndim != 4 or tuple(w.shape[:3]) != (3, 3, ci):
        raise ValueError(f"w must be (3, 3, {ci}, Co), got {tuple(w.shape)}")
    co = w.shape[3]
    if tuple(scale.shape) != (co,) or tuple(bias.shape) != (co,):
        raise ValueError(f"scale and bias must be ({co},)")
    if stride not in (1, 2):
        raise ValueError(f"stride must be 1 or 2, got {stride}")
    top, bottom = halo
    if top not in (0, 1) or bottom not in (0, 1) or x.shape[1] - top - bottom < 1:
        raise ValueError(f"halo {tuple(halo)}: top and bottom are 0 or 1 rows "
                         f"around at least one row of x's {x.shape[1]}")
    devices = {t.device for t in (x, w, scale, bias)}
    if x2 is not None:
        devices.add(x2.device)
    if len(devices) != 1:
        raise ValueError(f"tensors lie on several devices: {devices}")


def conv3x3_bn_relu_plain(x, w, scale, bias, stride: int = 1,
                          relu: bool = True, x2=None,
                          halo: Tuple[int, int] = (0, 0)) -> torch.Tensor:
    """Plain version (same math): fp32 conv of the given values, fp32
    epilogue, rounded once to x's dtype. NHWC in and out. With `x2` the
    conv runs over the channel concat of x and x2. With `halo` (top,
    bottom) the first `top` and last `bottom` rows of x (and x2) are a
    neighbouring block's: H is zero-padded only on a side without one,
    then the conv is valid in H and same in W."""
    if isinstance(w, ConvWeights):
        w = w.w
    xin = x if x2 is None else torch.cat([x, x2], dim=-1)
    xin = xin.permute(0, 3, 1, 2).float()
    wf = w.permute(3, 2, 0, 1).float()
    top, bottom = halo
    if top or bottom:
        y = F.conv2d(F.pad(xin, (0, 0, 1 - top, 1 - bottom)), wf,
                     stride=stride, padding=(0, 1))
    else:
        y = F.conv2d(xin, wf, stride=stride, padding=1)
    y = y.permute(0, 2, 3, 1) * scale + bias
    if relu:
        y = torch.relu(y)
    return y.to(x.dtype).contiguous()


def conv3x3_bn_relu(x, w: Union[torch.Tensor, ConvWeights], scale, bias,
                    stride: int = 1, relu: bool = True,
                    x2: Optional[torch.Tensor] = None,
                    halo: Tuple[int, int] = (0, 0)) -> torch.Tensor:
    """x: (1, H, W, Ci) NHWC, float32 or bfloat16; w: (3, 3, Ci, Co) HWIO
    float32, or the `ConvWeights` that `split_weights` made of it;
    scale/bias: (Co,) float32 folded BN. Returns (1, Ho, Wo, Co) in x's
    dtype, pad 1, accumulated in fp32 and rounded once.

    With `x2` (1, H, W, Ci2), same dtype and device, the conv runs over the
    channel concat [x, x2] (w has Ci + Ci2 input channels) at stride 1. The
    tensor-core kernel reads the two tensors in place where both channel
    counts are multiples of 16; for any other count the wrapper
    concatenates them first.

    A CUDA tensor runs a kernel (module docstring): channel counts that are
    multiples of 16 on the tensor cores, bfloat16 as bf16 and float32 as
    3xTF32; the Ci = 3 stem entry on the stem kernel; any other count on
    CUDA cores. A CPU tensor runs the plain version. Raw float32 `w` is
    split and packed on every call; pass the `ConvWeights` of
    `split_weights(w, input_parts(ci, ci2), x.dtype)` to do that once.
    `ConvWeights` packed for another dtype or other inputs raise.

    `halo` = (top, bottom), each 0 or 1: x (and x2) is a block of rows of a
    taller image with that many of its neighbours' rows above and below it
    (module docstring); the output has the block's (h - 1) // stride + 1
    rows, h = H - top - bottom."""
    cw = w if isinstance(w, ConvWeights) else None
    if cw is not None:
        w = cw.w
    top, bottom = halo = (int(halo[0]), int(halo[1]))
    _check(x, w, scale, bias, stride, x2, halo)
    if cw is not None:
        parts = input_parts(x.shape[3], 0 if x2 is None else x2.shape[3])
        if cw.dtype != x.dtype or cw.ci_parts != parts:
            raise ValueError(f"weights packed for {cw.dtype} inputs of "
                             f"{cw.ci_parts} channels, given {x.dtype} of "
                             f"{parts}")
    if x2 is not None and stride != 1:
        raise ValueError("a second input is taken at stride 1 only")
    if x.device.type == "cpu":
        return conv3x3_bn_relu_plain(x, w, scale, bias, stride, relu, x2,
                                     halo)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    bf16 = x.dtype == torch.bfloat16
    if x2 is not None and not (x.shape[3] % 16 == 0 and x2.shape[3] % 16 == 0):
        x, x2 = torch.cat([x, x2], dim=-1), None
    _, H, W, ci1 = x.shape
    ci2 = 0 if x2 is None else x2.shape[3]
    parts = (ci1,) if x2 is None else (ci1, ci2)
    tensor_cores = all(c % 16 == 0 for c in parts)
    if tensor_cores and cw is None:
        cw = split_weights(w, parts, x.dtype)
    tensors = [("x", x), ("w", w), ("scale", scale), ("bias", bias)]
    if x2 is not None:
        tensors.append(("x2", x2))
    if tensor_cores:
        tensors.append(("packed weights", cw.packed))
    for name, t in tensors:
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    co = w.shape[3]
    ck, bn = (cw.ck, cw.bn) if tensor_cores else (0, 0)
    ho, wo = (H - top - bottom - 1) // stride + 1, (W - 1) // stride + 1
    route, n_scratch, n_counters = _plan(
        (H, W, ci1, ci2, co, stride, int(bf16), ck, bn, top, bottom))
    if route in (0, 1) and ho > _MAX_GRID_Y:
        raise ValueError(f"output height {ho} exceeds the CUDA-core kernels' "
                         f"grid limit of {_MAX_GRID_Y} rows")
    scratch = counters = None
    if n_scratch:
        if n_counters > _COUNTERS:
            raise ValueError(f"{n_counters} split-K tiles exceed the "
                             f"{_COUNTERS} counters kept per device")
        scratch = torch.empty(n_scratch, dtype=torch.float32, device=x.device)
        counters = _counters.get(x.device)
        if counters is None:
            if torch.cuda.is_current_stream_capturing():
                raise RuntimeError("the split-K counters are allocated at the "
                                   "first launch: run once before capturing")
            counters = _counters[x.device] = torch.zeros(
                _COUNTERS, dtype=torch.int32, device=x.device)
    y = torch.empty((1, ho, wo, co), dtype=x.dtype, device=x.device)
    ptr = lambda t: None if t is None else t.data_ptr()
    # the launch goes to the current device: make it x's
    with torch.cuda.device(x.device):
        rc = _kernel()[0](
            x.data_ptr(), ptr(x2), w.data_ptr(),
            cw.packed.data_ptr() if tensor_cores else None, scale.data_ptr(),
            bias.data_ptr(), y.data_ptr(), ptr(scratch), ptr(counters), H, W,
            ci1, ci2, co, stride, int(relu), int(bf16), ck, bn, top, bottom,
            torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"conv3x3_bn_relu launch failed: CUDA error {rc}")
    launches[stride] += 1
    route_launches[route] += 1
    if top or bottom:
        halo_launches[stride] += 1
    return y
