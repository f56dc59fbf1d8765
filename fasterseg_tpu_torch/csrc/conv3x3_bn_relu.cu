// 3x3, pad-1 convolution + folded eval BatchNorm + optional ReLU, NHWC.
//
// Replaces two Pallas kernels of the JAX package:
//   fasterseg_tpu/pallas/conv.py:110 conv3x3_bn_relu_planar (pallas_call at :148)
//     stride 1 (and 2) over the channel-planar (H, C_pad16, W_pad128) layout;
//   fasterseg_tpu/pallas/conv.py:290 conv3x3s2_bn_relu_s2d (pallas_call at :336)
//     stride 2 written as a 2x2-tap stencil over space-to-depth input.
// Both compute y = relu?(conv3x3(x, w) * scale + bias). The planar layout, its
// 16-sublane / 128-lane padding and the space-to-depth packing exist only for
// Mosaic's tiling; they are not reproduced here. The kernels read NHWC
// activations as they are and take the stride as a template parameter.
//
// What bounds it on the H100 (NVIDIA H100 SXM: 132 SMs, 3.35 TB/s of HBM,
// 989 TFLOP/s of dense bf16 and 495 of TF32 on the tensor cores, 67 TFLOP/s
// of fp32 on the CUDA cores, 227 KB of shared memory a block). Three regimes:
//   * large maps with few channels (the stem: 256x512 64->64 moves 33.6 MB,
//     10 us of HBM traffic, for 9.7 GFLOP, 10 us of tensor-core time; twice
//     that with the hi + lo weight split below). Bytes and operations bound
//     it about equally; what it needs is a fed pipeline: weights fetched
//     once per SM, every input pixel staged once, copies overlapping
//     products.
//   * small maps with many channels (32x64 and 16x32, 128..384 channels):
//     a few GFLOP over 16..32 pixel tiles. Operations bound it, and the
//     card is empty unless the work is cut finer than one block per tile.
//   * the stem entry (Ci = 3, stride 2, 1024x2048): 46 MB in bf16 (92 MB in
//     fp32) for 0.9 GFLOP, bound by bytes; 27 FMAs per output value fit the
//     CUDA cores.
// In fp32 (every evaluation to mIoU) the same convs do the same operations,
// which the CUDA cores' 67 TFLOP/s cannot carry (256x512 64->64: 0.144 ms at
// the least); the tensor cores can, at fp32 accuracy, by splitting operands.
//
// What the design does. Three kernels behind one entry point, four routes
// (the number `conv3x3_bn_relu_plan` returns):
//   * conv3x3_wgmma_kernel<bf16> (route 2): bf16 activations whose channel
//     counts are multiples of 16. An implicit GEMM on wgmma (m64nNk16, bf16
//     in, fp32 accumulators in registers). A block is one producer warp and one or two
//     consumer warpgroups and walks over work items (persistent: the grid is
//     at most one block per SM). A work item is a tile of 4 or 8 output
//     rows x 16 output columns, a block of 32 or 64 output channels, and a
//     range of the K steps (K = channel chunks x 9 taps).
//       - Input: one TMA tiled load per channel chunk brings the tile's halo
//         patch ((rows-1)*S+3) x ((16-1)*S+3) pixels x 32 or 64 channels
//         into a ring in shared memory, completion on an mbarrier. Signed
//         start coordinates and out-of-bounds zero fill give the padding.
//         All nine taps are shifted views of that patch: each consumer warp
//         reads its A fragments with ldmatrix from per-lane pixel addresses
//         (so stride 2 and any shift work) and wgmma takes A from registers.
//         Every input pixel is staged once per chunk, not once per tap.
//       - Weights arrive pre-split (hi = bf16(w), lo = bf16(w - hi)) and
//         packed at construction in the exact shared-memory image of the B
//         operand (K-major, 128- or 64-byte swizzle), so a plain
//         cp.async.bulk brings a (tap, chunk) slab. Where the whole 9*Ci*Co
//         hi + lo set fits beside the patch ring and a block has several
//         tiles, it is loaded once per block and stays resident; otherwise
//         slabs stream through a second ring. A step's hi and lo slabs
//         lie one behind the other and are one B tile of twice the width:
//         one wgmma (n = 2 * BN) a k16 slice instead of two of half the
//         width, which measured ~84 clocks each on the H100 against 32 at
//         the peak rate. The hi and lo sums are added in registers after the K
//         loop, which keeps fp32-weight accuracy with exact bf16
//         activations.
//       - Pipeline: full/empty mbarriers per stage; the producer runs ahead
//         across steps and across work items, so one tile's epilogue
//         overlaps the next tile's loads. wgmma groups are committed per
//         step and waited one step late; A fragments are double-buffered
//         in registers.
//       - Epilogue: scale, bias, ReLU and the rounding in registers; where
//         Co % 8 == 0 a warpgroup stages its 64 pixels x BN channels in
//         shared memory (swizzled) and one TMA store writes them, clipped to
//         the map; any other Co (the 19-class head) is written from the
//         registers with masks.
//       - A second input (the refine convs' concat) is a second tensor map:
//         the K loop walks the chunks of the first input, then the second.
//       - Small maps: the host picks 64- or 128-pixel tiles and, where its
//         cost model finds that it pays (many K steps over few tiles), splits
//         K. Partial sums go to an fp32 scratch; the block that finishes a
//         tile last (a counter per tile) adds them in a fixed order and runs
//         the epilogue, so the result does not depend on the order blocks
//         finish in.
//   * conv3x3_wgmma_kernel<float> (route 3): fp32 activations whose channel
//     counts are multiples of 16, as 3xTF32 on wgmma (m64nNk8, tf32 in).
//     The same pipeline, patch and weight rings, counted in bytes: a chunk
//     is 32 (or 16) fp32 channels, 128 (or 64) bytes a pixel, so the TMA
//     box, the swizzle, ldmatrix's addresses and the B descriptor are the
//     bf16 route's. ldmatrix.x4 on fp32 rows hands each lane exactly the
//     m64k8 tf32 A fragment, which is split in registers: hi = tf32(a),
//     lo = tf32(a - hi), both rounded to nearest (3 ALU operations an
//     element a tap, a small share of the issue slots the wgmmas leave).
//     The weights are packed as tf32 hi + lo in fp32 words. A k8 slice
//     issues hi x [W_hi | W_lo] (n = 2 * BN) and lo x W_hi (n = BN, into the
//     hi half of the accumulators): a product keeps ~2^-21 of itself, the
//     dropped lo x lo term is below that. Split bf16 (hi, lo of 8 bits,
//     the same three products at twice the rate) keeps only ~2^-16 and
//     misses the JAX package's fp32 bars (1e-4 / 2e-4) on activations of
//     8x unit scale; single-pass TF32 or bf16 misses them at any scale
//     (tests/test_torch_conv_split.py holds all four against the JAX
//     reference). The tensor cores truncate as they accumulate, so each
//     (tap, chunk) step's products start from zero and the CUDA cores add
//     the step's sum into an fp32 register sum, rounded to nearest. fp32
//     never splits K and its outputs leave from the registers, so each
//     output's sum runs in an order fixed by (Ci, Co, chunk, BN) alone: a
//     block of an image split over H gets the whole image's bits.
//   * conv3x3_stem_kernel<T> (route 1): bf16 or fp32, Ci = 3, stride 2, Co
//     in {32, 48, 64}. A block stages the three input rows its 128 outputs
//     need with 16-byte loads, holds the 27*Co weights in shared memory,
//     computes every output channel with fp32 FMAs (the input is read
//     once), and writes its 128 x Co outputs, contiguous in memory, as
//     16-byte pieces through shared memory.
//   * conv3x3_kernel (route 0): the channel counts no other route takes (not
//     multiples of 16, and not the stem entry), in either dtype, on CUDA
//     cores: one thread per output pixel and a block of 32 output channels.
//     The shipped student and teacher never reach it.
// Halo mode (spatial evaluation, an image split over H across ranks): the
// input holds top + h + bottom rows, top and bottom each 0 or 1, where the
// extra rows are a neighbouring block's edge rows. Every kernel reads input
// row r of the block at buffer row r + top and zero-fills only outside the
// buffer, so a halo row is read where the image's zero padding was; the
// output holds the block's (h - 1) / S + 1 rows. The generic and stem
// kernels shift their row index, the wgmma kernel its TMA start row.
// In all of them the pre-BN sum never leaves registers (or the fp32 scratch of
// a split K): folded-BN scale/bias and ReLU are applied in the epilogue, and
// the output is rounded once, to the activation type.

#include <cuda.h>  // CUtensorMap and its enums; the encoder is looked up at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

namespace {

constexpr int TW = 128;       // output pixels (threads) per block, along W
constexpr int CO_BLK = 32;    // output channels per block
constexpr int CI_CHUNK = 16;  // input channels staged per pass

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Loads CI_CHUNK consecutive channels as 16-byte vectors (caller checked
// that the address is 16-byte aligned).
__device__ __forceinline__ void load_chunk_vec(const float* p, float* v) {
#pragma unroll
  for (int q = 0; q < CI_CHUNK / 4; ++q) {
    float4 f = __ldg(reinterpret_cast<const float4*>(p) + q);
    v[4 * q] = f.x; v[4 * q + 1] = f.y; v[4 * q + 2] = f.z; v[4 * q + 3] = f.w;
  }
}
__device__ __forceinline__ void load_chunk_vec(const __nv_bfloat16* p, float* v) {
#pragma unroll
  for (int q = 0; q < CI_CHUNK / 8; ++q) {
    uint4 u = __ldg(reinterpret_cast<const uint4*>(p) + q);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float2 f = __bfloat1622float2(h[e]);
      v[8 * q + 2 * e] = f.x; v[8 * q + 2 * e + 1] = f.y;
    }
  }
}

__device__ __forceinline__ void fma_row(float* acc, float xv, const float* wrow) {
  const float4* w4 = reinterpret_cast<const float4*>(wrow);
#pragma unroll
  for (int q = 0; q < CO_BLK / 4; ++q) {
    float4 wv = w4[q];
    acc[4 * q] = fmaf(xv, wv.x, acc[4 * q]);
    acc[4 * q + 1] = fmaf(xv, wv.y, acc[4 * q + 1]);
    acc[4 * q + 2] = fmaf(xv, wv.z, acc[4 * q + 2]);
    acc[4 * q + 3] = fmaf(xv, wv.w, acc[4 * q + 3]);
  }
}

// x: (H, W, Ci), its first `top` rows a halo; w: (3, 3, Ci, Co) HWIO fp32;
// scale/bias: (Co,) fp32; y: (Ho, Wo, Co). Grid: (ceil(Wo/TW), Ho,
// ceil(Co/CO_BLK)).
template <typename T, int S>
__global__ void __launch_bounds__(TW)
conv3x3_kernel(const T* __restrict__ x, const float* __restrict__ w,
               const float* __restrict__ scale, const float* __restrict__ bias,
               T* __restrict__ y, int H, int W, int Ci, int Co, int Ho, int Wo,
               int top, int relu) {
  __shared__ float4 ws4[9 * CI_CHUNK * CO_BLK / 4];  // [tap][ci][co]
  float* ws = reinterpret_cast<float*>(ws4);

  const int ox = blockIdx.x * TW + threadIdx.x;
  const int oy = blockIdx.y;
  const int co0 = blockIdx.z * CO_BLK;
  const bool active = ox < Wo;
  constexpr int VEC = 16 / sizeof(T);
  const bool vec_in = (Ci % VEC) == 0;

  float acc[CO_BLK];
#pragma unroll
  for (int j = 0; j < CO_BLK; ++j) acc[j] = 0.f;

  for (int ci0 = 0; ci0 < Ci; ci0 += CI_CHUNK) {
    const int nc = min(CI_CHUNK, Ci - ci0);
    __syncthreads();  // the previous chunk's weights are no longer read
    for (int i = threadIdx.x; i < 9 * CI_CHUNK * CO_BLK; i += TW) {
      const int co = i % CO_BLK;
      const int c = (i / CO_BLK) % CI_CHUNK;
      const int tap = i / (CO_BLK * CI_CHUNK);
      float v = 0.f;
      if (c < nc && co0 + co < Co)
        v = w[((size_t)tap * Ci + ci0 + c) * Co + co0 + co];
      ws[i] = v;
    }
    __syncthreads();
    if (!active) continue;

#pragma unroll
    for (int ky = 0; ky < 3; ++ky) {
      const int iy = oy * S - 1 + top + ky;
      if (iy < 0 || iy >= H) continue;
#pragma unroll
      for (int kx = 0; kx < 3; ++kx) {
        const int ix = ox * S - 1 + kx;
        if (ix < 0 || ix >= W) continue;
        const T* xp = x + ((size_t)iy * W + ix) * Ci + ci0;
        const float* wp = ws + (ky * 3 + kx) * CI_CHUNK * CO_BLK;
        if (nc == CI_CHUNK && vec_in) {
          float xv[CI_CHUNK];
          load_chunk_vec(xp, xv);
#pragma unroll
          for (int c = 0; c < CI_CHUNK; ++c) fma_row(acc, xv[c], wp + c * CO_BLK);
        } else {
          for (int c = 0; c < nc; ++c) fma_row(acc, to_f(xp[c]), wp + c * CO_BLK);
        }
      }
    }
  }
  if (!active) return;

  T* yp = y + ((size_t)oy * Wo + ox) * Co + co0;
  if (co0 + CO_BLK <= Co && (Co % VEC) == 0) {
#pragma unroll
    for (int q = 0; q < CO_BLK / VEC; ++q) {
      alignas(16) T pack[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const int j = q * VEC + e;
        float v = fmaf(acc[j], __ldg(scale + co0 + j), __ldg(bias + co0 + j));
        if (relu) v = fmaxf(v, 0.f);
        pack[e] = from_f<T>(v);
      }
      reinterpret_cast<uint4*>(yp)[q] = *reinterpret_cast<const uint4*>(pack);
    }
  } else {
#pragma unroll
    for (int j = 0; j < CO_BLK; ++j) {
      if (co0 + j < Co) {
        float v = fmaf(acc[j], __ldg(scale + co0 + j), __ldg(bias + co0 + j));
        if (relu) v = fmaxf(v, 0.f);
        yp[j] = from_f<T>(v);
      }
    }
  }
}

// ------------------------------------------------------- tensor cores (wgmma)
// PTX wrappers: mbarrier, bulk copies, TMA tiled load, ldmatrix, wgmma.

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}
// waits until the barrier's phase differs from `parity`
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}
// contiguous global -> shared, completion counted in bytes on `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}
// one box of a 3-D tensor map (channels, x, y) -> shared; coordinates are
// signed, and what lies outside the tensor arrives as zeros
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, int c,
                                            int x, int y, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c), "r"(x), "r"(y)
      : "memory");
}
// one box shared -> global through a 3-D tensor map; what lies outside the
// tensor is not written
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, uint32_t src, int c,
                                             int x, int y) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n"
      "cp.async.bulk.commit_group;\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c), "r"(x), "r"(y)
      : "memory");
}
// four 8x8 b16 matrices: the A fragment of a 16 x 16 tile, rows from the
// per-lane addresses (lanes 0-15: rows 0-15 at k 0-7; lanes 16-31: k 8-15)
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// D (64 x N fp32, registers) += A (64 x 16 bf16, registers) * B (16 x N bf16,
// shared memory, K-major, through a matrix descriptor); N = 128 and 64
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4],
                                         uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      " %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      " %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      " %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      " %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      " %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
        "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
        "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),
        "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b));
}
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      " %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      " %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b));
}
// fp32 -> tf32, rounded to nearest (ties away): the low 13 bits are zero
__device__ __forceinline__ uint32_t tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}
// D (64 x N fp32) = A (64 x 8 tf32, registers) * B (8 x N tf32, shared
// memory, K-major, through a descriptor) + (add ? D : 0); N = 128, 64, 32. A is the
// m64k8 tf32 fragment: a[0] (row g, k q), a[1] (g + 8, q), a[2] (g, q + 4),
// a[3] (g + 8, q + 4) of the warp's 16 rows, which is what ldmatrix.x4 gives
// from fp32 rows (each 8x8 b16 matrix is 8 rows x 4 fp32).
#define WG_D8(i)                                                                   \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]),      \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], const uint32_t* a,
                                           uint64_t desc_b, int add) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24), WG_D8(32), WG_D8(40), WG_D8(48), WG_D8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(add));
}
__device__ __forceinline__ void wgmma_tf32(float (&d)[32], const uint32_t* a,
                                           uint64_t desc_b, int add) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(add));
}
__device__ __forceinline__ void wgmma_tf32(float (&d)[16], const uint32_t* a,
                                           uint64_t desc_b, int add) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : WG_D8(0), WG_D8(8)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(add));
}
#undef WG_D8
// keeps the compiler from moving reads or writes of the accumulators across
// the asynchronous wgmma's start and wait
template <int N> __device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

constexpr int TC_TW = 16;          // output columns of a tile: one warp, one tile row
constexpr int TC_MAX_PS = 4;       // patch ring stages at most
constexpr int TC_MAX_WS = 8;       // weight ring stages at most
constexpr int TC_DEPTH = 2;        // A-fragment buffers: wgmma groups in flight + 1
                                   // (3 and 4 measured no faster on the H100)
constexpr int TC_SMEM_LIMIT = 232448 - 1024;  // dynamic bytes a block may ask for

// Geometry for activations T (bf16, or fp32 taken as 3xTF32), stride S, CK
// input channels per chunk (64 or 128 bytes of a pixel), BN output channels
// per block and NWG consumer warpgroups (64 output pixels each).
template <typename T, int S, int CK, int BN, int NWG>
struct TcCfg {
  static constexpr bool F32 = sizeof(T) == 4;
  static constexpr int TH = 4 * NWG;             // output rows of a tile
  static constexpr int PW = (TC_TW - 1) * S + 3;  // patch width, pixels
  static constexpr int PH = (TH - 1) * S + 3;
  static constexpr int CKB = CK * (int)sizeof(T);  // bytes of a pixel's chunk
  static constexpr int KS = CKB / 32;            // k slices a chunk: 32 bytes each,
                                                 // k16 in bf16, k8 in tf32
  static constexpr int PATCH_BYTES = PW * PH * CKB;
  static constexpr int PATCH_STRIDE = (PATCH_BYTES + 1023) / 1024 * 1024;
  static constexpr int W_BYTES = 2 * BN * CKB;   // one (tap, chunk) step: the hi
                                                 // slab, then the lo slab
  static constexpr uint32_t SWZ = CKB == 128 ? 7 : 3;  // 128- or 64-byte swizzle
  static constexpr int THREADS = 128 * NWG + 32;
  // a warpgroup's staged output (bf16 only: fp32 leaves from the registers)
  static constexpr int OUT_BYTES = F32 ? 0 : 64 * BN * 2;
  static constexpr uint32_t OUT_SWZ = BN == 64 ? 7 : 3;
  // B descriptor without its address: 8 rows of CKB bytes per swizzle
  // group (stride byte offset), leading offset unused for swizzled K-major
  static constexpr uint64_t DESC =
      (uint64_t(1) << 16) | (uint64_t(8 * CKB >> 4) << 32) |
      (uint64_t(CKB == 128 ? 1 : 2) << 62);
};

struct TcArgs {
  const unsigned char* wpk;  // packed weights [n block][chunk][tap][hi, lo][BN][CK]
  const float* scale;
  const float* bias;
  void* y;
  float* scratch;            // split-K partial sums
  int* counters;             // one per (tile, n block), zero between launches
  int Co, Ho, Wo;
  int tiles_x, n_nb;
  int nch1, nch;             // chunks of the first input, of both
  int ksplit, n_work;
  int relu, resident, ps, ws;
  int top;                   // halo rows above the block (0 or 1)
  int tma_out;               // Co % 8 == 0: outputs leave by TMA stores
};

template <typename T, int S, int CK, int BN, int NWG>
__global__ void __launch_bounds__(TcCfg<T, S, CK, BN, NWG>::THREADS)
conv3x3_wgmma_kernel(const __grid_constant__ CUtensorMap map1,
                     const __grid_constant__ CUtensorMap map2,
                     const __grid_constant__ CUtensorMap map_y, const TcArgs a) {
  using C = TcCfg<T, S, CK, BN, NWG>;
  extern __shared__ unsigned char smem_raw[];
  // barriers in the first KB, then the 1024-byte aligned rings
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bars = base;
  const uint32_t patch0 = base + 1024;
  const uint32_t out0 = patch0 + a.ps * C::PATCH_STRIDE;  // staged outputs
  const uint32_t w0 = out0 + NWG * C::OUT_BYTES;
  auto patch_full = [&](int s) { return bars + 8u * s; };
  auto patch_empty = [&](int s) { return bars + 8u * (TC_MAX_PS + s); };
  auto w_full = [&](int s) { return bars + 8u * (2 * TC_MAX_PS + s); };
  auto w_empty = [&](int s) { return bars + 8u * (2 * TC_MAX_PS + TC_MAX_WS + s); };
  const uint32_t res_full = bars + 8u * (2 * TC_MAX_PS + 2 * TC_MAX_WS);

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < TC_MAX_PS; ++s) {
      mbar_init(patch_full(s), 1);
      mbar_init(patch_empty(s), 4 * NWG);
    }
    for (int s = 0; s < TC_MAX_WS; ++s) {
      mbar_init(w_full(s), 1);
      mbar_init(w_empty(s), 4 * NWG);
    }
    mbar_init(res_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&map1)));
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&map2)));
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&map_y)));
  }
  __syncthreads();

  const int steps = 9 * a.nch;

  if (tid >= 128 * NWG) {
    // ------------------------------------------------ producer (one thread)
    if (tid != 128 * NWG) return;
    if (a.resident) {
      mbar_expect_tx(res_full, steps * C::W_BYTES);
      for (int t = 0; t < steps; ++t)
        bulk_load(w0 + t * C::W_BYTES, a.wpk + (size_t)t * C::W_BYTES, C::W_BYTES,
                  res_full);
    }
    int ps = 0, ws = 0;
    uint32_t pph = 0, wph = 0;
    for (int work = blockIdx.x; work < a.n_work; work += gridDim.x) {
      const int ks = work % a.ksplit, item = work / a.ksplit;
      const int nb = item % a.n_nb, tile = item / a.n_nb;
      const int x0 = (tile % a.tiles_x) * TC_TW * S - 1;
      const int y0 = (tile / a.tiles_x) * C::TH * S - 1 + a.top;
      const int t0 = ks * steps / a.ksplit, t1 = (ks + 1) * steps / a.ksplit;
      for (int t = t0; t < t1; ++t) {
        const int chunk = t / 9, tap = t - 9 * chunk;
        if (t == t0 || tap == 0) {
          mbar_wait(patch_empty(ps), pph ^ 1);
          mbar_expect_tx(patch_full(ps), C::PATCH_BYTES);
          const bool second = chunk >= a.nch1;
          tma_load_3d(patch0 + ps * C::PATCH_STRIDE, second ? &map2 : &map1,
                      (second ? chunk - a.nch1 : chunk) * CK, x0, y0, patch_full(ps));
          if (++ps == a.ps) { ps = 0; pph ^= 1; }
        }
        if (!a.resident) {
          mbar_wait(w_empty(ws), wph ^ 1);
          mbar_expect_tx(w_full(ws), C::W_BYTES);
          bulk_load(w0 + ws * C::W_BYTES, a.wpk + ((size_t)nb * steps + t) * C::W_BYTES,
                    C::W_BYTES, w_full(ws));
          if (++ws == a.ws) { ws = 0; wph ^= 1; }
        }
      }
    }
    return;
  }

  // ---------------------------------------------------- consumer warpgroups
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int py = warp;  // tile row of this warp: 4 per warpgroup
  // ldmatrix: this lane's pixel (column lane & 15 of row py) at tap (0, 0),
  // and its 16-byte half of a k16 slice
  const uint32_t p0 = (py * S) * C::PW + (lane & 15) * S;
  const uint32_t khalf = (lane >> 4) * 16;
  constexpr int KS = C::KS;

  int ps = 0, ws = 0;
  uint32_t pph = 0, wph = 0;
  int rel_ws = 0, pending = 0;  // weight stages still read by wgmma groups in flight
  uint32_t cur_patch = 0;
  int cur_ps = 0;
  // the hi and lo slabs of a step are one B tile of 2 * BN rows: one wgmma
  // fills the products with hi in acc[0, BN / 2) and with lo behind them
  float acc[BN];
  // fp32: the tensor cores sum a step's products (acc, started from zero
  // each step) and the CUDA cores add each step's sum into `sum`
  float sum[C::F32 ? BN / 2 : 1];
  constexpr int D = TC_DEPTH;
  // bf16: A fragments, a ring over steps. fp32: the step's tf32 hi and lo
  // fragments, read by its wgmmas until the next step waits for them (the
  // raw fragments are split only then, which keeps the NWG = 2, BN = 64
  // instantiations within their 168 registers)
  constexpr int DF = C::F32 ? 1 : D;
  uint32_t f[DF][KS][4];
  uint32_t hl[C::F32 ? KS : 1][8];

  if (a.resident) mbar_wait(res_full, 0);

  for (int work = blockIdx.x; work < a.n_work; work += gridDim.x) {
    const int ks = work % a.ksplit, item = work / a.ksplit;
    const int nb = item % a.n_nb, tile = item / a.n_nb;
    const int t0 = ks * steps / a.ksplit, t1 = (ks + 1) * steps / a.ksplit;
#pragma unroll
    for (int i = 0; i < BN; ++i) acc[i] = 0.f;
    fence_regs(acc);
    if constexpr (C::F32) {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) sum[i] = 0.f;
    }

    auto step = [&](int t, uint32_t(&fr)[KS][4]) {
      const int chunk = t / 9, tap = t - 9 * chunk;
      const int ky = tap / 3, kx = tap - 3 * ky;
      if (t == t0 || tap == 0) {
        mbar_wait(patch_full(ps), pph);
        cur_patch = patch0 + ps * C::PATCH_STRIDE;
        cur_ps = ps;
        if (++ps == a.ps) { ps = 0; pph ^= 1; }
      }
      const uint32_t pix = (p0 + ky * C::PW + kx) * C::CKB + khalf;
#pragma unroll
      for (int kc = 0; kc < KS; ++kc) {
        uint32_t off = pix + kc * 32;
        off ^= ((off >> 7) & C::SWZ) << 4;
        ldmatrix_x4(fr[kc], cur_patch + off);
      }
      uint32_t wsm;
      if (a.resident) {
        wsm = w0 + t * C::W_BYTES;
      } else {
        mbar_wait(w_full(ws), wph);
        wsm = w0 + ws * C::W_BYTES;
      }
      if constexpr (C::F32) {
        // the previous step's sums (its group is the only one in flight)
        // into `sum`, in round-to-nearest: the tensor cores align and
        // truncate as they add, and over all the steps in one accumulator
        // that biased 32x64 384->384 by up to 3.2e-4 (outputs up to ~20;
        // 1.7e-5 with a sum a step, H100), above the fp32 bars
        wgmma_wait<0>();
        fence_regs(acc);
        if (t != t0) {
#pragma unroll
          for (int i = 0; i < BN / 2; ++i) sum[i] += acc[i] + acc[i + BN / 2];
        }
        // the fp32 fragments split: hi = tf32(a), lo = tf32(a - hi) (a - hi
        // is exact in fp32)
#pragma unroll
        for (int kc = 0; kc < KS; ++kc) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float v = __uint_as_float(fr[kc][e]);
            hl[kc][e] = tf32_rna(v);
            hl[kc][4 + e] = tf32_rna(v - __uint_as_float(hl[kc][e]));
          }
        }
      }
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < KS; ++kc) {
        const uint64_t desc = C::DESC | (((wsm + kc * 32) & 0x3FFFFu) >> 4);
        if constexpr (C::F32) {
          // hi x [W_hi | W_lo] into acc[0, BN) (the step's first slice
          // starts it from zero), then lo x W_hi (the hi slab's BN rows)
          // into acc[0, BN / 2): every output's products in one fixed order
          wgmma_tf32(acc, hl[kc], desc, kc != 0);
          wgmma_tf32(reinterpret_cast<float(&)[BN / 2]>(acc), hl[kc] + 4, desc, 1);
        } else {
          wgmma_rs(acc, fr[kc], desc);
        }
      }
      wgmma_commit();
      wgmma_wait<D - 1>();  // the group committed D - 1 steps ago is complete
      if (!a.resident) {
        if (++pending == D) {
          if (lane == 0) mbar_arrive(w_empty(rel_ws));
          if (++rel_ws == a.ws) rel_ws = 0;
          --pending;
        }
        if (++ws == a.ws) { ws = 0; wph ^= 1; }
      }
      if ((tap == 8 || t == t1 - 1) && lane == 0) mbar_arrive(patch_empty(cur_ps));
    };
    for (int t = t0; t < t1; t += D) {
#pragma unroll
      for (int d = 0; d < D; ++d)
        if (t + d < t1) step(t + d, f[C::F32 ? 0 : d]);
    }
    wgmma_wait<0>();
    fence_regs(acc);
    if constexpr (C::F32) {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = sum[i] + (acc[i] + acc[i + BN / 2]);
    } else {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] += acc[i + BN / 2];
    }
    for (; pending > 0; --pending) {
      if (lane == 0) mbar_arrive(w_empty(rel_ws));
      if (++rel_ws == a.ws) rel_ws = 0;
    }

    // accumulator layout of m64nN: d[4j], d[4j+1] are row 16*(warp % 4) + g,
    // columns 8j + 2q, +1; d[4j+2], d[4j+3] the same columns of row + 8
    if (!C::F32 && a.ksplit > 1) {
      // partial sums to the scratch, each thread its own; the block that
      // arrives last at this tile's counter adds them in split order
      constexpr int CT = 128 * NWG;
      float* mine = a.scratch + ((size_t)(item * a.ksplit + ks) * (BN / 2)) * CT + tid;
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) mine[i * CT] = acc[i];
      __threadfence();
      asm volatile("bar.sync 1, %0;\n" ::"n"(CT) : "memory");
      __shared__ int last_flag;
      if (tid == 0) {
        const int old = atomicAdd(a.counters + item, 1);
        last_flag = old == a.ksplit - 1;
        if (last_flag) a.counters[item] = 0;  // ready for the next launch
      }
      asm volatile("bar.sync 1, %0;\n" ::"n"(CT) : "memory");
      const bool last = last_flag;
      asm volatile("bar.sync 1, %0;\n" ::"n"(CT) : "memory");  // flag read by all
      if (!last) continue;
      __threadfence();
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
      for (int k = 0; k < a.ksplit; ++k) {
        const float* part =
            a.scratch + ((size_t)(item * a.ksplit + k) * (BN / 2)) * CT + tid;
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) acc[i] += __ldcg(part + i * CT);
      }
    }

    const int oy = (tile / a.tiles_x) * C::TH + py;
    const int ox0 = (tile % a.tiles_x) * TC_TW;
    if (!C::F32 && a.tma_out) {
      // Through shared memory and one TMA store a warpgroup: its 4 rows x
      // 16 pixels x BN channels, 16-byte pieces swizzled so that the
      // fragments' 4-byte writes spread over the banks. The store clips
      // what lies outside the map or beyond Co.
      const int wg = warp >> 2;
      const uint32_t mine = out0 + wg * C::OUT_BYTES;
      const bool leader = (tid & 127) == 0;
      // the previous tile's store has read the buffer
      if (leader) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      asm volatile("bar.sync %0, 128;\n" ::"r"(2 + wg) : "memory");
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int cl = j * 8 + 2 * q;  // channel within the block
        const int co = nb * BN + cl;
        const bool in = co < a.Co;     // Co % 8 == 0 here: pairs are whole
        const float2 sc = in ? __ldg(reinterpret_cast<const float2*>(a.scale + co))
                             : make_float2(0.f, 0.f);
        const float2 bi = in ? __ldg(reinterpret_cast<const float2*>(a.bias + co))
                             : make_float2(0.f, 0.f);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float v0 = fmaf(acc[4 * j + 2 * h], sc.x, bi.x);
          float v1 = fmaf(acc[4 * j + 2 * h + 1], sc.y, bi.y);
          if (a.relu) { v0 = fmaxf(v0, 0.f); v1 = fmaxf(v1, 0.f); }
          uint32_t off = (((warp & 3) * 16 + g + 8 * h) * BN + cl) * 2;
          off ^= ((off >> 7) & C::OUT_SWZ) << 4;
          const __nv_bfloat162 v = __floats2bfloat162_rn(v0, v1);
          asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(mine + off),
                       "r"(*reinterpret_cast<const uint32_t*>(&v))
                       : "memory");
        }
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile("bar.sync %0, 128;\n" ::"r"(2 + wg) : "memory");
      if (leader)
        tma_store_3d(&map_y, mine, nb * BN, ox0, (tile / a.tiles_x) * C::TH + 4 * wg);
      continue;
    }
    // any Co, straight from the registers
    if (oy >= a.Ho) continue;
    const bool pairs = (a.Co % 2) == 0;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int co = nb * BN + j * 8 + 2 * q;
      if (co >= a.Co) continue;
      const bool two = co + 1 < a.Co;
      const float s0 = __ldg(a.scale + co), b0 = __ldg(a.bias + co);
      const float s1 = two ? __ldg(a.scale + co + 1) : 0.f;
      const float b1 = two ? __ldg(a.bias + co + 1) : 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int ox = ox0 + g + 8 * h;
        if (ox >= a.Wo) continue;
        float v0 = fmaf(acc[4 * j + 2 * h], s0, b0);
        float v1 = fmaf(acc[4 * j + 2 * h + 1], s1, b1);
        if (a.relu) { v0 = fmaxf(v0, 0.f); v1 = fmaxf(v1, 0.f); }
        T* yp = static_cast<T*>(a.y) + ((size_t)oy * a.Wo + ox) * a.Co + co;
        if constexpr (C::F32) {
          if (two && pairs) {
            *reinterpret_cast<float2*>(yp) = make_float2(v0, v1);
          } else {
            yp[0] = v0;
            if (two) yp[1] = v1;
          }
        } else if (two && pairs) {
          *reinterpret_cast<__nv_bfloat162*>(yp) = __floats2bfloat162_rn(v0, v1);
        } else {
          yp[0] = __float2bfloat16(v0);
          if (two) yp[1] = __float2bfloat16(v1);
        }
      }
    }
  }
  // the last store has left shared memory before the block ends
  if (!C::F32 && a.tma_out && (tid & 127) == 0)
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// ------------------------------------------------------ the Ci = 3 stem entry
// bf16 or fp32 activations T, Ci = 3, stride 2, Co = CO in {32, 48, 64}. A
// block of 128 threads computes 128 consecutive output pixels of one output
// row, all CO channels. x: (H, W, 3), its first `top` rows a halo;
// w: (3, 3, 3, CO) fp32; y: (Ho, Wo, CO).
// Grid: (ceil(Wo / 128), Ho). (Two pixels a thread, to halve the weight reads
// from shared memory, measured 4-9 % slower on the H100 and was not kept.)
constexpr int ST_PX = 128;                         // output pixels per block

template <typename T, int CO>
__global__ void __launch_bounds__(ST_PX)
conv3x3_stem_kernel(const T* __restrict__ x, const float* __restrict__ w,
                    const float* __restrict__ scale, const float* __restrict__ bias,
                    T* __restrict__ y, int H, int W, int Ho, int Wo, int top,
                    int relu) {
  constexpr int PXB = 3 * (int)sizeof(T);  // bytes of an input pixel
  // staged bytes per input row: 16-byte pieces and a piece of slack each side
  constexpr int ROW = ((2 * ST_PX + 1) * PXB + 15) / 16 * 16 + 48;
  constexpr int VEC = 16 / (int)sizeof(T);  // outputs in a 16-byte piece
  constexpr int PITCH = CO * (int)sizeof(T) + 16;  // bytes per staged output pixel:
                                                   // 16-byte writes of neighbouring
                                                   // threads hit different banks
  constexpr int ROWS_BYTES = 3 * ROW, OUT_BYTES = ST_PX * PITCH;
  // fp32 at Co = 64 would pass the 48 KB of static shared memory: its staged
  // outputs then reuse the rows' bytes, after a barrier
  constexpr bool SHARE = ROWS_BYTES + OUT_BYTES + 27 * CO * 4 > 48 * 1024;
  __shared__ __align__(16) unsigned char buf[SHARE ? (ROWS_BYTES > OUT_BYTES ? ROWS_BYTES
                                                                            : OUT_BYTES)
                                                   : ROWS_BYTES + OUT_BYTES];
  __shared__ __align__(16) float ws[27 * CO];
  unsigned char* rows = buf;
  unsigned char* outs = SHARE ? buf : buf + ROWS_BYTES;

  const int tid = threadIdx.x;
  const int ox0 = blockIdx.x * ST_PX;
  const int oy = blockIdx.y;
  const int ix0 = ox0 * 2 - 1;  // first input column of the block (may be -1)

  for (int i = tid; i < 27 * CO / 4; i += ST_PX)
    reinterpret_cast<float4*>(ws)[i] = __ldg(reinterpret_cast<const float4*>(w) + i);

  // The bytes [lo, hi) of input row iy that the block needs, widened to
  // 16-byte pieces of global memory; a piece keeps its offset modulo 16 in
  // shared memory. Pieces that would cross the tensor's ends are copied
  // element by element. Bytes outside the row are never used: the taps
  // that fall on padding are masked below.
  const long long total = (long long)H * W * PXB;
  const unsigned char* xb = reinterpret_cast<const unsigned char*>(x);
  const int cx0 = max(ix0, 0), cx1 = min(ix0 + 2 * ST_PX + 1, W);  // columns [cx0, cx1)
  int shift[3];  // byte offset in rows[r] of input column ix0
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const int iy = oy * 2 - 1 + top + r;
    shift[r] = 0;
    if (iy < 0 || iy >= H) continue;
    const long long lo = ((long long)iy * W + cx0) * PXB;
    const long long hi = ((long long)iy * W + cx1) * PXB;
    const long long lo16 = lo & ~15ll;
    // column ix0 sits at (lo - lo16) - (cx0 - ix0) * PXB + 16: one piece of
    // slack in front keeps the offset non-negative when ix0 = -1
    shift[r] = (int)(lo - lo16) - (cx0 - ix0) * PXB + 16;
    const int pieces = (int)((hi - lo16 + 15) >> 4);
    for (int v = tid; v < pieces; v += ST_PX) {
      const long long src = lo16 + 16ll * v;
      unsigned char* dst = rows + r * ROW + 16 + 16 * v;
      if (src + 16 <= total) {
        *reinterpret_cast<uint4*>(dst) = __ldg(reinterpret_cast<const uint4*>(xb + src));
      } else {
        for (int e = 0; e < 16; e += 2)
          if (src + e < total)
            *reinterpret_cast<uint16_t*>(dst + e) =
                *reinterpret_cast<const uint16_t*>(xb + src + e);
      }
    }
  }
  __syncthreads();

  float acc[CO];
#pragma unroll
  for (int j = 0; j < CO; ++j) acc[j] = 0.f;
  const int ox = ox0 + tid;
#pragma unroll
  for (int ky = 0; ky < 3; ++ky) {
    const int iy = oy * 2 - 1 + top + ky;
    if (iy < 0 || iy >= H) continue;
#pragma unroll
    for (int kx = 0; kx < 3; ++kx) {
      const int ix = ox * 2 - 1 + kx;
      const bool valid = ix >= 0 && ix < W;
      const T* px = reinterpret_cast<const T*>(rows + ky * ROW + shift[ky] +
                                               (2 * tid + kx) * PXB);
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float xv = valid ? to_f(px[c]) : 0.f;
        const float4* w4 = reinterpret_cast<const float4*>(ws + ((ky * 3 + kx) * 3 + c) * CO);
#pragma unroll
        for (int j = 0; j < CO / 4; ++j) {
          const float4 wv = w4[j];
          acc[4 * j] = fmaf(xv, wv.x, acc[4 * j]);
          acc[4 * j + 1] = fmaf(xv, wv.y, acc[4 * j + 1]);
          acc[4 * j + 2] = fmaf(xv, wv.z, acc[4 * j + 2]);
          acc[4 * j + 3] = fmaf(xv, wv.w, acc[4 * j + 3]);
        }
      }
    }
  }

  // epilogue into shared memory, then the block's 128 x CO outputs (one
  // contiguous span of y) leave as 16-byte pieces, a warp's store contiguous
  if (SHARE) __syncthreads();  // every thread has read its rows
#pragma unroll
  for (int p = 0; p < CO / VEC; ++p) {
    alignas(16) T pack[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const int j = p * VEC + e;
      float v = fmaf(acc[j], __ldg(scale + j), __ldg(bias + j));
      if (relu) v = fmaxf(v, 0.f);
      pack[e] = from_f<T>(v);
    }
    *reinterpret_cast<uint4*>(&outs[tid * PITCH + p * 16]) =
        *reinterpret_cast<const uint4*>(pack);
  }
  __syncthreads();
  const int npx = min(ST_PX, Wo - ox0);
  uint4* yv = reinterpret_cast<uint4*>(y + ((size_t)oy * Wo + ox0) * CO);
  for (int v = tid; v < npx * (CO / VEC); v += ST_PX)
    yv[v] = *reinterpret_cast<const uint4*>(
        &outs[(v / (CO / VEC)) * PITCH + (v % (CO / VEC)) * 16]);
}

// ------------------------------------------------------------------- host side

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled of the libcuda the process already uses
EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_GLOBAL);
    return lib ? reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled"))
               : nullptr;
  }();
  return fn;
}

int sm_count() {
  static int n = [] {
    int dev = 0, v = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev);
    return v > 0 ? v : 1;
  }();
  return n;
}

// (H, W, C) bf16 or fp32 NHWC as a 3-D map (C, W, H) with a box of
// ck x pw x ph; ck channels are 64 or 128 bytes
bool make_map(CUtensorMap* map, const void* x, int H, int W, int C, int ck, int pw,
              int ph, bool f32) {
  EncodeTiled enc = encode_tiled();
  if (!enc) return false;
  const cuuint64_t e = f32 ? 4 : 2;
  const cuuint64_t dims[3] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H};
  const cuuint64_t strides[2] = {(cuuint64_t)C * e, (cuuint64_t)W * C * e};
  const cuuint32_t box[3] = {(cuuint32_t)ck, (cuuint32_t)pw, (cuuint32_t)ph};
  const cuuint32_t ones[3] = {1, 1, 1};
  return enc(map, f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
             3, const_cast<void*>(x), dims, strides, box, ones,
             CU_TENSOR_MAP_INTERLEAVE_NONE,
             ck * e == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// How one wgmma conv is cut: consumer warpgroups (tile of 64 or 128 pixels),
// K split, grid, ring depths, resident weights, shared memory.
struct TcPlan {
  int nwg, ksplit, n_tiles, tiles_x, n_nb, n_work, grid, ps, ws, resident, smem;
};

int ceil_div(int a, int b) { return (a + b - 1) / b; }

// ckb: bytes of a pixel's chunk (64 or 128); f32: fp32 activations (3xTF32)
TcPlan tc_plan(int Ho, int Wo, int nch, int Co, int stride, int ckb, int bn, bool f32) {
  const int sms = sm_count();
  const int steps = 9 * nch;
  const int n_nb = ceil_div(Co, bn);
  const int tiles_x = ceil_div(Wo, TC_TW);
  const int wbytes = 2 * bn * ckb;
  // Cost in K steps of the slowest block: rounds over the SMs x (steps a
  // round, two warpgroups share the tensor cores) + a fixed cost a work item
  // (fill, epilogue). A split K pays for its scratch, fence, counter and the
  // last block's second pass: on the H100 about 2 us against 0.4 us a
  // step, so it is taken only where it saves many steps (16x32 256->256).
  // fp32 never splits K: its sums must not depend on the map's size (a
  // block of an image split over H gets the whole image's bits).
  TcPlan best{};
  long best_cost = -1;
  for (int nwg = 2; nwg >= 1; --nwg) {
    const int n_tiles = tiles_x * ceil_div(Ho, 4 * nwg);
    const int items = n_tiles * n_nb;
    const int pw = (TC_TW - 1) * stride + 3, ph = (4 * nwg - 1) * stride + 3;
    const int patch = (pw * ph * ckb + 1023) / 1024 * 1024;
    // alignment slack + barriers + the warpgroups' staged bf16 outputs
    const int fixed = 2048 + (f32 ? 0 : nwg * 64 * bn * 2);
    for (int ks = 1; ks <= (f32 ? 1 : 4); ++ks) {
      if (ks > 1 && (items * ks > sms || steps / ks < 3)) break;
      TcPlan p{};
      p.nwg = nwg; p.ksplit = ks; p.n_tiles = n_tiles; p.tiles_x = tiles_x;
      p.n_nb = n_nb; p.n_work = items * ks;
      p.grid = p.n_work < sms ? p.n_work : sms;
      // weights resident: one n block, several tiles a block, and room for
      // a patch ring of at least two stages beside them
      p.resident = n_nb == 1 && ks == 1 && p.n_work >= 2 * p.grid &&
                   fixed + steps * wbytes + 2 * patch <= TC_SMEM_LIMIT;
      if (p.resident) {
        p.ps = (TC_SMEM_LIMIT - fixed - steps * wbytes) / patch;
        if (p.ps > TC_MAX_PS) p.ps = TC_MAX_PS;
        p.smem = fixed + steps * wbytes + p.ps * patch;
      } else {
        p.ps = 2;
        p.ws = (TC_SMEM_LIMIT - fixed - 2 * patch) / wbytes;
        if (p.ws > TC_MAX_WS) p.ws = TC_MAX_WS;
        // the consumers hold TC_DEPTH stages; fewer than two more to
        // prefetch into starves them (the smaller tile has the room)
        if (p.ws < TC_DEPTH + 2) continue;
        p.smem = fixed + 2 * patch + p.ws * wbytes;
      }
      const long cost = (long)ceil_div(p.n_work, sms) *
                        ((long)ceil_div(steps, ks) * nwg + (ks > 1 ? 12 + 2 * ks : 5));
      if (best_cost < 0 || cost < best_cost) {
        best_cost = cost;
        best = p;
      }
    }
  }
  return best;
}

template <typename T, int S, int CK, int BN, int NWG>
cudaError_t launch_tc(const CUtensorMap& m1, const CUtensorMap& m2, const CUtensorMap& my,
                      const TcArgs& args, const TcPlan& p, cudaStream_t stream) {
  auto kernel = conv3x3_wgmma_kernel<T, S, CK, BN, NWG>;
  cudaError_t rc = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, TC_SMEM_LIMIT);
  if (rc != cudaSuccess) return rc;
  kernel<<<p.grid, TcCfg<T, S, CK, BN, NWG>::THREADS, p.smem, stream>>>(m1, m2, my, args);
  return cudaGetLastError();
}

template <typename T, int S, int CK, int BN>
cudaError_t launch_tc_nwg(const CUtensorMap& m1, const CUtensorMap& m2,
                          const CUtensorMap& my, const TcArgs& args, const TcPlan& p,
                          cudaStream_t stream) {
  return p.nwg == 2 ? launch_tc<T, S, CK, BN, 2>(m1, m2, my, args, p, stream)
                    : launch_tc<T, S, CK, BN, 1>(m1, m2, my, args, p, stream);
}

// CK = CK_WIDE (128-byte chunks) or CK_WIDE / 2 (64-byte chunks) elements
template <typename T, int S>
cudaError_t launch_tc_s(int ck, int bn, const CUtensorMap& m1, const CUtensorMap& m2,
                        const CUtensorMap& my, const TcArgs& args, const TcPlan& p,
                        cudaStream_t stream) {
  constexpr int CK_WIDE = 128 / (int)sizeof(T);
  if (ck == CK_WIDE)
    return bn == 64 ? launch_tc_nwg<T, S, CK_WIDE, 64>(m1, m2, my, args, p, stream)
                    : launch_tc_nwg<T, S, CK_WIDE, 32>(m1, m2, my, args, p, stream);
  return bn == 64 ? launch_tc_nwg<T, S, CK_WIDE / 2, 64>(m1, m2, my, args, p, stream)
                  : launch_tc_nwg<T, S, CK_WIDE / 2, 32>(m1, m2, my, args, p, stream);
}

template <typename T>
cudaError_t launch_stem(const void* x, const float* w, const float* scale,
                        const float* bias, void* y, int H, int W, int Co, int Ho, int Wo,
                        int top, int relu, cudaStream_t s) {
  dim3 grid((Wo + ST_PX - 1) / ST_PX, Ho);
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  if (Co == 32)
    conv3x3_stem_kernel<T, 32><<<grid, ST_PX, 0, s>>>(xt, w, scale, bias, yt, H, W, Ho, Wo,
                                                      top, relu);
  else if (Co == 48)
    conv3x3_stem_kernel<T, 48><<<grid, ST_PX, 0, s>>>(xt, w, scale, bias, yt, H, W, Ho, Wo,
                                                      top, relu);
  else
    conv3x3_stem_kernel<T, 64><<<grid, ST_PX, 0, s>>>(xt, w, scale, bias, yt, H, W, Ho, Wo,
                                                      top, relu);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_generic(const void* x, const float* w, const float* scale,
                           const float* bias, void* y, int H, int W, int Ci, int Co,
                           int Ho, int Wo, int stride, int top, int relu,
                           cudaStream_t stream) {
  if (Ho > 65535) return cudaErrorInvalidValue;  // one block row per output row
  dim3 grid((Wo + TW - 1) / TW, Ho, (Co + CO_BLK - 1) / CO_BLK);
  if (stride == 1)
    conv3x3_kernel<T, 1><<<grid, TW, 0, stream>>>(
        static_cast<const T*>(x), w, scale, bias, static_cast<T*>(y), H, W, Ci, Co, Ho,
        Wo, top, relu);
  else
    conv3x3_kernel<T, 2><<<grid, TW, 0, stream>>>(
        static_cast<const T*>(x), w, scale, bias, static_cast<T*>(y), H, W, Ci, Co, Ho,
        Wo, top, relu);
  return cudaGetLastError();
}

// ck elements of 64 or 128 bytes, bn 32 or 64 output channels
bool valid_tile(int ck, int bn, bool f32) {
  const int ckb = ck * (f32 ? 4 : 2);
  return (ckb == 128 || ckb == 64) && (bn == 64 || bn == 32);
}

}  // namespace

// Which kernel serves a conv, and what the wgmma kernel needs from its
// caller. out[0]: 0 generic CUDA-core kernel, 1 stem kernel, 2 wgmma kernel
// in bf16, 3 wgmma kernel in fp32 (3xTF32); out[1]: floats of split-K
// scratch; out[2]: counters (ints, zero).
// ci2 = 0 for one input; ck, bn as the weights were packed (0, 0: not packed).
// H counts the halo rows: top and bottom (each 0 or 1) of them belong to the
// neighbouring blocks, and the output has (H - top - bottom - 1) / stride + 1
// rows.
extern "C" int conv3x3_bn_relu_plan(int H, int W, int ci1, int ci2, int Co, int stride,
                                    int is_bf16, int ck, int bn, int top, int bottom,
                                    int* out) {
  out[0] = out[1] = out[2] = 0;
  if (stride != 1 && stride != 2) return (int)cudaErrorInvalidValue;
  if (top < 0 || top > 1 || bottom < 0 || bottom > 1 || H - top - bottom < 1)
    return (int)cudaErrorInvalidValue;
  const int Ho = (H - top - bottom - 1) / stride + 1, Wo = (W - 1) / stride + 1;
  const bool f32 = !is_bf16;
  if (ci2 == 0 && ci1 == 3 && stride == 2 && (Co == 32 || Co == 48 || Co == 64) &&
      Ho <= 65535) {
    out[0] = 1;
    return 0;
  }
  if (ci1 % 16 == 0 && ci2 % 16 == 0) {
    // these channel counts run on the tensor cores only: weights not packed
    // for them are refused, not served by the CUDA-core kernel
    if (!valid_tile(ck, bn, f32)) return (int)cudaErrorInvalidValue;
    const int nch = ceil_div(ci1, ck) + ceil_div(ci2, ck);
    const TcPlan p = tc_plan(Ho, Wo, nch, Co, stride, ck * (f32 ? 4 : 2), bn, f32);
    // no tile and ring fit in shared memory: refuse rather than launch a
    // zeroed plan
    if (p.nwg == 0) return (int)cudaErrorInvalidConfiguration;
    out[0] = f32 ? 3 : 2;
    if (p.ksplit > 1) {
      out[1] = p.n_work * 64 * p.nwg * bn;
      out[2] = p.n_tiles * p.n_nb;
    }
    return 0;
  }
  if (ci2 != 0) return (int)cudaErrorInvalidValue;  // the caller concatenates
  return 0;
}

// Launches the conv on `stream`; returns the CUDA error (0 when the launch
// was accepted). x (H, W, ci1) and, with ci2 > 0, x2 (H, W, ci2): the conv
// runs over their channel concat. w: (3, 3, ci1 + ci2, Co) HWIO fp32, used by
// the CUDA-core kernels; wpk: the packed hi/lo weights (bf16, or tf32 in fp32
// words, as the activations; ck, bn as packed), used by the wgmma kernel. scratch, counters: as
// conv3x3_bn_relu_plan sized them (counters zero; left zero). x and x2 hold
// H rows, the first `top` and the last `bottom` of them halo rows (0 or 1
// each; see the plan).
extern "C" int conv3x3_bn_relu(const void* x, const void* x2, const void* w,
                               const void* wpk, const void* scale, const void* bias,
                               void* y, void* scratch, void* counters, int H, int W,
                               int ci1, int ci2, int Co, int stride, int relu,
                               int is_bf16, int ck, int bn, int top, int bottom,
                               void* stream) {
  int route[3];
  const int bad = conv3x3_bn_relu_plan(H, W, ci1, ci2, Co, stride, is_bf16, ck, bn, top,
                                       bottom, route);
  if (bad) return bad;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  const float* wf = static_cast<const float*>(w);
  const int Ho = (H - top - bottom - 1) / stride + 1, Wo = (W - 1) / stride + 1;
  if (route[0] == 0) {
    if (is_bf16)
      return (int)launch_generic<__nv_bfloat16>(x, wf, sc, bi, y, H, W, ci1, Co, Ho, Wo,
                                                stride, top, relu, s);
    return (int)launch_generic<float>(x, wf, sc, bi, y, H, W, ci1, Co, Ho, Wo, stride,
                                      top, relu, s);
  }
  if (route[0] == 1) {
    if (is_bf16)
      return (int)launch_stem<__nv_bfloat16>(x, wf, sc, bi, y, H, W, Co, Ho, Wo, top, relu,
                                             s);
    return (int)launch_stem<float>(x, wf, sc, bi, y, H, W, Co, Ho, Wo, top, relu, s);
  }
  const bool f32 = route[0] == 3;
  const int nch1 = ceil_div(ci1, ck), nch = nch1 + ceil_div(ci2, ck);
  const TcPlan p = tc_plan(Ho, Wo, nch, Co, stride, ck * (f32 ? 4 : 2), bn, f32);
  const int pw = (TC_TW - 1) * stride + 3, ph = (4 * p.nwg - 1) * stride + 3;
  CUtensorMap m1, m2, my;
  if (!make_map(&m1, x, H, W, ci1, ck, pw, ph, f32)) return (int)cudaErrorInvalidValue;
  // the output's map (bf16): a warpgroup stores 4 rows x 16 pixels x bn
  // channels; fp32 outputs leave from the registers
  const int tma_out = !f32 && Co % 8 == 0;
  if (!tma_out)
    my = m1;
  else if (!make_map(&my, y, Ho, Wo, Co, bn, TC_TW, 4, false))
    return (int)cudaErrorInvalidValue;
  if (ci2 == 0)
    m2 = m1;
  else if (!make_map(&m2, x2, H, W, ci2, ck, pw, ph, f32))
    return (int)cudaErrorInvalidValue;
  TcArgs args;
  args.wpk = static_cast<const unsigned char*>(wpk);
  args.scale = sc; args.bias = bi;
  args.y = y;
  args.scratch = static_cast<float*>(scratch);
  args.counters = static_cast<int*>(counters);
  args.Co = Co; args.Ho = Ho; args.Wo = Wo;
  args.tiles_x = p.tiles_x; args.n_nb = p.n_nb;
  args.nch1 = nch1; args.nch = nch;
  args.ksplit = p.ksplit; args.n_work = p.n_work;
  args.relu = relu; args.resident = p.resident; args.ps = p.ps; args.ws = p.ws;
  args.top = top;
  args.tma_out = tma_out;
  if (f32)
    return (int)(stride == 1 ? launch_tc_s<float, 1>(ck, bn, m1, m2, my, args, p, s)
                             : launch_tc_s<float, 2>(ck, bn, m1, m2, my, args, p, s));
  return (int)(stride == 1 ? launch_tc_s<__nv_bfloat16, 1>(ck, bn, m1, m2, my, args, p, s)
                           : launch_tc_s<__nv_bfloat16, 2>(ck, bn, m1, m2, my, args, p, s));
}
