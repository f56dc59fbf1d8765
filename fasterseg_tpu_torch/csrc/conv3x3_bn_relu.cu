// 3x3, pad-1 convolution + folded eval BatchNorm + optional ReLU, NHWC.
//
// Replaces two Pallas kernels of the JAX package:
//   fasterseg_tpu/pallas/conv.py:110 conv3x3_bn_relu_planar (pallas_call at :148)
//     stride 1 (and 2) over the channel-planar (H, C_pad16, W_pad128) layout;
//   fasterseg_tpu/pallas/conv.py:290 conv3x3s2_bn_relu_s2d (pallas_call at :336)
//     stride 2 written as a 2x2-tap stencil over space-to-depth input.
// Both compute y = relu?(conv3x3(x, w) * scale + bias). The planar layout, its
// 16-sublane / 128-lane padding and the space-to-depth packing exist only for
// Mosaic's tiling; they are not reproduced here. This kernel reads NHWC
// activations as they are and takes the stride as a template parameter.
//
// What bounds it on the H100. The serving path has two regimes:
//   * the stem entry (Ci=3 -> Co=32, stride 2, 1024x2048 input) reads 12.6 MB
//     and writes 33.5 MB of bf16 for 0.9 GFLOP: about 14 us of HBM traffic at
//     3.35 TB/s, so it is memory-bound;
//   * the 64..384-channel convs do 18..120 FLOP per byte moved. The stem's
//     64->64 conv at 256x512 moves 33.6 MB (10 us at 3.35 TB/s) for
//     9.7 GFLOP: 10 us on bf16 tensor cores (989 TFLOP/s), but 144 us on
//     fp32 CUDA cores (67 TFLOP/s), so these convs belong on the tensor
//     cores.
// What the design does. Two kernels behind one entry point:
//   * bf16 activations with Ci % 16 == 0 (every conv of the serving path
//     but the stem entry) run an implicit GEMM on the tensor cores
//     (mma.sync m16n8k16, bf16 in, fp32 accumulate): a block of 128 output
//     pixels (Ho*Wo flattened, so a tile may span rows) x 64 output
//     channels, K = 9 taps x Ci staged through shared memory 64 channels at
//     a time where Ci % 64 == 0, else 32, double-buffered: cp.async brings
//     the next step's pixels while the warps multiply the current one. See
//     conv3x3_tc_kernel.
//   * fp32 activations (the tests' bars), and Ci = 3 at the stem entry, run
//     on CUDA cores: one thread per output pixel and a block of 32 output
//     channels, accumulating in 32 fp32 registers; the 3x3 x 16-channel
//     weight slice of the block is staged in shared memory (broadcast reads,
//     float4 at a time) and the 9*Ci reduction runs in registers. Each input
//     pixel is read with 16-byte loads where Ci allows, and reused from L1 by
//     the neighbouring output pixels. At Ci = 3 the work is 27 FMAs per
//     output channel, so this kernel meets the stem entry's byte bound
//     better than a GEMM tile would.
// In both, the pre-BN sum never leaves registers: the folded-BN scale/bias
// and the ReLU are applied in the epilogue. Not done yet (the next
// redesign): weights staged once per SM (TMA), wgmma, a deeper pipeline.
//
// Weights, scale and bias are fp32. Accumulation is fp32 for both bf16 and
// fp32 activations; the output is rounded once, to the activation type.
// (The Pallas kernels cast the weights to bf16 for the MXU. This kernel
// does not round them: the tensor-core path splits each weight into bf16
// hi + lo and issues two mma's, so its bf16 path stays close to fp32.)

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

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

// x: (H, W, Ci); w: (3, 3, Ci, Co) HWIO fp32; scale/bias: (Co,) fp32;
// y: (Ho, Wo, Co). Grid: (ceil(Wo/TW), Ho, ceil(Co/CO_BLK)).
template <typename T, int S>
__global__ void __launch_bounds__(TW)
conv3x3_kernel(const T* __restrict__ x, const float* __restrict__ w,
               const float* __restrict__ scale, const float* __restrict__ bias,
               T* __restrict__ y, int H, int W, int Ci, int Co, int Ho, int Wo,
               int relu) {
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
      const int iy = oy * S - 1 + ky;
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

// ---------------------------------------------------------------- tensor cores
// bf16 activations with Ci % 16 == 0: implicit GEMM on mma.sync m16n8k16
// (bf16 in, fp32 accumulate). M is the Ho*Wo output pixels, flattened, so a
// narrow map fills its tiles as well as a wide one; N is Co; K is 9 taps x Ci.
// A block computes TC_BM pixels x TC_BN output channels with 8 warps as
// 4 (pixels) x 2 (channels). The K loop steps over (tap, chunk of BK = 32 or
// 64 input channels); each step stages the chunk's input pixels (NHWC: the channels of
// a pixel are contiguous) and weights in shared memory, and the warps read
// their fragments with ldmatrix. The fp32 weights are split while staged into
// bf16 hi + lo (w - hi), and each product is the sum of two mma's, so the
// result keeps fp32-weight accuracy (~16 mantissa bits) while the
// activations are exact bf16.

constexpr int TC_BM = 128;        // output pixels per block
constexpr int TC_BN = 64;         // output channels per block
constexpr int TC_THREADS = 256;
constexpr int TC_WM = TC_BM / 4;  // pixels per warp
constexpr int TC_MI = TC_WM / 16;  // m16 tiles per warp
constexpr int TC_LDB = TC_BN + 8;  // smem pitch (bf16) of a weight row

// Tile geometry for BK input channels per step (32, or 64 when Ci allows:
// fewer, longer steps).
template <int BK>
struct TcTile {
  static constexpr int LDA = BK + 8;  // smem pitches: 16-byte rows,
                                      // conflict-free ldmatrix
  // per thread and step: 16-byte pixel copies, and passes of 4 weights
  static constexpr int A_VECS = TC_BM * BK / 8 / TC_THREADS;
  static constexpr int W_PASSES = TC_BN * BK / 4 / TC_THREADS;
  static constexpr int A_TILE = TC_BM * LDA;  // elements per buffer
  static constexpr int B_TILE = BK * TC_LDB;
  static constexpr size_t SMEM = 2 * (A_TILE + 2 * B_TILE) * sizeof(__nv_bfloat16);
};

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// four 8x8 b16 matrices; `trans` gives the column-major B fragment of a
// row-major [k][n] tile
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)));
}

// Copies 16 bytes global -> shared without a register round trip, through
// L1 (a pixel is read again by the next two taps of its row); with `valid`
// false it writes zeros (the conv's padding) and reads nothing.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(smem)), "l"(gmem), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit_wait() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// x: (H, W, Ci) bf16, Ci % 16 == 0; w: (3, 3, Ci, Co) HWIO fp32;
// y: (Ho, Wo, Co) bf16. Grid: (ceil(Ho*Wo / TC_BM), ceil(Co / TC_BN)).
//
// The K loop is software-pipelined over two shared-memory buffers: while the
// warps multiply step `it` out of one buffer, the pixels of step it+1 are in
// flight to the other by cp.async and its weights wait in registers, to be
// split and stored once the multiply is issued. One barrier per step.
template <int S, int BK>
__global__ void __launch_bounds__(TC_THREADS)
conv3x3_tc_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ w,
                  const float* __restrict__ scale, const float* __restrict__ bias,
                  __nv_bfloat16* __restrict__ y, int H, int W, int Ci, int Co,
                  int Ho, int Wo, int relu) {
  using Tile = TcTile<BK>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* const As = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [buf][pixel][k]
  __nv_bfloat16* const Bh = As + 2 * Tile::A_TILE;  // [buf][k][co], hi
  __nv_bfloat16* const Bl = Bh + 2 * Tile::B_TILE;  // [buf][k][co], lo

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp & 3) * TC_WM, wn = (warp >> 2) * 32;
  const int M = Ho * Wo;
  const int m0 = blockIdx.x * TC_BM;
  const int co0 = blockIdx.y * TC_BN;
  const int nch = (Ci + BK - 1) / BK;
  const int steps = 9 * nch;

  // this thread's pixel copies: the same pixels (and channel offsets) at
  // every step, so their input coordinates are worked out once
  int a_iy[Tile::A_VECS], a_ix[Tile::A_VECS];
#pragma unroll
  for (int r = 0; r < Tile::A_VECS; ++r) {
    const int m = m0 + (tid + r * TC_THREADS) / (BK / 8);
    a_iy[r] = m < M ? (m / Wo) * S - 1 : -8;  // -8: never a valid row
    a_ix[r] = m < M ? (m % Wo) * S - 1 : 0;
  }
  // this thread's weights: input channel bk, outputs bn + 4 per pass
  const int bn = (tid % (TC_BN / 4)) * 4, bk = tid / (TC_BN / 4);
  constexpr int K_STRIDE = TC_THREADS / (TC_BN / 4);  // input channels per pass
  float wreg[Tile::W_PASSES][4];

  auto issue_pixels = [&](int it, int buf) {
    const int tap = it / nch, ci0 = (it % nch) * BK;
    const int ky = tap / 3, kx = tap % 3;
    const int nc = min(BK, Ci - ci0);
#pragma unroll
    for (int r = 0; r < Tile::A_VECS; ++r) {
      const int v = tid + r * TC_THREADS;
      const int p = v / (BK / 8), q = (v % (BK / 8)) * 8;
      if (q >= nc) continue;  // a half chunk (Ci % 32 == 16)
      const int iy = a_iy[r] + ky, ix = a_ix[r] + kx;
      const bool valid = iy >= 0 && iy < H && ix >= 0 && ix < W;
      const __nv_bfloat16* src = valid ? x + ((size_t)iy * W + ix) * Ci + ci0 + q : x;
      cp_async16(As + buf * Tile::A_TILE + p * Tile::LDA + q, src, valid);
    }
  };
  auto load_weights = [&](int it) {
    const int tap = it / nch, ci0 = (it % nch) * BK;
    const int nc = min(BK, Ci - ci0);
    const int n = co0 + bn;
#pragma unroll
    for (int r = 0; r < Tile::W_PASSES; ++r) {
      const int k = bk + r * K_STRIDE;
      const float* src = w + ((size_t)tap * Ci + ci0 + k) * Co + n;
      if (k < nc && n + 3 < Co && (Co % 4) == 0) {
        const float4 f = __ldg(reinterpret_cast<const float4*>(src));
        wreg[r][0] = f.x; wreg[r][1] = f.y; wreg[r][2] = f.z; wreg[r][3] = f.w;
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          wreg[r][e] = (k < nc && n + e < Co) ? __ldg(src + e) : 0.f;
      }
    }
  };
  auto store_weights = [&](int buf) {
#pragma unroll
    for (int r = 0; r < Tile::W_PASSES; ++r) {
      alignas(8) __nv_bfloat16 hi[4], lo[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        hi[e] = __float2bfloat16(wreg[r][e]);
        lo[e] = __float2bfloat16(wreg[r][e] - __bfloat162float(hi[e]));
      }
      const int off = buf * Tile::B_TILE + (bk + r * K_STRIDE) * TC_LDB + bn;
      *reinterpret_cast<uint2*>(Bh + off) = *reinterpret_cast<const uint2*>(hi);
      *reinterpret_cast<uint2*>(Bl + off) = *reinterpret_cast<const uint2*>(lo);
    }
  };

  float acc[TC_MI][4][4];
#pragma unroll
  for (int i = 0; i < TC_MI; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  issue_pixels(0, 0);
  load_weights(0);
  store_weights(0);
  cp_async_commit_wait();
  __syncthreads();

  // ldmatrix lane addressing: A rows (lane & 15), k half (lane >> 4);
  // B k rows (lane & 15), n half (lane >> 4)
  const int lrow = lane & 15, lhalf = (lane >> 4) * 8;
  for (int it = 0; it < steps; ++it) {
    const int buf = it & 1;
    const bool more = it + 1 < steps;
    if (more) {
      issue_pixels(it + 1, buf ^ 1);
      load_weights(it + 1);
    }
    const int nc = min(BK, Ci - (it % nch) * BK);
    const __nv_bfloat16* a_s = As + buf * Tile::A_TILE;
    const __nv_bfloat16* bh_s = Bh + buf * Tile::B_TILE;
    const __nv_bfloat16* bl_s = Bl + buf * Tile::B_TILE;
    for (int kc = 0; kc < nc; kc += 16) {
      uint32_t a[TC_MI][4];
#pragma unroll
      for (int mi = 0; mi < TC_MI; ++mi)
        ldmatrix_x4(a[mi], a_s + (wm + mi * 16 + lrow) * Tile::LDA + kc + lhalf);
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {  // pairs of n8 tiles
        const int boff = (kc + lrow) * TC_LDB + wn + nj * 16 + lhalf;
        uint32_t h[4], l[4];
        ldmatrix_x4_trans(h, bh_s + boff);
        ldmatrix_x4_trans(l, bl_s + boff);
#pragma unroll
        for (int mi = 0; mi < TC_MI; ++mi) {
          mma_bf16(acc[mi][2 * nj], a[mi], l[0], l[1]);
          mma_bf16(acc[mi][2 * nj], a[mi], h[0], h[1]);
          mma_bf16(acc[mi][2 * nj + 1], a[mi], l[2], l[3]);
          mma_bf16(acc[mi][2 * nj + 1], a[mi], h[2], h[3]);
        }
      }
    }
    if (more) {
      store_weights(buf ^ 1);
      cp_async_commit_wait();
    }
    __syncthreads();
  }

  // epilogue: folded BN, ReLU, one rounding to bf16; the accumulator layout
  // of m16n8 is (row g, cols 2t, 2t+1) in c0, c1 and row g + 8 in c2, c3
  const bool pairs = (Co % 2) == 0;
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
    const int co = co0 + wn + ni * 8 + 2 * t;
    if (co >= Co) continue;
    const bool two = co + 1 < Co;
    const float s0 = __ldg(scale + co), b0 = __ldg(bias + co);
    const float s1 = two ? __ldg(scale + co + 1) : 0.f;
    const float b1 = two ? __ldg(bias + co + 1) : 0.f;
#pragma unroll
    for (int mi = 0; mi < TC_MI; ++mi) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm + mi * 16 + g + h * 8;
        if (m >= M) continue;
        float v0 = fmaf(acc[mi][ni][2 * h], s0, b0);
        float v1 = fmaf(acc[mi][ni][2 * h + 1], s1, b1);
        if (relu) { v0 = fmaxf(v0, 0.f); v1 = fmaxf(v1, 0.f); }
        __nv_bfloat16* yp = y + (size_t)m * Co + co;
        if (two && pairs) {
          *reinterpret_cast<__nv_bfloat162*>(yp) = __floats2bfloat162_rn(v0, v1);
        } else {
          yp[0] = __float2bfloat16(v0);
          if (two) yp[1] = __float2bfloat16(v1);
        }
      }
    }
  }
}

template <int BK>
void launch_tc(const void* x, const float* w, const float* scale, const float* bias,
               void* y, int H, int W, int Ci, int Co, int Ho, int Wo, int stride,
               int relu, cudaStream_t stream) {
  constexpr size_t smem = TcTile<BK>::SMEM;
  dim3 grid((Ho * Wo + TC_BM - 1) / TC_BM, (Co + TC_BN - 1) / TC_BN);
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
  __nv_bfloat16* yb = static_cast<__nv_bfloat16*>(y);
  if constexpr (smem > 48 * 1024) {  // must be asked for above 48 KB
    cudaFuncSetAttribute(conv3x3_tc_kernel<1, BK>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    cudaFuncSetAttribute(conv3x3_tc_kernel<2, BK>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  }
  if (stride == 1)
    conv3x3_tc_kernel<1, BK><<<grid, TC_THREADS, smem, stream>>>(
        xb, w, scale, bias, yb, H, W, Ci, Co, Ho, Wo, relu);
  else
    conv3x3_tc_kernel<2, BK><<<grid, TC_THREADS, smem, stream>>>(
        xb, w, scale, bias, yb, H, W, Ci, Co, Ho, Wo, relu);
}

template <typename T>
void launch(const void* x, const float* w, const float* scale, const float* bias,
            void* y, int H, int W, int Ci, int Co, int stride, int relu,
            cudaStream_t stream) {
  const int Ho = (H - 1) / stride + 1;
  const int Wo = (W - 1) / stride + 1;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (Ci % 16 == 0) {
      if (Ci % 64 == 0)
        launch_tc<64>(x, w, scale, bias, y, H, W, Ci, Co, Ho, Wo, stride, relu, stream);
      else
        launch_tc<32>(x, w, scale, bias, y, H, W, Ci, Co, Ho, Wo, stride, relu, stream);
      return;
    }
  }
  dim3 grid((Wo + TW - 1) / TW, Ho, (Co + CO_BLK - 1) / CO_BLK);
  if (stride == 1)
    conv3x3_kernel<T, 1><<<grid, TW, 0, stream>>>(
        static_cast<const T*>(x), w, scale, bias,
        static_cast<T*>(y), H, W, Ci, Co, Ho, Wo, relu);
  else
    conv3x3_kernel<T, 2><<<grid, TW, 0, stream>>>(
        static_cast<const T*>(x), w, scale, bias,
        static_cast<T*>(y), H, W, Ci, Co, Ho, Wo, relu);
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 when it was accepted).
// is_bf16: 1 for bfloat16 activations, 0 for float32; weights are float32.
extern "C" int conv3x3_bn_relu(const void* x, const void* w, const void* scale,
                               const void* bias, void* y, int H, int W, int Ci,
                               int Co, int stride, int relu, int is_bf16,
                               void* stream) {
  if (stride != 1 && stride != 2) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  const float* wf = static_cast<const float*>(w);
  if (is_bf16)
    launch<__nv_bfloat16>(x, wf, sc, bi, y, H, W, Ci, Co, stride, relu, s);
  else
    launch<float>(x, wf, sc, bi, y, H, W, Ci, Co, stride, relu, s);
  return (int)cudaGetLastError();
}
