// Align-corners bilinear upsample of 1/8-resolution logits fused with the
// channel argmax: (H8, W8, C) NHWC logits -> (H, W) int32 class map.
//
// Replaces fasterseg_tpu/pallas/fused.py:63 upsample8_argmax (pallas_call at
// :82). The Pallas kernel runs the two interpolation passes as MXU products
// with bf16-rounded interpolation matrices and a bf16-rounded H-pass result
// (fused.py:53,77-78). Its contract is the fp32 upsample8_argmax_xla
// (fused.py:101), and this kernel follows the contract: the weights and the
// interpolation are fp32, so the two kernels may differ at near-ties.
//
// What bounds it on the H100: at the serving shape (1,128,256,19) bf16 ->
// (1,1024,2048) it must read 1.2 MB and write 8.4 MB, about 3 us at
// 3.35 TB/s, and the full-resolution logits (160 MB in fp32) never reach HBM.
// The arithmetic is small (0.4 GFLOP) but it is what sets the pace: 40 M
// pixel-channels, each an interpolation and a compare on the CUDA cores, and
// an SM's four schedulers issue one warp instruction a clock each (0.85 in
// practice), whatever the instruction. So the design counts instructions a
// pixel-channel: 3 for the interpolation and 3 for the argmax, and about 1.5
// more for the H pass, the shared-memory reads and the stores; the pixel
// kernel below spends three interpolations, four two-byte global loads with
// their conversions and the argmax on every pixel-channel. Shared
// memory returns 128 bytes a clock to an SM however many lanes read the same
// word, so a 16-byte read a lane costs four clocks of it: the W pass keeps
// them few by giving a lane four pixels that share three source columns.
//
// The tile kernel. A block of 8 warps owns 32 output rows x 128 output
// columns: a warp takes rows w, w + 8, w + 16, w + 24, a lane four adjacent
// columns of each.
//   1. The block stages the tile's source footprint (at the serving shape 6
//      rows x 19 columns x C) once, with coalesced reads of each source row's
//      contiguous NHWC run, converted to fp32, into shared memory as
//      [row][column][channel], the channel count padded to an odd multiple of
//      four words. Columns past the source are 0, padded channels -inf. The
//      tile's row coordinates go to shared memory with it.
//   2. H pass, once an output row: the warp lerps the row's two source rows
//      into its own shared-memory row, four channels an instruction. It
//      depends only on the output row and the source column, so the eight
//      or so pixels between two source columns share it.
//   3. W pass: a lane's four columns need three neighbouring source columns
//      (the host checks that; the step is (W8-1)/(W-1), so eight columns may
//      straddle two cells and four at most two). The lane reads those three
//      columns four channels at a time (16-byte reads; a column pitch that is
//      an odd multiple of 16 bytes keeps eight neighbouring columns on
//      distinct banks, lanes that share a column are served by one
//      broadcast), and each pixel is a three-tap sum whose outer coefficient
//      is 0: a multiply and two fused multiply-adds, which round exactly as
//      the two-tap lerp does and need no select of the pair. The
//      coefficients are the same for every row of the tile. The argmax is
//      `Best` below. The loop runs over whole groups of four channels: a
//      padded channel is -inf or NaN and never wins the strict compare.
//   4. The four class indices leave as one 16-byte store where W % 4 == 0.
// No barrier follows the one after staging: a warp reads only its own row of
// H-pass results. Source indices and lerp weights per row and column are
// precomputed on the host exactly as ops/resize.py:_ac_coords computes them
// (float64, then fp32) and padded to whole tiles by repeating the last entry,
// so the kernel clamps nothing. The tile kernel serves upsamples by about x4
// and more of at most 24 channels (the argmax's index arithmetic, `Best`). The
// contract is any size and any channel count, so the host gives the rest (a
// small factor or a downsample, whose footprint does not fit, or more
// channels) to the pixel kernel: one thread an output pixel, reading its four
// source pixels from global memory. Both kernels round alike: lerp(a, b, t) =
// fma(t, b, rn((1 - t) * a)), the order in which a matrix resize sums its two
// taps, H pass then W pass; on finite logits they return the same map bit for
// bit (a zero coefficient times an infinite logit is NaN, as it is in the
// matrix resize). The argmax keeps the first maximum (strict >), as
// torch.argmax and jnp.argmax do.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int WARPS = 8;              // warps a block, one output row each
constexpr int PASSES = 4;             // output rows a warp, one after the other
constexpr int TILE_H = WARPS * PASSES;  // output rows a block
constexpr int TILE_W = 128;           // output columns a block, four a lane
constexpr int THREADS = WARPS * 32;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

// (1 - t) * a + t * b with the low tap rounded first
__device__ __forceinline__ float lerp(float a, float b, float t1, float t) {
  return __fmaf_rn(t, b, __fmul_rn(t1, a));
}

// the three-tap form of lerp: (k0, k1, k2) is (1 - t, t, 0) or (0, 1 - t, t)
__device__ __forceinline__ float tap3(float v0, float v1, float v2, float k0,
                                      float k1, float k2) {
  return __fmaf_rn(k2, v2, __fmaf_rn(k1, v1, __fmul_rn(k0, v0)));
}

// The running maximum of four pixels and where it was found: a compare, a
// max and a multiply-add that accumulates the index instead of a select
// (selects run on the half-rate units, which the compare and the max already
// use). `at` is a float to which 2^k is added whenever channel k sets a new
// maximum: a sum of distinct powers of two below 2^24 is exact, and its
// exponent is the last channel that won. Hence at most 24 channels.
struct Best {
  float v[4];
  float at[4];
};

// channel k of four pixels; bit = 2^k
__device__ __forceinline__ void channel(Best& best, float v0, float v1, float v2,
                                        const float (&k0)[4], const float (&k1)[4],
                                        const float (&k2)[4], float bit) {
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const float v = tap3(v0, v1, v2, k0[p], k1[p], k2[p]);
    const float won = v > best.v[p] ? 1.f : 0.f;
    best.v[p] = fmaxf(best.v[p], v);  // a NaN never wins, as in the compare
    best.at[p] = __fmaf_rn(won, bit, best.at[p]);
  }
}

__device__ __forceinline__ int index_of(float at) {
  return max((__float_as_int(at) >> 23) - 127, 0);  // no winner: 0.f, index 0
}

// FR x FC: the largest source footprint of a tile. CP4: the padded channel
// count in groups of four, a template parameter so that the W pass unrolls
// (a loop over a count read at run time was 17 % slower at the serving
// shape on an H100); odd, hence 1, 3, 5 or 7 for up to 24 channels. Dynamic
// shared memory: (FR + WARPS) * FC * CP floats and 3 * TILE_H words of row
// coordinates.
template <typename T, int CP4>
__global__ void __launch_bounds__(THREADS) upsample_argmax_tile_kernel(
    const T* __restrict__ p8, const int* __restrict__ ylo,
    const int* __restrict__ yhi, const float* __restrict__ ty,
    const int* __restrict__ xlo, const float* __restrict__ tx,
    int* __restrict__ out, int H8, int W8, int C, int H, int W, int FR,
    int FC) {
  extern __shared__ float4 smem[];
  constexpr int CP = 4 * CP4;
  const int row_words = FC * CP;
  float* src = reinterpret_cast<float*>(smem);   // [FR][FC][CP]
  float* hp = src + FR * row_words;              // [WARPS][FC][CP]
  int* s_ya = reinterpret_cast<int*>(hp + WARPS * row_words);  // [TILE_H] each
  int* s_yb = s_ya + TILE_H;
  float* s_wy = reinterpret_cast<float*>(s_yb + TILE_H);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = blockIdx.y * TILE_H, c0 = blockIdx.x * TILE_W;
  // every coordinate the thread will need, asked for at once
  const int c = c0 + 4 * lane;
  const int y0 = ylo[r0], x0 = xlo[c0];
  const int4 lo = *reinterpret_cast<const int4*>(xlo + c);
  const float4 w = *reinterpret_cast<const float4*>(tx + c);
  if (threadIdx.x < TILE_H) {
    s_ya[threadIdx.x] = ylo[r0 + threadIdx.x] - y0;
    s_yb[threadIdx.x] = yhi[r0 + threadIdx.x] - y0;
    s_wy[threadIdx.x] = ty[r0 + threadIdx.x];
  }

  // 1. stage the footprint. A source row's part of it is one contiguous run
  // of FC * C elements in NHWC: thread t takes elements t, t + THREADS, ...
  // of every row's run (coalesced reads), so an element's place in the padded
  // row, column j = q / C, is found once, by a multiply: q < 2^16 and
  // 1 < C < 2^16, so floor(q * ceil(2^32 / C) / 2^32) = q / C (at C = 1 the
  // factor does not fit 32 bits, and j = q). Two elements of U
  // rows each are loaded before the first is stored: at the serving shape
  // that is the whole footprint in one round trip to memory.
  {
    constexpr int U = 6;
    const int run = FC * C, row_stride = W8 * C;
    const int valid = (min(x0 + FC, W8) - x0) * C;  // the rest lies past the source
    const unsigned inv_c = 0xffffffffu / (unsigned)C + 1u;
    const T* first = p8 + x0 * C;
    for (int q = threadIdx.x; q < run; q += 2 * THREADS) {
      const int q2 = q + THREADS;
      const int j = C == 1 ? q : (int)__umulhi((unsigned)q, inv_c);
      const int j2 = C == 1 ? q2 : (int)__umulhi((unsigned)q2, inv_c);
      float* dst = src + q + j * (CP - C);  // j * CP + k, k = q - j * C
      float* dst2 = src + q2 + j2 * (CP - C);
      const bool inside = q < valid, inside2 = q2 < valid, has2 = q2 < run;
      for (int i0 = 0; i0 < FR; i0 += U) {
        T v[U], v2[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int row = min(y0 + i0 + u, H8 - 1) * row_stride;
          if (i0 + u < FR && inside) v[u] = first[row + q];
          if (i0 + u < FR && inside2) v2[u] = first[row + q2];
        }
#pragma unroll
        for (int u = 0; u < U; ++u)
          if (i0 + u < FR) {
            dst[(i0 + u) * row_words] = inside ? to_f(v[u]) : 0.f;
            if (has2) dst2[(i0 + u) * row_words] = inside2 ? to_f(v2[u]) : 0.f;
          }
      }
    }
    // the padded channels never win the argmax
    for (int pp = threadIdx.x; pp < FR * FC; pp += THREADS)
      for (int k = C; k < CP; ++k) src[pp * CP + k] = -INFINITY;
  }

  // the W pass's coefficients: columns c .. c + 3 from source columns
  // lo.x .. lo.x + 2, the same for every row of the tile
  const int los[4] = {lo.x, lo.y, lo.z, lo.w};
  const float ws[4] = {w.x, w.y, w.z, w.w};
  float k0[4], k1[4], k2[4];
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const bool next = los[p] != lo.x;  // the pixel's pair starts one column on
    const float t = ws[p], t1 = 1.f - t;
    k0[p] = next ? 0.f : t1;
    k1[p] = next ? t1 : t;
    k2[p] = next ? t : 0.f;
  }
  float4* hrow = reinterpret_cast<float4*>(hp + warp * row_words);
  const float4* h = hrow + (lo.x - x0) * CP4;
  __syncthreads();

#pragma unroll 1
  for (int pass = 0; pass < PASSES; ++pass) {
    const int rr = pass * WARPS + warp, r = r0 + rr;
    if (r >= H) break;
    // 2. H pass: the warp lerps its row's two source rows into its row of hp
    {
      const float wy = s_wy[rr], wy1 = 1.f - wy;
      const float4* a = reinterpret_cast<const float4*>(src + s_ya[rr] * row_words);
      const float4* b = reinterpret_cast<const float4*>(src + s_yb[rr] * row_words);
      for (int q = lane; q < row_words / 4; q += 32) {
        const float4 va = a[q], vb = b[q];
        hrow[q] = make_float4(lerp(va.x, vb.x, wy1, wy), lerp(va.y, vb.y, wy1, wy),
                              lerp(va.z, vb.z, wy1, wy), lerp(va.w, vb.w, wy1, wy));
      }
    }
    __syncwarp();

    // 3. W pass
    Best best;
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      best.v[p] = -INFINITY;
      best.at[p] = 0.f;
    }
    // a group of four channels: three 16-byte reads, then a three-tap sum
    // and a compare for each of its 16 pixel-channels
    float bit = 1.f;
#pragma unroll
    for (int g = 0; g < CP4; ++g) {
      const float4 v0 = h[g], v1 = h[CP4 + g], v2 = h[2 * CP4 + g];
      channel(best, v0.x, v1.x, v2.x, k0, k1, k2, bit);
      channel(best, v0.y, v1.y, v2.y, k0, k1, k2, 2.f * bit);
      channel(best, v0.z, v1.z, v2.z, k0, k1, k2, 4.f * bit);
      channel(best, v0.w, v1.w, v2.w, k0, k1, k2, 8.f * bit);
      bit *= 16.f;
    }
    __syncwarp();  // the row of hp is free for the next pass

    // 4. store
    if (c < W) {
      int* o = out + (size_t)r * W + c;
      int idx[4];
#pragma unroll
      for (int p = 0; p < 4; ++p) idx[p] = index_of(best.at[p]);
      if ((W & 3) == 0) {
        *reinterpret_cast<int4*>(o) = make_int4(idx[0], idx[1], idx[2], idx[3]);
      } else {
#pragma unroll
        for (int p = 0; p < 4; ++p)
          if (c + p < W) o[p] = idx[p];
      }
    }
  }
}

// One thread an output pixel, for the shapes the tile kernel does not take.
template <typename T>
__global__ void upsample_argmax_pixel_kernel(
    const T* __restrict__ p8, const int* __restrict__ ylo,
    const int* __restrict__ yhi, const float* __restrict__ ty,
    const int* __restrict__ xlo, const int* __restrict__ xhi,
    const float* __restrict__ tx, int* __restrict__ out, int W8, int C, int W) {
  const int ox = blockIdx.x * blockDim.x + threadIdx.x;
  const int oy = blockIdx.y;
  if (ox >= W) return;
  const float wy = ty[oy], wx = tx[ox];
  const float wy1 = 1.f - wy, wx1 = 1.f - wx;
  const size_t r0 = (size_t)ylo[oy] * W8, r1 = (size_t)yhi[oy] * W8;
  const int c0 = xlo[ox], c1 = xhi[ox];
  const T* a = p8 + (r0 + c0) * C;  // (lo row, lo col)
  const T* b = p8 + (r0 + c1) * C;  // (lo row, hi col)
  const T* c = p8 + (r1 + c0) * C;  // (hi row, lo col)
  const T* d = p8 + (r1 + c1) * C;  // (hi row, hi col)
  float best = -INFINITY;
  int best_i = 0;
  for (int k = 0; k < C; ++k) {
    // H pass, then W pass, as the matrix resize applies them
    const float left = lerp(to_f(a[k]), to_f(c[k]), wy1, wy);
    const float right = lerp(to_f(b[k]), to_f(d[k]), wy1, wy);
    const float v = lerp(left, right, wx1, wx);
    if (v > best) {
      best = v;
      best_i = k;
    }
  }
  out[(size_t)oy * W + ox] = best_i;
}

template <typename T>
void launch(const void* p8, const int* ylo, const int* yhi, const float* ty,
            const int* xlo, const int* xhi, const float* tx, int* out, int H8,
            int W8, int C, int H, int W, int FR, int FC, int CP,
            cudaStream_t stream) {
  const T* p = static_cast<const T*>(p8);
  if (FR > 0) {
    const dim3 grid((W + TILE_W - 1) / TILE_W, (H + TILE_H - 1) / TILE_H);
    const size_t smem = ((size_t)(FR + WARPS) * FC * CP + 3 * TILE_H) * sizeof(float);
    auto kernel = CP == 4    ? upsample_argmax_tile_kernel<T, 1>
                  : CP == 12 ? upsample_argmax_tile_kernel<T, 3>
                  : CP == 20 ? upsample_argmax_tile_kernel<T, 5>
                             : upsample_argmax_tile_kernel<T, 7>;
    kernel<<<grid, THREADS, smem, stream>>>(p, ylo, yhi, ty, xlo, tx, out, H8,
                                            W8, C, H, W, FR, FC);
  } else {
    const dim3 grid((W + THREADS - 1) / THREADS, H);
    upsample_argmax_pixel_kernel<T><<<grid, THREADS, 0, stream>>>(
        p, ylo, yhi, ty, xlo, xhi, tx, out, W8, C, W);
  }
}

}  // namespace

// The coordinate arrays are padded to whole tiles (rows to TILE_H, columns to
// TILE_W). FR > 0 takes the tile kernel with that footprint (FR rows, FC
// columns, CP padded channels; at most 48 KB of shared memory), FR == 0 the
// pixel kernel. Returns cudaGetLastError() after the launch (0 when it was
// accepted).
extern "C" int upsample8_argmax(const void* p8, const void* ylo, const void* yhi,
                                const void* ty, const void* xlo, const void* xhi,
                                const void* tx, void* out, int H8, int W8, int C,
                                int H, int W, int is_bf16, int FR, int FC, int CP,
                                void* stream) {
  if (FR > 0 && (CP > 28 || CP % 8 != 4)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* yl = static_cast<const int*>(ylo);
  const int* yh = static_cast<const int*>(yhi);
  const float* wy = static_cast<const float*>(ty);
  const int* xl = static_cast<const int*>(xlo);
  const int* xh = static_cast<const int*>(xhi);
  const float* wx = static_cast<const float*>(tx);
  int* o = static_cast<int*>(out);
  if (is_bf16)
    launch<__nv_bfloat16>(p8, yl, yh, wy, xl, xh, wx, o, H8, W8, C, H, W, FR, FC,
                          CP, s);
  else
    launch<float>(p8, yl, yh, wy, xl, xh, wx, o, H8, W8, C, H, W, FR, FC, CP, s);
  return (int)cudaGetLastError();
}

// What the host's plan (kernels/fused.py `_plan`) must agree with: TILE_H,
// TILE_W and WARPS in one word.
extern "C" int upsample8_argmax_tile() {
  return TILE_H << 20 | TILE_W << 8 | WARPS;
}
