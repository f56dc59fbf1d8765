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
// 3.35 TB/s, against 0.4 GFLOP; it is memory-bound, and the full-resolution
// logits (160 MB in fp32) never reach HBM. What the design does: one thread
// per output pixel, consecutive threads on consecutive output columns so the
// int32 stores coalesce; the four source pixels' C channels are contiguous in
// NHWC and shared by the 8x8 output pixels of a source cell, so they are
// served from L1/L2. Source indices and lerp weights per row and column are
// precomputed on the host exactly as ops/resize.py:_ac_coords computes them.
// The argmax keeps the first maximum (strict >), as torch.argmax and
// jnp.argmax do.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__global__ void upsample_argmax_kernel(
    const T* __restrict__ p8, const int* __restrict__ ylo,
    const int* __restrict__ yhi, const float* __restrict__ ty,
    const int* __restrict__ xlo, const int* __restrict__ xhi,
    const float* __restrict__ tx, int* __restrict__ out, int W8, int C, int W) {
  const int ox = blockIdx.x * blockDim.x + threadIdx.x;
  const int oy = blockIdx.y;
  if (ox >= W) return;
  const float wy = ty[oy], wx = tx[ox];
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
    const float left = (1.f - wy) * to_f(a[k]) + wy * to_f(c[k]);
    const float right = (1.f - wy) * to_f(b[k]) + wy * to_f(d[k]);
    const float v = (1.f - wx) * left + wx * right;
    if (v > best) {
      best = v;
      best_i = k;
    }
  }
  out[(size_t)oy * W + ox] = best_i;
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 when it was accepted).
extern "C" int upsample8_argmax(const void* p8, const void* ylo, const void* yhi,
                                const void* ty, const void* xlo, const void* xhi,
                                const void* tx, void* out, int W8, int C, int H,
                                int W, int is_bf16, void* stream) {
  constexpr int THREADS = 256;
  dim3 grid((W + THREADS - 1) / THREADS, H);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* yl = static_cast<const int*>(ylo);
  const int* yh = static_cast<const int*>(yhi);
  const float* wy = static_cast<const float*>(ty);
  const int* xl = static_cast<const int*>(xlo);
  const int* xh = static_cast<const int*>(xhi);
  const float* wx = static_cast<const float*>(tx);
  int* o = static_cast<int*>(out);
  if (is_bf16)
    upsample_argmax_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(p8), yl, yh, wy, xl, xh, wx, o, W8, C, W);
  else
    upsample_argmax_kernel<float><<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(p8), yl, yh, wy, xl, xh, wx, o, W8, C, W);
  return (int)cudaGetLastError();
}
