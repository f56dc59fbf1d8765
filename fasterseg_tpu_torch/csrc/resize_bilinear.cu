// Bilinear align-corners resize of an NHWC map, both axes in one launch,
// with an optional ReLU on the result: (N, H, W, C) -> (N, Ho, Wo, C).
//
// It replaces no TPU kernel: the JAX package leaves its resizes to XLA
// einsums against (out, in) interpolation matrices, and the port first ran
// them as such contractions (ops/resize.py), one matrix product an axis with
// a permute copy on each side. This kernel computes the same function with
// the same roundings from the two nonzeros of each matrix row:
//
//   per axis, (lo, hi, w_lo, w_hi): the two source indices and weights of
//   the row, the weights rounded to the map's dtype as the contraction's
//   matrix is (the host builds them from ops/resize.py's matrix; an axis
//   whose size does not change has lo = hi = o, w_lo = 1, w_hi = 0);
//   H pass: for each of the two source columns a pixel reads,
//     h = w_lo * x[lo] + w_hi * x[hi];
//   W pass: out = w_lo * h[lo] + w_hi * h[hi]; then ReLU where asked.
//
// bf16 maps sum in fp32 and round each pass to bf16, as the bf16 GEMM's
// output is rounded: a bf16 weight times a bf16 value is exact in fp32, so
// each pass is one rounding of the exact two-tap sum. fp32 maps sum in
// float64 (the port's fp32 serving path sums its products in float64, so
// a block of an image split over H gets the whole image's bits): the H pass
// is exact products and one rounding, left unrounded to fp32; the W pass
// rounds each product and the sum; the result is rounded once to fp32. No
// multiply-add is contracted (explicit __*_rn intrinsics), so the plain
// PyTorch version in kernels/resize.py, which does the same operations one
// tensor op at a time, reproduces every bit.
//
// What bounds it on the H100: bytes. Each output element is written once
// and each input element is read once from HBM (its four uses by
// neighbouring pixels come from L1/L2: the largest map the serving path
// resizes is 8 MB, against 50 MB of L2), so the bound is (input + output
// bytes) / 3.35 TB/s. A block row is one output row of one image, so the
// row's taps are one broadcast load. Two kernels:
//
// * vector kernel, where C * size is a multiple of 16 bytes (the student's
//   32..256 bf16 channels): a thread takes one output pixel's 16 bytes of
//   channels, loads the four source pixels' 16 bytes each, keeps both
//   H-pass results in registers and writes with one store;
// * run kernel, any other C (the 19 class logits of the x8): a thread takes
//   one channel of a run of RUN neighbouring output pixels of the row, and
//   computes the H pass of a source column once for the run's pixels that
//   read it (eight at x8). Element by element, the conversions to and from
//   float64 (a quarter of the fp64 rate of the H100's SMs) and the index
//   arithmetic cost more than the bytes; the run shares them. Neighbouring
//   lanes take neighbouring channels, so a warp's stores cover one or two
//   contiguous runs of channels.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_GRID_YZ = 65535;
constexpr int RUN = 8;  // output pixels a thread of the run kernel

// (lo, hi, w_lo, w_hi) of one output coordinate, the weights' fp32 bits
struct Tap {
  int lo, hi;
  float w_lo, w_hi;
};

__device__ __forceinline__ Tap load_tap(const int4* taps, int i) {
  const int4 t = __ldg(taps + i);
  return {t.x, t.y, __int_as_float(t.z), __int_as_float(t.w)};
}

// The arithmetic of one dtype: the sum's type, a pass's rounding, the
// two-tap sum, the result's rounding and ReLU (torch.relu's x < 0 ? 0 : x:
// NaN and -0 pass), and VEC elements to and from 16 bytes.
struct Bf16 {
  using T = __nv_bfloat16;
  using Acc = float;
  static constexpr int VEC = 8;
  __device__ __forceinline__ static Acc widen(T v) { return __bfloat162float(v); }
  __device__ __forceinline__ static Acc round(Acc a) {
    return __bfloat162float(__float2bfloat16_rn(a));
  }
  __device__ __forceinline__ static Acc lerp(Acc a, Acc b, float wl, float wh) {
    return __fadd_rn(__fmul_rn(wl, a), __fmul_rn(wh, b));
  }
  __device__ __forceinline__ static T narrow(Acc a, bool relu) {
    const T r = __float2bfloat16_rn(a);
    return relu && __bfloat162float(r) < 0.f ? __float2bfloat16_rn(0.f) : r;
  }
  __device__ __forceinline__ static void load(const T* p, Acc (&v)[VEC]) {
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int k = 0; k < VEC / 2; ++k) {
      const float2 f = __bfloat1622float2(h[k]);
      v[2 * k] = f.x;
      v[2 * k + 1] = f.y;
    }
  }
  __device__ __forceinline__ static void store(T* p, const Acc (&v)[VEC],
                                               bool relu) {
    uint4 raw;
    T* o = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int k = 0; k < VEC; ++k) o[k] = narrow(v[k], relu);
    *reinterpret_cast<uint4*>(p) = raw;
  }
};

struct F32 {
  using T = float;
  using Acc = double;
  static constexpr int VEC = 4;
  __device__ __forceinline__ static Acc widen(T v) { return (double)v; }
  __device__ __forceinline__ static Acc round(Acc a) { return a; }
  __device__ __forceinline__ static Acc lerp(Acc a, Acc b, float wl, float wh) {
    return __dadd_rn(__dmul_rn((double)wl, a), __dmul_rn((double)wh, b));
  }
  __device__ __forceinline__ static T narrow(Acc a, bool relu) {
    const T r = __double2float_rn(a);
    return relu && r < 0.f ? 0.f : r;
  }
  __device__ __forceinline__ static void load(const T* p, Acc (&v)[VEC]) {
    const float4 f = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = f.x;
    v[1] = f.y;
    v[2] = f.z;
    v[3] = f.w;
  }
  __device__ __forceinline__ static void store(T* p, const Acc (&v)[VEC],
                                               bool relu) {
    *reinterpret_cast<float4*>(p) = make_float4(
        narrow(v[0], relu), narrow(v[1], relu), narrow(v[2], relu),
        narrow(v[3], relu));
  }
};

// grid: (ceil(Wo * C / VEC / THREADS), Ho, N); a thread one output pixel's
// VEC channels
template <typename M>
__global__ void __launch_bounds__(THREADS)
resize_vec_kernel(const typename M::T* __restrict__ x,
                  const int4* __restrict__ ytaps,
                  const int4* __restrict__ xtaps, typename M::T* __restrict__ out,
                  int H, int W, int C, int Ho, int Wo, int relu) {
  using Acc = typename M::Acc;
  constexpr int VEC = M::VEC;
  const int vecs = C / VEC;  // vectors a pixel
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= Wo * vecs) return;
  const int oy = blockIdx.y, n = blockIdx.z;
  const int ox = i / vecs;
  const int c = (i - ox * vecs) * VEC;
  const Tap ty = load_tap(ytaps, oy), tx = load_tap(xtaps, ox);
  const typename M::T* img = x + (size_t)n * H * W * C + c;
  const typename M::T* r0 = img + (size_t)ty.lo * W * C;
  const typename M::T* r1 = img + (size_t)ty.hi * W * C;
  Acc a[VEC], b[VEC], left[VEC], right[VEC];
  // H pass at the two source columns
  M::load(r0 + (size_t)tx.lo * C, a);
  M::load(r1 + (size_t)tx.lo * C, b);
#pragma unroll
  for (int k = 0; k < VEC; ++k)
    left[k] = M::round(M::lerp(a[k], b[k], ty.w_lo, ty.w_hi));
  M::load(r0 + (size_t)tx.hi * C, a);
  M::load(r1 + (size_t)tx.hi * C, b);
#pragma unroll
  for (int k = 0; k < VEC; ++k)
    right[k] = M::round(M::lerp(a[k], b[k], ty.w_lo, ty.w_hi));
  // W pass
#pragma unroll
  for (int k = 0; k < VEC; ++k)
    left[k] = M::lerp(left[k], right[k], tx.w_lo, tx.w_hi);
  M::store(out + (((size_t)n * Ho + oy) * Wo + ox) * C + c, left, relu != 0);
}

// grid: (ceil(ceil(Wo / RUN) * C / THREADS), Ho, N); a thread channel c of
// output pixels run * RUN .. run * RUN + RUN - 1, the H pass of a source
// column computed once while consecutive pixels read it
template <typename M>
__global__ void __launch_bounds__(THREADS)
resize_run_kernel(const typename M::T* __restrict__ x,
                  const int4* __restrict__ ytaps,
                  const int4* __restrict__ xtaps, typename M::T* __restrict__ out,
                  int H, int W, int C, int Ho, int Wo, int relu) {
  using Acc = typename M::Acc;
  const int i = blockIdx.x * THREADS + threadIdx.x;
  const int runs = (Wo + RUN - 1) / RUN;
  if (i >= runs * C) return;
  const int run = i / C;
  const int c = i - run * C;
  const int oy = blockIdx.y, n = blockIdx.z;
  const Tap ty = load_tap(ytaps, oy);
  const typename M::T* img = x + (size_t)n * H * W * C + c;
  const typename M::T* r0 = img + (size_t)ty.lo * W * C;
  const typename M::T* r1 = img + (size_t)ty.hi * W * C;
  typename M::T* o = out + ((size_t)n * Ho + oy) * Wo * C + c;
  auto h_pass = [&](int col) {
    const size_t at = (size_t)col * C;
    return M::round(M::lerp(M::widen(r0[at]), M::widen(r1[at]), ty.w_lo,
                            ty.w_hi));
  };
  int lo = -1, hi = -1;  // the source columns whose H pass is held
  Acc left = 0, right = 0;
  const int end = min(Wo, (run + 1) * RUN);
  for (int ox = run * RUN; ox < end; ++ox) {
    const Tap tx = load_tap(xtaps, ox);
    const Acc l = tx.lo == lo ? left : tx.lo == hi ? right : h_pass(tx.lo);
    const Acc r = tx.hi == hi ? right : tx.hi == lo ? left : h_pass(tx.hi);
    left = l;
    right = r;
    lo = tx.lo;
    hi = tx.hi;
    o[(size_t)ox * C] = M::narrow(M::lerp(left, right, tx.w_lo, tx.w_hi),
                                  relu != 0);
  }
}

template <typename M>
void launch(const void* x, const int4* ytaps, const int4* xtaps, void* out,
            int N, int H, int W, int C, int Ho, int Wo, int relu,
            cudaStream_t stream) {
  using T = typename M::T;
  const T* xt = static_cast<const T*>(x);
  T* o = static_cast<T*>(out);
  if (C % M::VEC == 0) {
    const int per_row = Wo * (C / M::VEC);
    const dim3 grid((per_row + THREADS - 1) / THREADS, Ho, N);
    resize_vec_kernel<M><<<grid, THREADS, 0, stream>>>(xt, ytaps, xtaps, o, H,
                                                       W, C, Ho, Wo, relu);
  } else {
    const int per_row = (Wo + RUN - 1) / RUN * C;
    const dim3 grid((per_row + THREADS - 1) / THREADS, Ho, N);
    resize_run_kernel<M><<<grid, THREADS, 0, stream>>>(xt, ytaps, xtaps, o, H,
                                                       W, C, Ho, Wo, relu);
  }
}

}  // namespace

// x and out: contiguous NHWC, 16-byte aligned; ytaps (Ho, 4) and xtaps
// (Wo, 4) int32 tap tables. Returns cudaGetLastError() after the launch (0
// when it was accepted); cudaErrorInvalidValue for shapes the grid cannot
// hold. The kernel is chosen here: the vector kernel where C * size is a
// multiple of 16 bytes, the run kernel otherwise.
extern "C" int resize_bilinear(const void* x, const void* ytaps,
                               const void* xtaps, void* out, int N, int H,
                               int W, int C, int Ho, int Wo, int is_bf16,
                               int relu, void* stream) {
  if (N < 1 || N > MAX_GRID_YZ || Ho < 1 || Ho > MAX_GRID_YZ || Wo < 1 ||
      C < 1 || (uintptr_t)x % 16 || (uintptr_t)out % 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int4* yt = static_cast<const int4*>(ytaps);
  const int4* xt = static_cast<const int4*>(xtaps);
  if (is_bf16)
    launch<Bf16>(x, yt, xt, out, N, H, W, C, Ho, Wo, relu, s);
  else
    launch<F32>(x, yt, xt, out, N, H, W, C, Ho, Wo, relu, s);
  return (int)cudaGetLastError();
}
