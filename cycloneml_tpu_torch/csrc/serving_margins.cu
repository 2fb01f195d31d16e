// Serving margins in a fixed order (sm_90a): for K linear models of Km
// margin rows over d features, and a bucket of B request rows,
//     out[k, b, m] = sum_j x[b, j] * c[k, m, j] + icpt[k, m]
// in the serving dtype (float32 or float64), with c either the serving
// dtype's coefficients or e4m3 codes times one scale a margin row,
// c[k, m, j] = code[k, m, j] * scale[k, m], rounded once.
//
// Replaces the reference's jnp predict kernels, not a Pallas kernel:
// linear_margins, stacked_linear_margins, quantized_linear_margins and
// stacked_quantized_linear_margins (cycloneml_tpu/serving/servable.py:67,
// :80, :88, :104). Their contract is bitwise: a row's margins are the same
// bits in every shape bucket, so zero-padding a batch up to its bucket
// changes nothing, and a gang of K models gives the bits of K serial
// lanes. No library call promises that: cuBLAS picks its gemm algorithm
// (split-K, tile) by shape, and torch's reductions split by the number of
// outputs, so x @ c^T may change its last bits with the bucket. A torch
// path would also have to materialize the dequantized coefficients, where
// the quantized tier's point is 1-byte coefficients read by the kernel.
//
// The order, which depends on neither B nor K: one warp a (model, row,
// margin); lane l adds the products of columns j = l, l + 32, l + 64, ...
// in that order, each product and each sum rounded on its own (__fmul_rn /
// __fadd_rn, __dmul_rn / __dadd_rn: the compiler cannot contract them into
// FMAs); then a fixed xor-shuffle tree over offsets 16, 8, 4, 2, 1; then
// lane 0 adds the intercept. The plain twin (ops/kernels.py,
// serving_margins_plain) runs the same sequence with elementwise torch ops
// and gives the same bits on the CPU and on the card.
//
// Bound: launch latency. At the serving shapes (B <= 64, K <= 10, d <=
// 3,072) the coefficients, the bucket's rows and the margins are at most
// ~1.2 MB, a third of a microsecond at an H100 SXM's 3.35 TB/s (data
// sheet), and the products ~4 MFLOP. The dispatch is one CUDA graph a
// bucket (serving/batcher.py): the copy of the pinned request rows to the
// device, this kernel and the copy of the margins back to pinned memory,
// captured once at registration and replayed a batch. So the entry takes
// the stream, synchronizes nothing and allocates nothing.
//
// Plain C interface (loaded with ctypes): the entry returns a cudaError_t,
// 0 on success.

#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;  // warps of a CTA, one (model, row, margin) each

__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}

// coefficient j of a margin row: the value, or the e4m3 code (converted
// exactly) times the row's scale, rounded once
template <typename T, bool Q>
__device__ __forceinline__ T coef_at(const void* row, int j, T scale) {
  if constexpr (Q) {
    const __nv_fp8_e4m3 code = static_cast<const __nv_fp8_e4m3*>(row)[j];
    return mul_rn(static_cast<T>(static_cast<float>(code)), scale);
  } else {
    return static_cast<const T*>(row)[j];
  }
}

template <typename T, bool Q>
__global__ void __launch_bounds__(kWarps * 32)
serving_margins_kernel(const T* __restrict__ x, const void* __restrict__ coef,
                       const T* __restrict__ scale,
                       const T* __restrict__ icpt, int b, int km, int d,
                       long long warps, T* __restrict__ out) {
  // out is (K, B, Km): warp w is (model, row, margin) in that order, so a
  // lane-0 store lands at out[w]
  const long long w = (long long)blockIdx.x * kWarps + threadIdx.x / 32;
  if (w >= warps) return;  // a whole warp leaves together
  const int lane = threadIdx.x & 31;
  const int m = (int)(w % km);
  const long long rest = w / km;
  const int row = (int)(rest % b);
  const long long crow = (rest / b) * km + m;  // model * Km + margin
  const T* xr = x + (long long)row * d;
  const size_t elem = Q ? 1 : sizeof(T);
  const void* cr = static_cast<const char*>(coef) + crow * d * elem;
  const T s = Q ? scale[crow] : T(1);
  T acc = T(0);
  for (int j = lane; j < d; j += 32)
    acc = add_rn(acc, mul_rn(xr[j], coef_at<T, Q>(cr, j, s)));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc = add_rn(acc, __shfl_xor_sync(0xffffffffu, acc, off));
  if (lane == 0) out[w] = add_rn(acc, icpt[crow]);
}

template <typename T, bool Q>
cudaError_t launch(const void* x, const void* coef, const void* scale,
                   const void* icpt, int k, int b, int km, int d, void* out,
                   cudaStream_t stream) {
  const long long warps = (long long)k * b * km;
  const long long blocks = (warps + kWarps - 1) / kWarps;
  serving_margins_kernel<T, Q><<<(unsigned)blocks, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(x), coef, static_cast<const T*>(scale),
      static_cast<const T*>(icpt), b, km, d, warps, static_cast<T*>(out));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 float64 (x, scale, icpt and out); quantized: coef is
// e4m3 codes (K, Km, d) with scale (K, Km), else coef is (K, Km, d) in the
// dtype and scale is unused. x: (B, d) and out: (K, B, Km) on the device.
// The launch is enqueued on `stream`; nothing synchronizes.
int serving_margins_launch(int dtype, int quantized, const void* x,
                           const void* coef, const void* scale,
                           const void* icpt, int k, int b, int km, int d,
                           void* out, void* stream) {
  if (k < 1 || b < 1 || km < 1 || d < 1 || dtype < 0 || dtype > 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = quantized ? launch<float, true>(x, coef, scale, icpt, k, b, km, d,
                                          out, s)
                    : launch<float, false>(x, coef, scale, icpt, k, b, km, d,
                                           out, s);
  else
    err = quantized ? launch<double, true>(x, coef, scale, icpt, k, b, km, d,
                                           out, s)
                    : launch<double, false>(x, coef, scale, icpt, k, b, km,
                                            d, out, s);
  return (int)err;
}

}  // extern "C"
