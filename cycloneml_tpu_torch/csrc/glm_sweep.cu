// GLM row sweep for Hopper (sm_90a): one pass over X computing a GLM
// loss, its gradient, sum(mult) and sum(w), for two links.
//
// Replaces cycloneml_tpu/ops/kernels.py:_run_glm, the Pallas kernel behind
// fused_binary_logistic_scaled (kind="logistic", K1) and
// fused_least_squares_scaled (kind="squared", K2). Per row r:
//   margin = x_r . beta + off
//   logistic: mult = w_r (sigmoid(margin) - y_r)
//             loss += w_r (softplus(margin) - y_r margin)
//   squared:  err = margin - ys y_r; mult = w_r err
//             loss += 0.5 w_r err^2
//   grad  += mult x_r
//   aux   += [mult, w_r]
// The wrapper folds standardization around it (beta = inv_std o coef,
// off = b0 - mu_hat . coef for the logistic link, off = y_mean_hat -
// mu_hat . coef and ys = 1/sigma_y for the squared one), so X is read raw
// at its storage width. The link is a template parameter: both instances
// share every load, reduction and the launch path.
//
// X is float32, bfloat16 or float8_e4m3fn CODES (the fp8 rung). The fp8
// rung's per-column dequantization scale (the reference's x_scale operand,
// kernels.py:309) is NOT applied here: the wrapper folds it into the (d,)
// vectors, beta o scale forward and grad_row o scale after the sweep, as
// the reference's fits fold it into inv_std (logistic_regression.py:763).
// x . (beta o s) = (x o s) . beta and sum(mult x) o s = sum(mult (x o s)),
// so the C interface is the same for every dtype and the scale costs no
// work per element.
//
// Bound: bytes. One sweep must read X once (n*d bytes in e4m3, n*d*2 in
// bf16, n*d*4 in f32) plus y and w; the arithmetic is ~4 flops per
// element, far below the card's rate. At n=2M, d=1280 that is 2.56 GB
// (e4m3), 5.12 GB (bf16) or 10.24 GB (f32): at least 0.77, 1.53 or 3.06 ms
// at 3.35 TB/s; K2 at the LinearRegression configuration (n=400k, d=2000)
// reads 0.8 GB (e4m3) or 1.6 GB (bf16): at least 0.24 or 0.48 ms.
//
// Design, and what it does about the bound:
// - One warp owns one row at a time (grid-stride over rows). Each lane
//   issues all of its 16-byte loads of the row before using any, and the
//   NEXT row's loads (with its y and w) are issued before the current row
//   is computed, so two rows per warp are in flight while it computes.
//   The warp reduces the margin with xor shuffles (every lane ends with
//   the bitwise-same margin), and the SAME registers feed the gradient
//   update: X is read from device memory exactly once per sweep; the
//   "second read" of the row for the gradient never leaves the register
//   file. beta lives in shared memory. bf16 unpacks to f32 by a shift;
//   e4m3 pairs by the hardware conversion (cvt.rn.f16x2.e4m3x2, exact:
//   every e4m3 value is an f16 value) and then f16 -> f32.
//   (Loading and using one slot at a time left the sweep at under a
//   third of its bound on an H100: a warp waited on memory several times
//   per row, with nothing else on the SM to cover the wait.)
// - Sums are kept as exact as the Pallas kernel's Kahan-compensated
//   grid: every lane keeps Kahan-compensated f32 partials of grad over
//   the rows its warp visits, and of loss, sum(mult) and sum(w). Each
//   CTA then folds its warps, in a fixed order, in double, and writes
//   one partial row [grad(d), loss, sum(mult), sum(w)] as doubles to a
//   scratch buffer the wrapper allocates. A second kernel sums those
//   rows column by column in CTA order, in double, and rounds once to
//   f32. No atomics: two launches on the same inputs are bitwise equal.
//   sum(w) is exact for n < 2^24 unit weights.
// - Ragged edges are masked in the kernel: no padded copy of X is made
//   and d need not be a multiple of anything. A slot is one vector load:
//   16 bytes (4 f32, 8 bf16) or, for e4m3, 8 bytes (8 codes), so that a
//   lane holds the same E elements in every dtype. Vector loads are used
//   when the row start is slot-aligned (d*sizeof(T) % slot == 0 and an
//   aligned base); otherwise, and for the tail of every row, elements
//   are loaded one at a time.
// - Limit: a lane holds E = 8*ceil(d/256) elements of its row in
//   registers (with two f32 accumulators each), and E is at most 64,
//   so d <= 2048 in every dtype. The wrapper raises beyond that.
//
// Plain C interface (loaded with ctypes): every entry point returns a
// cudaError_t, 0 on success.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxE = 64;  // elements of a row one lane holds, at most

enum Link { kLogistic = 0, kSquared = 1 };

// One slot: the raw bits of one vector load and the elements it holds.
template <typename T>
struct Slot;
template <>
struct Slot<float> {
  using Raw = uint4;
  static constexpr int V = 4;
};
template <>
struct Slot<__nv_bfloat16> {
  using Raw = uint4;
  static constexpr int V = 8;
};
template <>
struct Slot<__nv_fp8_e4m3> {
  using Raw = uint2;  // 8 codes: the same 8 elements a lane slot of bf16 has
  static constexpr int V = 8;
};

// The slot of a row starting at column col, as raw bits; zero past d.
// One vector load when the slot is whole and aligned, else element by
// element.
template <typename T>
__device__ __forceinline__ typename Slot<T>::Raw load_raw(
    const T* __restrict__ row, int col, int d, bool vec_ok);

template <>
__device__ __forceinline__ uint4 load_raw<float>(const float* __restrict__ row,
                                                 int col, int d, bool vec_ok) {
  if (vec_ok && col + 4 <= d)
    return __ldcs(reinterpret_cast<const uint4*>(row + col));
  uint32_t u[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    u[i] = (col + i < d) ? __float_as_uint(row[col + i]) : 0u;
  return make_uint4(u[0], u[1], u[2], u[3]);
}

template <>
__device__ __forceinline__ uint4 load_raw<__nv_bfloat16>(
    const __nv_bfloat16* __restrict__ row, int col, int d, bool vec_ok) {
  if (vec_ok && col + 8 <= d)
    return __ldcs(reinterpret_cast<const uint4*>(row + col));
  uint32_t u[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t lo = (col + 2 * i < d)
        ? (uint32_t)__bfloat16_as_ushort(row[col + 2 * i]) : 0u;
    const uint32_t hi = (col + 2 * i + 1 < d)
        ? (uint32_t)__bfloat16_as_ushort(row[col + 2 * i + 1]) : 0u;
    u[i] = lo | (hi << 16);
  }
  return make_uint4(u[0], u[1], u[2], u[3]);
}

template <>
__device__ __forceinline__ uint2 load_raw<__nv_fp8_e4m3>(
    const __nv_fp8_e4m3* __restrict__ row, int col, int d, bool vec_ok) {
  const uint8_t* p = reinterpret_cast<const uint8_t*>(row);
  if (vec_ok && col + 8 <= d)
    return __ldcs(reinterpret_cast<const uint2*>(p + col));
  uint32_t u[2] = {0u, 0u};
#pragma unroll
  for (int i = 0; i < 8; ++i)
    if (col + i < d) u[i >> 2] |= (uint32_t)p[col + i] << (8 * (i & 3));
  return make_uint2(u[0], u[1]);
}

// The raw bits of a slot as f32 values (a bf16 is the top half of an f32).
template <typename T>
__device__ __forceinline__ void unpack(const typename Slot<T>::Raw& raw,
                                       float* out);

template <>
__device__ __forceinline__ void unpack<float>(const uint4& raw, float* out) {
  out[0] = __uint_as_float(raw.x);
  out[1] = __uint_as_float(raw.y);
  out[2] = __uint_as_float(raw.z);
  out[3] = __uint_as_float(raw.w);
}

template <>
__device__ __forceinline__ void unpack<__nv_bfloat16>(const uint4& raw,
                                                      float* out) {
  const uint32_t u[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    out[2 * i] = __uint_as_float(u[i] << 16);
    out[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}

// e4m3 codes, lowest byte first: two at a time through the hardware
// conversion to an f16 pair (exact), then to f32.
template <>
__device__ __forceinline__ void unpack<__nv_fp8_e4m3>(const uint2& raw,
                                                      float* out) {
  const uint32_t u[2] = {raw.x, raw.y};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const __nv_fp8x2_storage_t pair =
          (__nv_fp8x2_storage_t)((u[i] >> (16 * h)) & 0xffffu);
      const float2 f =
          __half22float2(__half2(__nv_cvt_fp8x2_to_halfraw2(pair, __NV_E4M3)));
      out[4 * i + 2 * h] = f.x;
      out[4 * i + 2 * h + 1] = f.y;
    }
  }
}

// Kahan step: s + c_lost is the running sum; the true sum is s - c.
__device__ __forceinline__ void kahan_add(float& s, float& c, float v) {
  const float y = v - c;
  const float t = s + y;
  c = (t - s) - y;
  s = t;
}

template <int LINK>
__device__ __forceinline__ void link_eval(float m, float y, float w, float ys,
                                          float& mult, float& loss) {
  if (LINK == kLogistic) {
    const float e = expf(-fabsf(m));               // in (0, 1]
    const float sig = (m >= 0.0f) ? 1.0f / (1.0f + e) : e / (1.0f + e);
    const float softplus = fmaxf(m, 0.0f) + log1pf(e);
    mult = w * (sig - y);
    loss = w * (softplus - y * m);
  } else {  // squared: the least-squares residual
    const float err = m - ys * y;
    mult = w * err;
    loss = 0.5f * w * err * err;
  }
}

// scalars = [off, ys]; partials: gridDim.x rows of (d + 3) doubles.
template <typename T, int E, int LINK>
__global__ void __launch_bounds__(kThreads)
    glm_sweep_kernel(const T* __restrict__ x, const float* __restrict__ y,
                     const float* __restrict__ w,
                     const float* __restrict__ beta,
                     const float* __restrict__ scalars, long long n, int d,
                     int vec_ok, double* __restrict__ partials) {
  using Raw = typename Slot<T>::Raw;
  constexpr int V = Slot<T>::V;
  constexpr int kSlots = E / V;   // vector-load slots per lane
  constexpr int kWidth = 32 * E;  // padded row width this instance holds
  __shared__ float s_beta[kWidth];
  __shared__ double s_red[kWidth + 3];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int j = threadIdx.x; j < kWidth; j += kThreads)
    s_beta[j] = (j < d) ? beta[j] : 0.0f;
  const float off = scalars[0];
  const float ys = scalars[1];
  __syncthreads();

  float acc[E], comp[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    acc[e] = 0.0f;
    comp[e] = 0.0f;
  }
  float loss_s = 0.0f, loss_c = 0.0f;
  float mult_s = 0.0f, mult_c = 0.0f;
  float w_s = 0.0f, w_c = 0.0f;

  const long long n_warps = (long long)gridDim.x * kWarps;
  long long r = (long long)blockIdx.x * kWarps + warp;
  // the next row's slots, y and w are in flight while this row computes
  Raw nxt[kSlots];
  float y_nxt = 0.0f, w_nxt = 0.0f;
  if (r < n) {
#pragma unroll
    for (int k = 0; k < kSlots; ++k)
      nxt[k] = load_raw<T>(x + r * (long long)d, (k * 32 + lane) * V, d,
                           vec_ok != 0);
    y_nxt = __ldg(y + r);
    w_nxt = __ldg(w + r);
  }
  for (; r < n; r += n_warps) {
    Raw cur[kSlots];
#pragma unroll
    for (int k = 0; k < kSlots; ++k) cur[k] = nxt[k];
    const float yr = y_nxt, wr = w_nxt;
    const long long rn = r + n_warps;
    if (rn < n) {
#pragma unroll
      for (int k = 0; k < kSlots; ++k)
        nxt[k] = load_raw<T>(x + rn * (long long)d, (k * 32 + lane) * V, d,
                             vec_ok != 0);
      y_nxt = __ldg(y + rn);
      w_nxt = __ldg(w + rn);
    }
    float xv[E];
    float part = 0.0f;
#pragma unroll
    for (int k = 0; k < kSlots; ++k) {
      const int col = (k * 32 + lane) * V;
      unpack<T>(cur[k], xv + k * V);
#pragma unroll
      for (int i = 0; i < V; ++i)
        part = fmaf(xv[k * V + i], s_beta[col + i], part);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      part += __shfl_xor_sync(0xffffffffu, part, o);
    float mult, loss;
    link_eval<LINK>(part + off, yr, wr, ys, mult, loss);
    kahan_add(loss_s, loss_c, loss);
    kahan_add(mult_s, mult_c, mult);
    kahan_add(w_s, w_c, wr);
#pragma unroll
    for (int e = 0; e < E; ++e) kahan_add(acc[e], comp[e], mult * xv[e]);
  }

  // fold the warps into one CTA partial, in warp order, in double
  for (int wi = 0; wi < kWarps; ++wi) {
    if (warp == wi) {
#pragma unroll
      for (int k = 0; k < kSlots; ++k) {
#pragma unroll
        for (int i = 0; i < V; ++i) {
          const int j = (k * 32 + lane) * V + i;
          const double v = (double)acc[k * V + i] - (double)comp[k * V + i];
          s_red[j] = (wi == 0) ? v : s_red[j] + v;
        }
      }
      if (lane == 0) {
        const double t[3] = {(double)loss_s - (double)loss_c,
                             (double)mult_s - (double)mult_c,
                             (double)w_s - (double)w_c};
#pragma unroll
        for (int i = 0; i < 3; ++i)
          s_red[kWidth + i] = (wi == 0) ? t[i] : s_red[kWidth + i] + t[i];
      }
    }
    __syncthreads();
  }
  double* out = partials + (long long)blockIdx.x * (d + 3);
  for (int j = threadIdx.x; j < d; j += kThreads) out[j] = s_red[j];
  if (threadIdx.x < 3) out[d + threadIdx.x] = s_red[kWidth + threadIdx.x];
}

// out[j] = sum over CTAs c, in order, of partials[c][j]; rounded to f32.
__global__ void glm_reduce_kernel(const double* __restrict__ partials,
                                  int n_parts, int width,
                                  float* __restrict__ out) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= width) return;
  double s = 0.0;
  for (int c = 0; c < n_parts; ++c) s += partials[(long long)c * width + j];
  out[j] = (float)s;
}

using KernelFn = const void*;  // a glm_sweep_kernel instance

// E rounded up to a multiple of 8 covers every slot width (4 f32, 8 bf16,
// 8 e4m3).
int elems_per_lane(int d) { return ((d + 255) / 256) * 8; }

template <typename T, int LINK>
KernelFn pick_kernel(int e) {
#define CYCLONE_GLM_CASE(E)                                               \
  case E:                                                                 \
    return reinterpret_cast<KernelFn>(&glm_sweep_kernel<T, E, LINK>);
  switch (e) {
    CYCLONE_GLM_CASE(8)
    CYCLONE_GLM_CASE(16)
    CYCLONE_GLM_CASE(24)
    CYCLONE_GLM_CASE(32)
    CYCLONE_GLM_CASE(40)
    CYCLONE_GLM_CASE(48)
    CYCLONE_GLM_CASE(56)
    CYCLONE_GLM_CASE(64)
    default:
      return nullptr;
  }
#undef CYCLONE_GLM_CASE
}

template <typename T>
KernelFn pick_link(int link, int e) {
  if (link == kLogistic) return pick_kernel<T, kLogistic>(e);
  if (link == kSquared) return pick_kernel<T, kSquared>(e);
  return nullptr;
}

KernelFn kernel_for(int dtype, int link, int d) {
  if (d < 1) return nullptr;
  const int e = elems_per_lane(d);
  if (e > kMaxE) return nullptr;
  if (dtype == 0) return pick_link<float>(link, e);
  if (dtype == 1) return pick_link<__nv_bfloat16>(link, e);
  if (dtype == 2) return pick_link<__nv_fp8_e4m3>(link, e);
  return nullptr;
}

}  // namespace

extern "C" {

// Largest d the kernel takes.
int glm_sweep_max_d() { return 32 * kMaxE; }

// CTAs (= partial rows) a sweep of n rows uses on the current device.
// dtype: 0 = float32 X, 1 = bfloat16 X, 2 = float8_e4m3fn codes;
// link: 0 = logistic, 1 = squared.
int glm_sweep_num_parts(int dtype, int link, int d, long long n,
                        int* n_parts) {
  KernelFn k = kernel_for(dtype, link, d);
  if (k == nullptr) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, k, kThreads, 0);
  if (err != cudaSuccess) return (int)err;
  long long parts = (long long)sms * (per_sm > 0 ? per_sm : 1);
  // at least a few rows per warp, and at least one CTA
  const long long by_rows = (n + 4 * kWarps - 1) / (4 * kWarps);
  if (by_rows < parts) parts = by_rows;
  if (parts < 1) parts = 1;
  *n_parts = (int)parts;
  return 0;
}

// One sweep. x: (n, d) row-major at storage width; y, w: (n,) f32;
// beta: (d,) f32; scalars: [off, ys] f32 on the device (ys is read by the
// squared link only); partials: n_parts * (d + 3) doubles of scratch;
// out: d + 3 floats, written as [grad(d), loss, sum(mult), sum(w)].
int glm_sweep_launch(int dtype, int link, const void* x, const float* y,
                     const float* w, const float* beta, const float* scalars,
                     long long n, int d, double* partials, int n_parts,
                     float* out, void* stream) {
  KernelFn k = kernel_for(dtype, link, d);
  if (k == nullptr || n_parts < 1 || n < 0) return (int)cudaErrorInvalidValue;
  // bytes per element and per vector load of the instance kernel_for chose
  const size_t item = (dtype == 0) ? sizeof(float)
                      : (dtype == 1) ? sizeof(__nv_bfloat16)
                                     : sizeof(__nv_fp8_e4m3);
  const size_t slot = (dtype == 2) ? sizeof(uint2) : sizeof(uint4);
  const int vec_ok = ((reinterpret_cast<uintptr_t>(x) % slot) == 0) &&
                     (((size_t)d * item) % slot == 0);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  // the instance's X parameter is const T*; a pointer argument of the
  // same width is passed through the untyped launch
  void* args[] = {const_cast<void**>(&x), &y,  &w,      &beta,    &scalars,
                  &n,                     &d,  (void*)&vec_ok, &partials};
  cudaError_t err = cudaLaunchKernel(k, dim3(n_parts), dim3(kThreads), args,
                                     0, s);
  if (err == cudaSuccess) err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int width = d + 3;
  glm_reduce_kernel<<<(width + 255) / 256, 256, 0, s>>>(partials, n_parts,
                                                        width, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
