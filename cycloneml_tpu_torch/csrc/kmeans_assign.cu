// Nearest-center assignment for Hopper (sm_90a): for every row of X, the
// index of its nearest center and the squared distance to it.
//
// Replaces cycloneml_tpu/ops/kernels.py:fused_kmeans_assign (the Pallas
// kernel behind KMeans' Lloyd steps). Per row r and center c:
//   d2[r, c] = (|x_r|^2 - 2 x_r . c_c) + |c_c|^2   (the reference's expansion)
//   best[r]  = the first c with the least d2 (ties go to the lowest index,
//              as jnp.argmin breaks them)
//   dist[r]  = max(d2[r, best[r]], 0)
// |c|^2 comes from the wrapper, computed once per call; |x_r|^2 is summed
// here. Centers are float32 in value space; X is float32, bfloat16 or
// float8_e4m3fn codes (the fp8 rung), upcast on load. The fp8 rung's
// per-column scale (the reference's x_scale operand, kernels.py:422, null
// for no scale) multiplies every element as it is staged, before it enters
// shared memory and before |x_r|^2, so every distance is one of the scaled
// row x~ = upcast(x) o s, as the reference's is.
//
// Bound: operations. The products are 2 n k d flops, and they must be full
// float32: the reference runs them at Precision.HIGHEST because near-tie
// argmins flip at ~1e-4 relative distance at lower precision, so neither
// TF32 nor a bf16 tensor-core product is allowed. At n=10M, d=128, k=1000
// that is 2.56 TFLOP, at least 38 ms at 67 TFLOP/s; X itself (2.56 GB in
// bf16) needs 0.76 ms of memory time.
//
// Design, and what it does about the bound:
// - A CTA of 256 threads owns 128 rows and walks over ALL centers in tiles
//   of 128, so any k works, and a row's running minimum never leaves the
//   registers: no (n, k) distance matrix, no reduction across CTAs, and
//   two launches on the same inputs are bitwise equal.
// - The product is a register-blocked float32 FMA tile: each thread
//   computes 8 rows x 8 centers from 16-feature stages of X and of the
//   centers held transposed in shared memory, so every 16-byte shared
//   load feeds 16 FMAs. Rows and centers of a thread are strided by 64 so
//   that a quarter warp's float4 loads hit distinct banks. The k edge is
//   masked (centers past k are never compared), not padded.
// - Sums run in a fixed order (features in order), the epilogue compares
//   centers in ascending order with a strict '<', and the 16 threads that
//   share rows combine (value, index) pairs lexicographically, so the
//   lowest index wins every tie.
// - Not done here (later work): wgmma/TMA, keeping the X tile resident
//   across center tiles (it is re-staged from L2 per center tile), double
//   buffering beyond the two CTAs per SM that cover each other's loads.
//
// Plain C interface (loaded with ctypes): every entry point returns a
// cudaError_t, 0 on success.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 128;     // rows of X a CTA owns
constexpr int kCenters = 128;  // centers per shared-memory tile
constexpr int kChunk = 16;     // features per stage
constexpr int kStride = 132;   // padded row of a transposed stage

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
// the hardware conversion e4m3 -> f16 (exact), then f16 -> f32
__device__ __forceinline__ float to_f32(__nv_fp8_e4m3 v) {
  return __half2float(__half(__nv_cvt_fp8_to_halfraw(v.__x, __NV_E4M3)));
}

// element f of a row, upcast and scaled (scale is null for no scale)
template <typename T>
__device__ __forceinline__ float value(const T* __restrict__ xr, int f,
                                       const float* __restrict__ scale) {
  const float v = to_f32(xr[f]);
  return scale == nullptr ? v : v * __ldg(scale + f);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
    kmeans_assign_kernel(const T* __restrict__ x,
                         const float* __restrict__ centers,
                         const float* __restrict__ c_norm,
                         const float* __restrict__ scale, long long n,
                         int d, int k, int* __restrict__ best,
                         float* __restrict__ dist) {
  __shared__ __align__(16) float xs[kChunk][kStride];
  __shared__ __align__(16) float cs[kChunk][kStride];
  __shared__ float x2s[kRows];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int tx = tid & 15;  // centers tx*4 + j and 64 + tx*4 + j
  const int ty = tid >> 4;  // rows ty*4 + i and 64 + ty*4 + i
  const long long row0 = (long long)blockIdx.x * kRows;

  // |x_r|^2: one warp per row, lanes strided over the features, folded
  // by xor shuffles in a fixed order
  for (int r = warp; r < kRows; r += kThreads / 32) {
    const long long gr = row0 + r;
    float s = 0.0f;
    if (gr < n) {
      const T* xr = x + gr * (long long)d;
      for (int f = lane; f < d; f += 32) {
        const float v = value(xr, f, scale);
        s = fmaf(v, v, s);
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) x2s[r] = s;
  }

  float best_v[8];
  int best_i[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    best_v[i] = INFINITY;
    best_i[i] = 0;
  }

  // stage loads: feature f = tid % 16 of rows (or centers) tid / 16 + 16 m
  const int lf = tid & 15;
  const int lr = tid >> 4;

  for (int c0 = 0; c0 < k; c0 += kCenters) {
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

    for (int f0 = 0; f0 < d; f0 += kChunk) {
      const int f = f0 + lf;
      __syncthreads();  // the previous stage is consumed
#pragma unroll
      for (int m = 0; m < kRows / 16; ++m) {
        const int r = lr + 16 * m;
        const long long gr = row0 + r;
        xs[lf][r] = (gr < n && f < d) ? value(x + gr * (long long)d, f, scale)
                                      : 0.0f;
        const int c = c0 + r;
        cs[lf][r] = (c < k && f < d) ? centers[(long long)c * d + f] : 0.0f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kChunk; ++kk) {
        const float4 a0 = *reinterpret_cast<const float4*>(&xs[kk][ty * 4]);
        const float4 a1 =
            *reinterpret_cast<const float4*>(&xs[kk][64 + ty * 4]);
        const float4 b0 = *reinterpret_cast<const float4*>(&cs[kk][tx * 4]);
        const float4 b1 =
            *reinterpret_cast<const float4*>(&cs[kk][64 + tx * 4]);
        const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }

    // epilogue of this center tile: centers in ascending order, strict '<'
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = (i < 4) ? ty * 4 + i : 64 + ty * 4 + (i - 4);
      const float xx = x2s[r];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = c0 + ((j < 4) ? tx * 4 + j : 64 + tx * 4 + (j - 4));
        if (c < k) {
          const float v = (xx - 2.0f * acc[i][j]) + __ldg(c_norm + c);
          if (v < best_v[i]) {
            best_v[i] = v;
            best_i[i] = c;
          }
        }
      }
    }
  }

  // combine the 16 threads (one half warp) that share these rows
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float v = best_v[i];
    int bi = best_i[i];
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, v, o);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
      if (ov < v || (ov == v && oi < bi)) {
        v = ov;
        bi = oi;
      }
    }
    const int r = (i < 4) ? ty * 4 + i : 64 + ty * 4 + (i - 4);
    const long long gr = row0 + r;
    if (tx == 0 && gr < n) {
      best[gr] = bi;
      dist[gr] = fmaxf(v, 0.0f);
    }
  }
}

}  // namespace

extern "C" {

// One assignment pass. dtype: 0 = float32 X, 1 = bfloat16 X, 2 =
// float8_e4m3fn codes. x: (n, d) row-major; centers: (k, d) float32
// row-major; c_norm: (k,) float32 |c|^2; scale: (d,) float32 per-column
// dequantization, or null; best: (n,) int32 out; dist: (n,) float32 out.
int kmeans_assign_launch(int dtype, const void* x, const float* centers,
                         const float* c_norm, const float* scale, long long n,
                         int d, int k, int* best, float* dist, void* stream) {
  if (n < 0 || d < 1 || k < 1) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const long long blocks = (n + kRows - 1) / kRows;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    kmeans_assign_kernel<float><<<(unsigned)blocks, kThreads, 0, s>>>(
        static_cast<const float*>(x), centers, c_norm, scale, n, d, k, best,
        dist);
  } else if (dtype == 1) {
    kmeans_assign_kernel<__nv_bfloat16><<<(unsigned)blocks, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), centers, c_norm, scale, n, d, k,
        best, dist);
  } else if (dtype == 2) {
    kmeans_assign_kernel<__nv_fp8_e4m3><<<(unsigned)blocks, kThreads, 0, s>>>(
        static_cast<const __nv_fp8_e4m3*>(x), centers, c_norm, scale, n, d, k,
        best, dist);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
