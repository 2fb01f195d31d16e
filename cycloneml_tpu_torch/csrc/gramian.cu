// Gramian X^T X for Hopper (sm_90a), with padding rows masked by weight.
//
// Replaces cycloneml_tpu/ops/kernels.py:fused_gramian (the Pallas kernel
// behind RowMatrix.compute_gramian, and through it covariance, principal
// components, the small-d SVD and PCA):
//   G = sum over rows r of (x~_r [w_r > 0])^T (x~_r [w_r > 0])
// in float32, from float32, bfloat16 or float8_e4m3fn X (upcast on load),
// where x~ = x o s with the fp8 rung's per-column scale s (the reference's
// x_scale operand, kernels.py:501; null for no scale).
//
// Bound: operations. The upper triangle is n d (d + 1) / 2 FMAs, n d (d + 1)
// flops. The reference runs them at Precision.HIGHEST, so they are full
// float32 FMAs here: at n=400k, d=2000 that is 1.6 TFLOP, at least 24 ms at
// 67 TFLOP/s; X (1.6 GB in bf16) needs 0.48 ms of memory time. (For bf16 X
// every product is exact in float32, so a bf16 tensor-core product with
// float32 sums would give the same products at ~15x the rate: later work.)
//
// Design, and what it does about the bound:
// - Only the upper-triangle 128 x 128 tiles of G are computed; the second
//   pass writes each sum to (i, j) and (j, i) from the same partials in
//   the same order, so G == G^T bitwise.
// - The rows are split across CTAs (grid = tiles x splits, enough CTAs to
//   fill the card even when d is small). Each CTA keeps a register-blocked
//   float32 FMA tile (8 x 8 per thread, 256 threads) and stages 16 rows of
//   its two column blocks in shared memory per step.
// - Float32 sums stay short: every 1024 rows a CTA folds its register tile
//   into its own 128 x 128 partial, kept in double in a scratch buffer, and
//   restarts from zero. A float32 running sum over ~100k rows of squares
//   drifts upward (once the sum is large, small squares round unevenly);
//   unfolded, that bias reached the diagonal, and through the trace, PCA's
//   explained variance (chip_smoke.py prints the trace's error). Shorter
//   folds cost more time for less drift. A second kernel sums the partials
//   of each element in split order, in double, and rounds once. No
//   atomics: two launches are bitwise equal.
// - The mask w > 0 is applied as rows are staged: a masked row is staged as
//   zeros, with no masked copy of X. A null w masks nothing.
// - Ragged d and n are masked in the loads; nothing is padded in memory.
// - The scale is applied once per element of G, in the double reduction
//   pass: G_ij = s_i s_j sum_r x_ri x_rj. The main pass sums the raw
//   (upcast) values, so its instances are the same for every scale, and
//   for e4m3 codes every product is exact in float32 (4-bit significands).
//   The reduction multiplies the sum of element (min, max) by s_min s_max,
//   so G stays exactly symmetric and launches stay bitwise equal.
// - Not done here (later work): wgmma/TMA, bf16 tensor cores, double
//   buffering beyond the two CTAs per SM that cover each other's loads.
//
// Plain C interface (loaded with ctypes): every entry point returns a
// cudaError_t, 0 on success.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 128;   // rows and columns of a tile of G
constexpr int kChunk = 16;   // rows of X per stage
constexpr int kStride = 132; // padded stage row (keeps float4 alignment)
constexpr int kFoldRows = 1024;  // rows summed in float32 between folds
constexpr int kTileElems = kTile * kTile;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
// the hardware conversion e4m3 -> f16 (exact), then f16 -> f32
__device__ __forceinline__ float to_f32(__nv_fp8_e4m3 v) {
  return __half2float(__half(__nv_cvt_fp8_to_halfraw(v.__x, __NV_E4M3)));
}

__host__ __device__ inline int tiles_per_side(int d) {
  return (d + kTile - 1) / kTile;
}

// (ti, tj), ti <= tj, of upper-triangle tile t in row-major order
__device__ __forceinline__ void tile_coords(int t, int side, int& ti,
                                            int& tj) {
  ti = 0;
  while (t >= side - ti) {
    t -= side - ti;
    ++ti;
  }
  tj = ti + t;
}

__device__ __forceinline__ int tile_index(int ti, int tj, int side) {
  // tiles before row ti: side + (side - 1) + ... + (side - ti + 1)
  return ti * side - ti * (ti - 1) / 2 + (tj - ti);
}

// grid: (tiles, splits); partials: splits * tiles * 128 * 128 doubles
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
    gramian_kernel(const T* __restrict__ x, const float* __restrict__ w,
                   long long n, int d, long long rows_per_split,
                   double* __restrict__ partials) {
  __shared__ __align__(16) float as[kChunk][kStride];
  __shared__ __align__(16) float bs[kChunk][kStride];

  const int side = tiles_per_side(d);
  int ti, tj;
  tile_coords(blockIdx.x, side, ti, tj);
  const int tid = threadIdx.x;
  const int tx = tid & 15;  // columns tx*4 + j and 64 + tx*4 + j of tile j
  const int ty = tid >> 4;  // columns ty*4 + i and 64 + ty*4 + i of tile i
  const long long r_begin = (long long)blockIdx.y * rows_per_split;
  long long r_end = r_begin + rows_per_split;
  if (r_end > n) r_end = n;

  // stage loads: column tid % 128 of rows tid / 128 + 2 m
  const int lc = tid & (kTile - 1);
  const int lr = tid >> 7;
  const int ca = ti * kTile + lc;
  const int cb = tj * kTile + lc;

  double* out = partials +
                ((long long)blockIdx.y * gridDim.x + blockIdx.x) * kTileElems;
  float acc[8][8];
  bool first = true;
  for (long long f0 = r_begin; f0 < r_end || first; f0 += kFoldRows) {
    long long f_end = f0 + kFoldRows;
    if (f_end > r_end) f_end = r_end;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

    for (long long r0 = f0; r0 < f_end; r0 += kChunk) {
      __syncthreads();  // the previous stage is consumed
#pragma unroll
      for (int m = 0; m < kChunk / 2; ++m) {
        const int rr = lr + 2 * m;
        const long long r = r0 + rr;
        const bool live =
            r < f_end && (w == nullptr || __ldg(w + r) > 0.0f);
        const T* xr = x + r * (long long)d;
        as[rr][lc] = (live && ca < d) ? to_f32(xr[ca]) : 0.0f;
        bs[rr][lc] = (live && cb < d) ? to_f32(xr[cb]) : 0.0f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kChunk; ++kk) {
        const float4 a0 = *reinterpret_cast<const float4*>(&as[kk][ty * 4]);
        const float4 a1 =
            *reinterpret_cast<const float4*>(&as[kk][64 + ty * 4]);
        const float4 b0 = *reinterpret_cast<const float4*>(&bs[kk][tx * 4]);
        const float4 b1 =
            *reinterpret_cast<const float4*>(&bs[kk][64 + tx * 4]);
        const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j)
            acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }

    // fold into this CTA's own partial (no other thread touches these)
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int li = (i < 4) ? ty * 4 + i : 64 + ty * 4 + (i - 4);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int lj = (j < 4) ? tx * 4 + j : 64 + tx * 4 + (j - 4);
        double* p = out + li * kTile + lj;
        *p = first ? (double)acc[i][j] : *p + (double)acc[i][j];
      }
    }
    first = false;
  }
}

// g[r][c] = sum over splits s, in order, of the partial of element
// (min(r, c), max(r, c)), times scale[min] scale[max] when a scale is
// given; rounded once to float32
__global__ void gramian_reduce_kernel(const double* __restrict__ partials,
                                      const float* __restrict__ scale,
                                      int splits, int tiles, int d,
                                      float* __restrict__ g) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (long long)d * d) return;
  const int r = (int)(e / d);
  const int c = (int)(e % d);
  const int lo = r < c ? r : c;
  const int hi = r < c ? c : r;
  const int side = tiles_per_side(d);
  const long long off =
      (long long)tile_index(lo / kTile, hi / kTile, side) * kTileElems +
      (lo % kTile) * kTile + (hi % kTile);
  double s = 0.0;
  for (int p = 0; p < splits; ++p)
    s += partials[(long long)p * tiles * kTileElems + off];
  if (scale != nullptr) s *= (double)scale[lo] * (double)scale[hi];
  g[e] = (float)s;
}

}  // namespace

extern "C" {

// Upper-triangle tiles of a (d, d) Gramian and the row splits a pass over
// n rows uses on the current device; the scratch the caller allocates is
// splits * tiles * 128 * 128 doubles.
int gramian_plan(int d, long long n, int* tiles, int* splits) {
  if (d < 1 || n < 0) return (int)cudaErrorInvalidValue;
  const int side = tiles_per_side(d);
  const int t = side * (side + 1) / 2;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  // about four CTAs per SM in all, and at least 16 stages of rows each
  long long s = (4LL * sms + t - 1) / t;
  const long long by_rows = (n + 16 * kChunk - 1) / (16 * kChunk);
  if (s > by_rows) s = by_rows;
  if (s < 1) s = 1;
  if (s > 65535) s = 65535;
  *tiles = t;
  *splits = (int)s;
  return 0;
}

// One Gramian. dtype: 0 = float32 X, 1 = bfloat16 X, 2 = float8_e4m3fn
// codes. x: (n, d) row-major; w: (n,) float32 or null; scale: (d,) float32
// per-column dequantization, or null; partials: scratch of gramian_plan's
// size; g: (d, d) float32 out.
int gramian_launch(int dtype, const void* x, const float* w,
                   const float* scale, long long n, int d, int tiles,
                   int splits, double* partials, float* g, void* stream) {
  const int side = tiles_per_side(d);
  if (d < 1 || n < 0 || splits < 1 || tiles != side * (side + 1) / 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  long long per = (n + splits - 1) / splits;
  per = ((per + kChunk - 1) / kChunk) * kChunk;
  const dim3 grid(tiles, splits);
  if (dtype == 0) {
    gramian_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), w, n, d, per, partials);
  } else if (dtype == 1) {
    gramian_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), w, n, d, per, partials);
  } else if (dtype == 2) {
    gramian_kernel<__nv_fp8_e4m3><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_fp8_e4m3*>(x), w, n, d, per, partials);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long elems = (long long)d * d;
  const long long blocks = (elems + 255) / 256;
  gramian_reduce_kernel<<<(unsigned)blocks, 256, 0, s>>>(partials, scale,
                                                        splits, tiles, d, g);
  return (int)cudaGetLastError();
}

}  // extern "C"
