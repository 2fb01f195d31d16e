// Stacked GLM row sweep for Hopper (sm_90a): the logistic sweep of K1 for
// K binomial models over ONE shared X, in one pass over X.
//
// Replaces the batched form of cycloneml_tpu/ops/kernels.py:_run_glm (the
// Pallas kernel behind fused_binary_logistic_scaled, kernels.py:176) that
// jax.vmap makes when aggregators.stack_scaled_aggregator
// (cycloneml_tpu/ml/optim/aggregators.py:394) maps it over a model axis:
// X is shared, the labels and coefficients carry the model axis. Per row r
// and model k:
//   margin_rk = x_r . B_k + off_k
//   mult_rk   = w_r (sigmoid(margin_rk) - y_rk)
//   loss_k   += w_r (softplus(margin_rk) - y_rk margin_rk)
//   grad_k   += mult_rk x_r,   msum_k += mult_rk,   wsum += w_r
// The wrapper folds standardization and the fp8 rung's x_scale into the
// (K, d) matrix B and the (K,) offsets, as K1's wrapper folds them into its
// (d,) vectors, so X is read raw at its storage width (float32, bfloat16 or
// float8_e4m3fn codes).
//
// Bound: bytes for small K, operations for large K. X is read once per
// sweep for all K models (n*d bytes in e4m3, 2n*d in bf16, 4n*d in f32)
// plus the (n, K) labels; the arithmetic is 2*n*d*K FMAs (margins and
// gradient). At n=2M, d=1280 in bf16 that is 5.12 GB (1.53 ms at an
// H100 SXM's 3.35 TB/s) against 41 GFMA at K=16 (2.45 ms at its 67 TFLOP/s
// of f32 FMAs; data-sheet rates, not measurements).
//
// Design (right and simple first; the tensor cores are a later step):
// - A CTA of 256 threads walks tiles of R consecutive rows (grid-stride).
//   Each tile is one contiguous stretch of X, copied into shared memory at
//   storage width by cp.async (16, 8 or 4 bytes a copy, whatever the row
//   width and base allow; element by element otherwise), the next tile's
//   copy in flight while this one computes (two stages where shared memory
//   allows). Rows past n are zero in shared memory and carry w = 0 and
//   y = 0, so they add exactly nothing.
// - Margins: warp w owns R/8 rows of the tile; lane l sums x_rj B_kj over
//   the columns j = l (mod 32) for its rows and all models, B (f32) in
//   shared memory, and xor shuffles finish the sums (every lane ends with
//   the same bits). Lane k then turns model k's margins into multipliers
//   (into shared memory) and keeps Kahan-compensated f32 sums of the loss
//   and sum(mult); lane 0 those of w.
// - Gradient by column: thread t owns the columns t, t+256, ... (C of
//   them, C = ceil(d/256) rounded up to even) and keeps one f32 sum per
//   column and model in registers, so X's tile is read from shared memory
//   once per row and column for all K models. Every 4,096 rows a thread
//   adds its f32 sums, in double, into its CTA's partial row in device
//   memory (only this thread ever touches those entries) and restarts
//   them, so no f32 sum runs over more than 4,096 rows.
// - A second kernel sums the partial rows column by column in CTA order,
//   in double, and rounds once to f32. No atomics: two launches on the
//   same inputs are bitwise equal. sum(w) is exact for n < 2^24 unit
//   weights per warp.
// - Limits: d <= 2048 (C <= 8, K1's limit too) and at most 16 models a
//   launch (K_MAX); the wrapper runs groups of at most 16 models, each one
//   launch and one more read of X. Instances: X's dtype x C in {2, 4, 6,
//   8} x the group's models rounded up to 4, 8 or 16.
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
constexpr int kWarps = kThreads / 32;
constexpr int kMaxModels = 16;   // K_MAX: models one launch sweeps
constexpr int kMaxCols = 8;      // columns a thread owns: d <= 2048
constexpr int kFlushRows = 4096; // rows an f32 gradient sum runs over
constexpr size_t kSmemLimit = 227 * 1024;

// Shared memory of an instance for d columns: S stages of R rows of X at
// storage width, B (KG x d f32), the labels, weights and multipliers of a
// tile, and the warps' loss/msum/w sums. Every section is 16-byte aligned.
__host__ __device__ constexpr size_t align16(size_t v) {
  return (v + 15) & ~(size_t)15;
}
__host__ __device__ constexpr size_t smem_bytes(size_t item, int S, int R,
                                                int KG, int d) {
  return S * align16((size_t)R * d * item)       // X tiles
         + align16((size_t)KG * d * 4)           // B
         + align16((size_t)KG * 4)               // offsets
         + 2 * align16((size_t)R * KG * 4)       // labels, multipliers
         + align16((size_t)R * 4)                // weights
         + (size_t)kWarps * (2 * KG + 1) * 8;    // warp sums (double)
}

// Rows per tile and stages of an instance, for its widest d (256*C): the
// most rows (32, 16 or 8) whose two stages fit, else one stage of 8.
template <typename T, int C, int KG>
struct Plan {
  static constexpr int kDMax = 256 * C;
  static constexpr bool fits(int S, int R) {
    return smem_bytes(sizeof(T), S, R, KG, kDMax) <= kSmemLimit;
  }
  static constexpr int kRows = fits(2, 32) ? 32 : fits(2, 16) ? 16 : 8;
  static constexpr int kStages = fits(2, kRows) ? 2 : 1;
  static_assert(fits(kStages, kRows), "instance does not fit shared memory");
};

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <>
__device__ __forceinline__ float to_f32<__nv_fp8_e4m3>(__nv_fp8_e4m3 v) {
  // every e4m3 value is an f16 value: exact
  return __half2float(__half(__nv_cvt_fp8_to_halfraw(v.__x, __NV_E4M3)));
}

// the raw bits of one element, for the element-by-element copy
template <typename T>
struct Raw;
template <>
struct Raw<float> {
  using U = uint32_t;
};
template <>
struct Raw<__nv_bfloat16> {
  using U = uint16_t;
};
template <>
struct Raw<__nv_fp8_e4m3> {
  using U = uint8_t;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src,
                                         int bytes) {
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
                 "l"(src)
                 : "memory");
  else if (bytes == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(dst),
                 "l"(src)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
                 "l"(src)
                 : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Kahan step: the true sum is s - c.
__device__ __forceinline__ void kahan_add(float& s, float& c, float v) {
  const float y = v - c;
  const float t = s + y;
  c = (t - s) - y;
  s = t;
}

// Tile `tile` of X (R rows from row tile*R) into shared memory at `dst`:
// cp.async of vec_bytes (16, 8 or 4) a copy, or element by element when
// vec_bytes is 0; bytes past row n are zeros.
template <typename T, int R>
__device__ __forceinline__ void copy_tile(const T* __restrict__ x,
                                          long long n, int d, long long tile,
                                          int vec_bytes, T* dst) {
  const long long r0 = tile * R;
  const long long rows = (n - r0 < R) ? (n - r0) : R;
  const size_t tile_bytes = (size_t)R * d * sizeof(T);
  const size_t valid = (size_t)rows * d * sizeof(T);
  const char* src = reinterpret_cast<const char*>(x + r0 * (long long)d);
  char* out = reinterpret_cast<char*>(dst);
  if (vec_bytes > 0) {
    for (size_t b = (size_t)threadIdx.x * vec_bytes; b < tile_bytes;
         b += (size_t)kThreads * vec_bytes) {
      if (b < valid) {
        cp_async(smem_u32(out + b), src + b, vec_bytes);
      } else if (vec_bytes == 16) {
        *reinterpret_cast<uint4*>(out + b) = make_uint4(0u, 0u, 0u, 0u);
      } else if (vec_bytes == 8) {
        *reinterpret_cast<uint2*>(out + b) = make_uint2(0u, 0u);
      } else {
        *reinterpret_cast<uint32_t*>(out + b) = 0u;
      }
    }
  } else {
    using U = typename Raw<T>::U;
    const U* s = reinterpret_cast<const U*>(src);
    U* o = reinterpret_cast<U*>(out);
    const size_t n_el = (size_t)R * d, n_valid = (size_t)rows * d;
    for (size_t e = threadIdx.x; e < n_el; e += kThreads)
      o[e] = (e < n_valid) ? s[e] : (U)0;
  }
}

// Labels (f32 or bf16, row stride ldy, already offset to the group's
// first model) and weights of tile `tile` into registers: element
// i = threadIdx.x + 256*q of the (R, KG) label tile, and w of row
// threadIdx.x for the first R threads. Zero past n and past kg.
template <int R, int KG>
struct TileLabels {
  static constexpr int kPer = (R * KG + kThreads - 1) / kThreads;
  float y[kPer];
  float w;
  __device__ __forceinline__ void load(const void* __restrict__ yp,
                                       int y_bf16, long long ldy,
                                       const float* __restrict__ wp,
                                       long long n, int kg, long long tile) {
    const long long r0 = tile * R;
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      const int i = threadIdx.x + kThreads * q;
      const int r = i / KG, k = i % KG;
      float v = 0.0f;
      if (i < R * KG && k < kg && r0 + r < n) {
        const long long at = (r0 + r) * ldy + k;
        v = y_bf16 ? __bfloat162float(
                         reinterpret_cast<const __nv_bfloat16*>(yp)[at])
                   : reinterpret_cast<const float*>(yp)[at];
      }
      y[q] = v;
    }
    const long long r = r0 + threadIdx.x;
    w = (threadIdx.x < R && r < n) ? __ldg(wp + r) : 0.0f;
  }
  __device__ __forceinline__ void store(float* s_y, float* s_w) const {
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      const int i = threadIdx.x + kThreads * q;
      if (i < R * KG) s_y[i] = y[q];
    }
    if (threadIdx.x < R) s_w[threadIdx.x] = w;
  }
};

// Adds thread threadIdx.x's f32 column sums, in double, into its CTA's
// partial row (the first flush writes it) and restarts them.
template <int C, int KG>
__device__ __forceinline__ void flush(float (&acc)[C][KG],
                                      double* __restrict__ part, int d,
                                      int kg, bool& flushed) {
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int col = threadIdx.x + kThreads * c;
    if (col < d) {
#pragma unroll
      for (int k = 0; k < KG; ++k) {
        if (k < kg) {
          double* at = part + (long long)k * (d + 2) + col;
          *at = (flushed ? *at : 0.0) + (double)acc[c][k];
        }
        acc[c][k] = 0.0f;
      }
    }
  }
  flushed = true;
}

// partials: gridDim.x rows of kg*(d+2)+1 doubles: per model k, grad (d),
// loss, msum at k*(d+2); then sum(w).
template <typename T, int C, int KG>
__global__ void __launch_bounds__(kThreads, 1)
    glm_stacked_kernel(const T* __restrict__ x, const void* __restrict__ y,
                       int y_bf16, long long ldy, const float* __restrict__ w,
                       const float* __restrict__ B,
                       const float* __restrict__ off, long long n, int d,
                       int kg, int vec_bytes, double* __restrict__ partials) {
  using P = Plan<T, C, KG>;
  constexpr int R = P::kRows;
  constexpr int S = P::kStages;
  constexpr int RW = R / kWarps;  // rows of a tile each warp owns
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* p = smem;
  T* s_x = reinterpret_cast<T*>(p);
  const size_t stage_bytes = align16((size_t)R * d * sizeof(T));
  p += S * stage_bytes;
  float* s_b = reinterpret_cast<float*>(p);
  p += align16((size_t)KG * d * 4);
  float* s_off = reinterpret_cast<float*>(p);
  p += align16((size_t)KG * 4);
  float* s_y = reinterpret_cast<float*>(p);
  p += align16((size_t)R * KG * 4);
  float* s_m = reinterpret_cast<float*>(p);
  p += align16((size_t)R * KG * 4);
  float* s_w = reinterpret_cast<float*>(p);
  p += align16((size_t)R * 4);
  double* s_red = reinterpret_cast<double*>(p);  // [warp][2*KG + 1]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long n_tiles = (n + R - 1) / R;
  const int width = kg * (d + 2) + 1;
  double* part = partials + (long long)blockIdx.x * width;

  for (int i = tid; i < KG * d; i += kThreads)
    s_b[i] = (i / d < kg) ? B[i] : 0.0f;
  if (tid < KG) s_off[tid] = (tid < kg) ? off[tid] : 0.0f;

  float acc[C][KG];
#pragma unroll
  for (int c = 0; c < C; ++c)
#pragma unroll
    for (int k = 0; k < KG; ++k) acc[c][k] = 0.0f;
  float loss_s = 0.0f, loss_c = 0.0f, mult_s = 0.0f, mult_c = 0.0f;
  float w_s = 0.0f, w_c = 0.0f;
  bool flushed = false;
  constexpr int kFlushTiles = (kFlushRows / R > 0) ? kFlushRows / R : 1;
  int since_flush = 0;

  long long tile = blockIdx.x;
  TileLabels<R, KG> lab;
  if (tile < n_tiles) {
    copy_tile<T, R>(x, n, d, tile, vec_bytes, s_x);
    lab.load(y, y_bf16, ldy, w, n, kg, tile);
    lab.store(s_y, s_w);
  }
  cp_async_commit();
  for (int it = 0; tile < n_tiles; tile += gridDim.x, ++it) {
    const int cur = (S == 2) ? (it & 1) : 0;
    const T* xt = reinterpret_cast<const T*>(
        reinterpret_cast<const unsigned char*>(s_x) + cur * stage_bytes);
    const long long nxt = tile + gridDim.x;
    if (nxt < n_tiles) lab.load(y, y_bf16, ldy, w, n, kg, nxt);
    if (S == 2) {
      if (nxt < n_tiles)
        copy_tile<T, R>(x, n, d, nxt, vec_bytes,
                        reinterpret_cast<T*>(reinterpret_cast<unsigned char*>(
                                                 s_x) +
                                             (cur ^ 1) * stage_bytes));
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // this tile's X, labels and weights are in place

    // -- margins and multipliers: warp `warp` owns rows warp*RW + rr ------
    float pm[RW][KG];
#pragma unroll
    for (int rr = 0; rr < RW; ++rr)
#pragma unroll
      for (int k = 0; k < KG; ++k) pm[rr][k] = 0.0f;
#pragma unroll 2
    for (int j = lane; j < d; j += 32) {
      float xv[RW];
#pragma unroll
      for (int rr = 0; rr < RW; ++rr)
        xv[rr] = to_f32<T>(xt[(warp * RW + rr) * d + j]);
#pragma unroll
      for (int k = 0; k < KG; ++k) {
        const float b = s_b[k * d + j];
#pragma unroll
        for (int rr = 0; rr < RW; ++rr) pm[rr][k] = fmaf(xv[rr], b, pm[rr][k]);
      }
    }
#pragma unroll
    for (int rr = 0; rr < RW; ++rr) {
#pragma unroll
      for (int k = 0; k < KG; ++k) {
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          pm[rr][k] += __shfl_xor_sync(0xffffffffu, pm[rr][k], o);
      }
      const int r = warp * RW + rr;
      float dot = 0.0f;  // lane k's model: a select, no local memory
#pragma unroll
      for (int k = 0; k < KG; ++k)
        if (lane == k) dot = pm[rr][k];
      if (lane < KG) {
        float mult = 0.0f;
        if (lane < kg) {
          const float m = dot + s_off[lane];
          const float yr = s_y[r * KG + lane], wr = s_w[r];
          const float e = expf(-fabsf(m));  // in (0, 1]
          const float sig = (m >= 0.0f) ? 1.0f / (1.0f + e) : e / (1.0f + e);
          const float softplus = fmaxf(m, 0.0f) + log1pf(e);
          mult = wr * (sig - yr);
          kahan_add(loss_s, loss_c, wr * (softplus - yr * m));
          kahan_add(mult_s, mult_c, mult);
        }
        s_m[r * KG + lane] = mult;
      }
      if (lane == 0) kahan_add(w_s, w_c, s_w[r]);
    }
    __syncthreads();  // the tile's multipliers are in place

    // -- gradient: thread tid owns columns tid + 256 c --------------------
#pragma unroll 1
    for (int r = 0; r < R; ++r) {
      float m[KG];
#pragma unroll
      for (int k4 = 0; k4 < KG / 4; ++k4) {
        const float4 v = reinterpret_cast<const float4*>(s_m + r * KG)[k4];
        m[4 * k4] = v.x;
        m[4 * k4 + 1] = v.y;
        m[4 * k4 + 2] = v.z;
        m[4 * k4 + 3] = v.w;
      }
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int col = tid + kThreads * c;
        if (col < d) {
          const float xv = to_f32<T>(xt[r * d + col]);
#pragma unroll
          for (int k = 0; k < KG; ++k) acc[c][k] = fmaf(m[k], xv, acc[c][k]);
        }
      }
    }
    if (++since_flush == kFlushTiles) {
      flush<C, KG>(acc, part, d, kg, flushed);
      since_flush = 0;
    }
    lab.store(s_y, s_w);  // the next tile's; this tile's are read
    __syncthreads();      // this tile's X buffer is free again
    if (S == 1) {
      if (nxt < n_tiles) copy_tile<T, R>(x, n, d, nxt, vec_bytes, s_x);
      cp_async_commit();
    }
  }
  cp_async_wait<0>();
  flush<C, KG>(acc, part, d, kg, flushed);

  // fold the warps' loss, msum and w sums in warp order, in double
  double* red = s_red + warp * (2 * KG + 1);
  if (lane < KG) {
    red[2 * lane] = (double)loss_s - (double)loss_c;
    red[2 * lane + 1] = (double)mult_s - (double)mult_c;
  }
  if (lane == 0) red[2 * KG] = (double)w_s - (double)w_c;
  __syncthreads();
  if (tid < kg) {
    double l = 0.0, ms = 0.0;
    for (int wi = 0; wi < kWarps; ++wi) {
      l += s_red[wi * (2 * KG + 1) + 2 * tid];
      ms += s_red[wi * (2 * KG + 1) + 2 * tid + 1];
    }
    part[(long long)tid * (d + 2) + d] = l;
    part[(long long)tid * (d + 2) + d + 1] = ms;
  }
  if (tid == 0) {
    double ws = 0.0;
    for (int wi = 0; wi < kWarps; ++wi)
      ws += s_red[wi * (2 * KG + 1) + 2 * KG];
    part[(long long)kg * (d + 2)] = ws;
  }
}

// out[j] = sum over CTAs c, in order, of partials[c][j]; rounded to f32.
__global__ void glm_stacked_reduce_kernel(const double* __restrict__ partials,
                                          int n_parts, int width,
                                          float* __restrict__ out) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= width) return;
  double s = 0.0;
  for (int c = 0; c < n_parts; ++c) s += partials[(long long)c * width + j];
  out[j] = (float)s;
}

struct Instance {
  const void* fn;  // a glm_stacked_kernel instance
  size_t item;     // bytes per element of X
  int rows, stages;
};

template <typename T, int C, int KG>
Instance make_instance() {
  using P = Plan<T, C, KG>;
  return {reinterpret_cast<const void*>(&glm_stacked_kernel<T, C, KG>),
          sizeof(T), P::kRows, P::kStages};
}

template <typename T, int C>
Instance pick_models(int kg) {
  if (kg <= 4) return make_instance<T, C, 4>();
  if (kg <= 8) return make_instance<T, C, 8>();
  return make_instance<T, C, 16>();
}

template <typename T>
Instance pick_cols(int d, int kg) {
  const int c = (d + 255) / 256;
  if (c <= 2) return pick_models<T, 2>(kg);
  if (c <= 4) return pick_models<T, 4>(kg);
  if (c <= 6) return pick_models<T, 6>(kg);
  return pick_models<T, 8>(kg);
}

// the instance for (dtype, d, kg), or fn == nullptr when none takes them
Instance instance_for(int dtype, int d, int kg) {
  if (d < 1 || d > 256 * kMaxCols || kg < 1 || kg > kMaxModels)
    return {nullptr, 0, 0, 0};
  if (dtype == 0) return pick_cols<float>(d, kg);
  if (dtype == 1) return pick_cols<__nv_bfloat16>(d, kg);
  if (dtype == 2) return pick_cols<__nv_fp8_e4m3>(d, kg);
  return {nullptr, 0, 0, 0};
}

int kg_of(int kg) { return kg <= 4 ? 4 : kg <= 8 ? 8 : 16; }

size_t smem_for(const Instance& inst, int d, int kg) {
  return smem_bytes(inst.item, inst.stages, inst.rows, kg_of(kg), d);
}

}  // namespace

extern "C" {

// Largest d and largest number of models one launch takes.
int glm_stacked_max_d() { return 256 * kMaxCols; }
int glm_stacked_max_models() { return kMaxModels; }

// CTAs (= partial rows) a sweep of n rows of (dtype, d) for kg models uses
// on the current device. dtype: 0 = float32 X, 1 = bfloat16 X,
// 2 = float8_e4m3fn codes.
int glm_stacked_num_parts(int dtype, int d, int kg, long long n,
                          int* n_parts) {
  const Instance inst = instance_for(dtype, d, kg);
  if (inst.fn == nullptr || n < 0) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_for(inst, d, kg);
  cudaError_t err = cudaFuncSetAttribute(
      inst.fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, inst.fn,
                                                      kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  long long parts = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const long long tiles = (n + inst.rows - 1) / inst.rows;
  if (tiles < parts) parts = tiles;
  if (parts < 1) parts = 1;
  *n_parts = (int)parts;
  return 0;
}

// One sweep of kg <= 16 models. x: (n, d) row-major at storage width;
// y: labels of the group's first model, row stride ldy elements, float32
// (y_bf16 = 0) or bfloat16 (1); w: (n,) f32; B: (kg, d) f32 row-major;
// off: (kg,) f32; partials: n_parts * (kg*(d+2)+1) doubles of scratch;
// out: kg*(d+2)+1 floats, written as [grad_k (d), loss_k, msum_k] for each
// model k, then sum(w).
int glm_stacked_launch(int dtype, const void* x, const void* y, int y_bf16,
                       long long ldy, const float* w, const float* B,
                       const float* off, long long n, int d, int kg,
                       double* partials, int n_parts, float* out,
                       void* stream) {
  const Instance inst = instance_for(dtype, d, kg);
  if (inst.fn == nullptr || n_parts < 1 || n < 0 || ldy < kg)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_for(inst, d, kg);
  cudaError_t err = cudaFuncSetAttribute(
      inst.fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  // the widest copy that the row width and X's base both allow
  const size_t row_bytes = (size_t)d * inst.item;
  const uintptr_t base = reinterpret_cast<uintptr_t>(x);
  int vec_bytes = 0;
  for (int v = 16; v >= 4; v >>= 1) {
    if (row_bytes % v == 0 && base % v == 0) {
      vec_bytes = v;
      break;
    }
  }
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  void* args[] = {const_cast<void**>(&x), const_cast<void**>(&y),
                  &y_bf16, &ldy, &w, &B, &off, &n, &d, &kg, &vec_bytes,
                  &partials};
  err = cudaLaunchKernel(inst.fn, dim3(n_parts), dim3(kThreads), args, smem,
                         s);
  if (err == cudaSuccess) err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int width = kg * (d + 2) + 1;
  glm_stacked_reduce_kernel<<<(width + 255) / 256, 256, 0, s>>>(
      partials, n_parts, width, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
