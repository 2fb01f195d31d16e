// Nearest-center assignment for Hopper (sm_90a): for every row of X, the
// index of its nearest center and the squared distance to it.
//
// Replaces cycloneml_tpu/ops/kernels.py:fused_kmeans_assign (the Pallas
// kernel behind KMeans' Lloyd steps and k-means|| passes). Per row r and
// center c:
//   d2[r, c] = (|x~_r|^2 - 2 x~_r . c_c) + |c_c|^2  (the reference's expansion)
//   best[r]  = the first c with the least d2 (ties go to the lowest index,
//              as jnp.argmin breaks them)
//   dist[r]  = max(d2[r, best[r]], 0)
// where x~ = upcast(x) o s with the fp8 rung's per-column scale s (the
// reference's x_scale operand, kernels.py:422; null for no scale). |c|^2
// comes from the wrapper (float32, value space), computed once per call;
// |x~_r|^2 is summed here in float32.
//
// Two instances, picked by X's dtype:
// - bf16 and e4m3 X: the tensor cores (kmeans_assign_tc_kernel), wgmma
//   bf16 x bf16 -> f32 against three-way split centers. The reference
//   runs the product at Precision.HIGHEST, float32-accurate, because
//   near-tie argmins flip at lower precision: one bf16 pass with the
//   centers rounded to bf16 moves the picked distance by up to ~6e-4 of
//   max(d2, |x|^2), against the check's 1e-5. The wrapper splits each
//   float32 center exactly into three bf16 parts, c = hi + mid + lo
//   (three 8-bit significands cover float32's 24), with the scale folded
//   in first (c~ = s o c, so that x~ . c = x . c~ for the codes x). X is
//   bf16, or e4m3 codes converted exactly to bf16, so every product
//   x_f lo_f, x_f mid_f, x_f hi_f is exact in float32, and the kernel sums
//   x.lo, then x.mid, then x.hi (smallest first) into one float32
//   accumulator: float32 accuracy.
// - f32 X: float32 FMAs (kmeans_assign_fma_kernel), the earlier design. On
//   the tensor cores an f32 X would need 3xTF32 or a six-pass bf16 split,
//   and no fit on the card hands K3 an f32 X at these shapes; that is
//   later work (ROADMAP Queue 2b).
//
// Bound at n=10M, d=128, k=1000: three bf16 passes are 3 x 2 n k d = 7.68
// TFLOP, 7.77 ms at 989 TFLOP/s (3xTF32 would be 15.5 ms at 495 TFLOP/s);
// X is 2.56 GB in bf16, 0.76 ms at 3.35 TB/s. One float32 pass at the FMA
// rate (67 TFLOP/s) is 38.2 ms.
//
// Design of the tensor-core instance, and the arithmetic behind it:
// - A CTA of two warpgroups owns 256 rows of X (each warpgroup 128, as two
//   m64 blocks) and walks over ALL centers in tiles of 128, so any k works
//   and a row's running minimum never leaves the registers: no (n, k)
//   distance matrix, no reduction across CTAs, and two launches on the
//   same inputs are bitwise equal.
// - X stays in shared memory across all center tiles: up to d = 256 its
//   256 rows (64 KB at d = 128) are staged once, converted to bf16 and
//   masked past n and d as they are loaded (any row stride: vector loads
//   where d % 8 == 0, element loads otherwise), and |x~|^2 is summed from
//   the staged tile; for wider rows each 64-feature block is staged again
//   per center tile and part. Both operands are K-major (rows of X, rows
//   of the centers), wgmma's natural layout, in the 128-byte swizzled
//   layout.
// - Center tiles stream through a ring of five 16 KB stages by cp.async,
//   three ahead of the product: one stage is 128 centers x 64 features of
//   one part. The wrapper pads the split parts with zeros to k and d
//   multiples of 128 and 64 (k x d is tiny), so every copy is a full
//   aligned 16 bytes; zero features leave the products unchanged, and the
//   padding centers' |c|^2 is +inf, so they never win. Each product waits
//   only for the one before it, so the tensor cores work while the next
//   stage is set up.
// - Center traffic: each CTA reads every part of every center, 1024 x 128
//   x 2 B x 3 = 768 KB at k = 1000, d = 128. At 256 rows per CTA that is
//   39,063 CTAs x 768 KB = 30 GB per launch from L2 (60 GB at 128 rows), a
//   few ms at L2's rate, under the 7.77 ms compute bound; each CTA does
//   1024 clocks of tensor work per 16 KB stage, 16 bytes a clock.
// - Shared memory: X 64 KB + ring 80 KB + |x|^2 at d = 128 (at most 128 +
//   80 KB), set with cudaFuncSetAttribute; one CTA per SM (the 128
//   accumulators a thread holds allow no second).
// - The epilogue of each center tile turns a thread's 2 x 64 accumulators
//   into d2 and, for each of its 4 rows, takes the least (value, index)
//   of its 32 centers by a tree (depth 5, not a chain of 32 dependent
//   compares) whose left operand always has the lower index, so a strict
//   '<' keeps the first least; the 4 threads that share a row combine
//   lexicographically at the end, so the lowest index wins every tie. With
//   8 warps an SM its latency is exposed (ROADMAP Queue 2b).
// - Near ties. The tensor cores' sums round otherwise than a chain of
//   float32 FMAs over the features (the FMA instance's arithmetic, and a
//   float32 GEMM's), so a row whose two nearest centers lie within
//   rounding of each other can be picked differently by the two; one such
//   row moves a KMeans center by up to |x - c| / (cluster size), above
//   the 1e-4 that a Lloyd step through K3 is held to against the plain
//   float32 one. The epilogue also keeps each row's next least d2, and a
//   row whose two least lie within (8 d + 32) 2^-24 (|x~|^2 + max |c|^2),
//   a bound on how far the two arithmetics can differ, is marked (dist =
//   -1); a second kernel re-decides the marked rows in the FMA instance's
//   arithmetic exactly (a CTA lists the marked rows of 2048 and takes them
//   in groups of up to 8, walking all centers once a group, from the
//   value-space float32 centers that follow the parts, transposed so that
//   a warp's loads are contiguous; the group's rows are staged in feature
//   tiles of at most 28 KB, so any d launches). So every pick is the FMA
//   instance's pick.
//
// Plain C interface (loaded with ctypes): every entry point returns a
// cudaError_t, 0 on success.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

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

// |x~_r|^2 for the rows of a CTA: one warp per row, lanes strided over the
// features, folded by xor shuffles in a fixed order
template <typename T>
__device__ __forceinline__ void row_norms(const T* __restrict__ x,
                                          const float* __restrict__ scale,
                                          long long n, int d, long long row0,
                                          int rows, int nwarps,
                                          float* __restrict__ x2s) {
  const int lane = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < rows; r += nwarps) {
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
}

// -- the tensor-core instance (bf16 and e4m3 X) -------------------------------

constexpr int kTcThreads = 256;   // two warpgroups
constexpr int kTcRows = 256;      // rows of X a CTA owns, 128 a warpgroup
constexpr int kTcCenters = 128;   // centers per tile (wgmma N)
constexpr int kKb = 64;           // features per block (a 128-byte row)
constexpr int kXBlockBytes = kTcRows * 128;       // 32 KB
constexpr int kResidentBlocks = 4;                // X resident up to d=256
constexpr int kStages = 5;                        // center ring
constexpr int kAhead = 3;         // center stages in flight ahead
constexpr int kCStageBytes = kTcCenters * 128;    // 16 KB
constexpr int kParts = 3;                         // hi, mid, lo

__host__ __device__ inline int blocks_of(int d) { return (d + kKb - 1) / kKb; }
__host__ inline int tc_smem(int d) {
  const int nkb = blocks_of(d);
  const int xblocks = nkb <= kResidentBlocks ? nkb : 1;
  return xblocks * kXBlockBytes + kStages * kCStageBytes +
         (kTcRows + kTcThreads / 32) * 4 + 1024;
}

// parts: (3, k_pad, d_pad) bf16, part 0 = hi, 1 = mid, 2 = lo, of the
// scaled centers, zero past k and d (k_pad = 128 ceil(k / 128), d_pad =
// 64 ceil(d / 64)); c_norm: (k_pad,), +inf past k; vec: rows of X allow
// vector loads. kResident: X is staged once (d <= 256), else one
// 64-feature block per unit.
template <typename T, bool kResident>
__global__ void __launch_bounds__(kTcThreads, 1)
    kmeans_assign_tc_kernel(const T* __restrict__ x,
                            const __nv_bfloat16* __restrict__ parts,
                            const float* __restrict__ c_norm,
                            const float* __restrict__ scale, long long n,
                            int d, int k, int vec, int* __restrict__ best,
                            float* __restrict__ dist) {
  using namespace hopper;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = align1024(smem_raw);
  const int nkb = blocks_of(d);
  const int d_pad = nkb * kKb;
  const int k_pad = (k + kTcCenters - 1) / kTcCenters * kTcCenters;
  const int ntiles = k_pad / kTcCenters;
  uint8_t* xs = base;
  uint8_t* ring = base + (kResident ? nkb : 1) * kXBlockBytes;
  float* x2s = reinterpret_cast<float*>(ring + kStages * kCStageBytes);

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  const long long row0 = (long long)blockIdx.x * kTcRows;

  // one 64-feature block of the CTA's rows into shared memory: chunk
  // g = q % 8 of row q / 8, for q = tid + 256 j; loads first, then stores
  auto stage_x = [&](int kb, uint8_t* dst) {
    uint4 v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int q = tid + kTcThreads * j;
      const long long r = row0 + (q >> 3);
      v[j] = load8(x, r, kb * kKb + (q & 7) * 8, d, r < n, vec != 0);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int q = tid + kTcThreads * j;
      st_shared16(smem_u32(dst) + sw128(q >> 3, q & 7), v[j]);
    }
  };

  // unit u: center tile u / (3 nkb), part 2 - (u / nkb) % 3 (lo first),
  // feature block u % nkb; 4 chunks a thread of its 16 KB
  const int units = ntiles * kParts * nkb;
  auto load_centers = [&](int u) {
    if (u < units) {
      const int ct = u / (kParts * nkb);
      const int part = kParts - 1 - (u / nkb) % kParts;
      const int kb = u % nkb;
      const __nv_bfloat16* src =
          parts + ((long long)part * k_pad + ct * kTcCenters) * d_pad +
          kb * kKb;
      const uint32_t dst = smem_u32(ring + (u % kStages) * kCStageBytes);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int q = tid + kTcThreads * j;  // chunk q % 8 of center q / 8
        cp_async16(dst + sw128(q >> 3, q & 7),
                   src + (long long)(q >> 3) * d_pad + (q & 7) * 8, 16);
      }
    }
    cp_async_commit();  // an empty group past the end keeps the count
  };

  if constexpr (kResident)
    for (int kb = 0; kb < nkb; ++kb)
      stage_x(kb, xs + kb * kXBlockBytes);
  for (int u = 0; u < kAhead; ++u) load_centers(u);
  fence_proxy_async();
  __syncthreads();
  if constexpr (kResident) {
    // |x~_r|^2 from the staged tile, in row_norms' order: one warp per
    // row, lane f % 32 over features f, folded by xor shuffles (the staged
    // bf16 values are the upcast elements exactly)
    for (int r = tid >> 5; r < kTcRows; r += kTcThreads / 32) {
      float sum = 0.0f;
      for (int f = lane; f < d; f += 32) {
        const __nv_bfloat16 b = *reinterpret_cast<const __nv_bfloat16*>(
            xs + (f / kKb) * kXBlockBytes + sw128(r, (f % kKb) / 8) +
            (f % 8) * 2);
        float v = __bfloat162float(b);
        if (scale != nullptr) v *= __ldg(scale + f);
        sum = fmaf(v, v, sum);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) x2s[r] = sum;
    }
  } else {
    row_norms(x, scale, n, d, row0, kTcRows, kTcThreads / 32, x2s);
  }
  // max |c|^2 over the k centers, for the near-tie bound
  float cmax = 0.0f;
  for (int c = tid; c < k; c += kTcThreads) cmax = fmaxf(cmax, c_norm[c]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    cmax = fmaxf(cmax, __shfl_xor_sync(0xffffffffu, cmax, o));
  if (lane == 0) x2s[kTcRows + (tid >> 5)] = cmax;
  __syncthreads();
#pragma unroll
  for (int w = 0; w < kTcThreads / 32; ++w)
    cmax = fmaxf(cmax, x2s[kTcRows + w]);

  // this thread's rows: wg*128 + mb*64 + 16 warp + lane/4 + 8 h, for
  // m block mb and half h (accumulator i of a block: half (i / 2) % 2,
  // center 2 (lane % 4) + i % 2 + 8 (i / 4) of the tile)
  float xx[2][2], best_v[2][2], next_v[2][2];
  int best_i[2][2];
#pragma unroll
  for (int mb = 0; mb < 2; ++mb)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      xx[mb][h] = x2s[wg * 128 + mb * 64 + warp * 16 + (lane >> 2) + 8 * h];
      best_v[mb][h] = INFINITY;
      next_v[mb][h] = INFINITY;
      best_i[mb][h] = 0;
    }
  float acc0[64], acc1[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    acc0[i] = 0.0f;
    acc1[i] = 0.0f;
  }

  // The products of unit u run while unit u + 1 is set up: each unit
  // waits for the one before it (wgmma_wait<1>; with X staged per block,
  // for itself, before the block is overwritten), and unit u + kAhead's
  // centers go into the slot of unit u + kAhead - kStages, long done. The
  // unit loop has no other wait, so the compiler keeps the products in
  // flight across it.
  static_assert(kAhead <= kStages - 2, "a slot is refilled while read");
  const int per_tile = kParts * nkb;
  for (int ct = 0; ct < ntiles; ++ct) {
    for (int u = ct * per_tile; u < (ct + 1) * per_tile; ++u) {
      const int kb = u % nkb;
      cp_async_wait<kAhead - 1>();  // unit u's centers, this thread's part
      fence_proxy_async();
      __syncthreads();  // everyone's part landed
      load_centers(u + kAhead);
      uint8_t* xb = xs + (kResident ? kb * kXBlockBytes : 0);
      if constexpr (!kResident) {
        stage_x(kb, xb);
        fence_proxy_async();
        __syncthreads();
      }
      const uint32_t a0 = smem_u32(xb) + wg * 128 * 128;
      const uint32_t b0 = smem_u32(ring + (u % kStages) * kCStageBytes);
      fence_operand(acc0);
      fence_operand(acc1);
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < kKb / 16; ++s) {
        const uint64_t db = desc_sw128(b0 + s * 32, 16, 1024);
        wgmma_m64n128k16<0, 0>(acc0, desc_sw128(a0 + s * 32, 16, 1024), db);
        wgmma_m64n128k16<0, 0>(acc1,
                               desc_sw128(a0 + 8192 + s * 32, 16, 1024), db);
      }
      wgmma_commit();
      wgmma_wait<kResident ? 1 : 0>();
      fence_operand(acc0);
      fence_operand(acc1);
    }

    // this thread's 32 centers of the tile: |c|^2 (+inf past k) on its
    // way while the last products finish
    const int c_base = ct * kTcCenters + 2 * (lane & 3);
    float cn[32];
#pragma unroll
    for (int v2 = 0; v2 < 16; ++v2) {
      const float2 p =
          __ldg(reinterpret_cast<const float2*>(c_norm + c_base + 8 * v2));
      cn[2 * v2] = p.x;
      cn[2 * v2 + 1] = p.y;
    }
    wgmma_wait<0>();
    fence_operand(acc0);
    fence_operand(acc1);

    // epilogue of center tile ct: for each of the thread's 4 rows, every d2
    // of its 32 centers (j = 2 v2 + v0 is center c_base + 8 v2 + v0, in
    // ascending order), their least (value, index) and next least value
    // by a tree in which the left operand always has the lower index, so a
    // strict '<' keeps the lowest index of a tie, then into the running
    // minimum (whose centers all come before this tile's)
#pragma unroll
    for (int mb = 0; mb < 2; ++mb)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float v[32], v2[32];
        int at[32];
#pragma unroll
        for (int j = 0; j < 32; ++j) {
          const float a = mb == 0 ? acc0[(j & 1) + 2 * h + 4 * (j >> 1)]
                                  : acc1[(j & 1) + 2 * h + 4 * (j >> 1)];
          v[j] = (xx[mb][h] - 2.0f * a) + cn[j];
          at[j] = j;
        }
#pragma unroll
        for (int j = 0; j < 32; j += 2) {
          v2[j] = fmaxf(v[j], v[j + 1]);
          if (v[j + 1] < v[j]) {
            v[j] = v[j + 1];
            at[j] = at[j + 1];
          }
        }
#pragma unroll
        for (int step = 2; step < 32; step *= 2)
#pragma unroll
          for (int j = 0; j < 32; j += 2 * step) {
            v2[j] = fminf(fmaxf(v[j], v[j + step]),
                          fminf(v2[j], v2[j + step]));
            if (v[j + step] < v[j]) {
              v[j] = v[j + step];
              at[j] = at[j + step];
            }
          }
        next_v[mb][h] = fminf(fmaxf(best_v[mb][h], v[0]),
                              fminf(next_v[mb][h], v2[0]));
        if (v[0] < best_v[mb][h]) {
          best_v[mb][h] = v[0];
          best_i[mb][h] = c_base + 8 * (at[0] >> 1) + (at[0] & 1);
        }
      }
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      acc0[i] = 0.0f;
      acc1[i] = 0.0f;
    }
  }

  // combine the 4 threads (lane % 4) that share each row; a row whose
  // two least d2 lie within the near-tie bound is left to the re-decision
  // (dist = -1 marks it)
  const float near_u = (8.0f * d + 32.0f) * 0x1p-24f;
#pragma unroll
  for (int mb = 0; mb < 2; ++mb)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v = best_v[mb][h], v2 = next_v[mb][h];
      int bi = best_i[mb][h];
#pragma unroll
      for (int o = 1; o <= 2; o <<= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, v, o);
        const float ov2 = __shfl_xor_sync(0xffffffffu, v2, o);
        const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
        v2 = fminf(fmaxf(v, ov), fminf(v2, ov2));
        if (ov < v || (ov == v && oi < bi)) {
          v = ov;
          bi = oi;
        }
      }
      const long long gr =
          row0 + wg * 128 + mb * 64 + warp * 16 + (lane >> 2) + 8 * h;
      if ((lane & 3) == 0 && gr < n) {
        best[gr] = bi;
        dist[gr] = v2 - v < near_u * (xx[mb][h] + cmax) ? -1.0f
                                                       : fmaxf(v, 0.0f);
      }
    }
}

// The re-decision of the rows the tensor-core instance marked (dist < 0),
// in the FMA instance's arithmetic exactly: |x~|^2 as row_norms sums it;
// each product a chain of fmaf over the features in order, from the
// value-space float32 centers; d2 = (|x~|^2 - 2 x~.c) + |c|^2; the first
// least index. A CTA scans kRedRows rows (each warp 256 of them, its
// loads started together), lists their marked rows in row order, and takes
// them in groups: each thread walks centers c = tid + 256 j with one
// accumulator a row, reading the centers transposed (centers_t: (d, k), so
// a warp's loads of one feature are contiguous) and the group's rows from
// shared memory, and the group's picks are reduced lexicographically across
// the CTA. The group's rows are staged in feature tiles of at most
// kRedSmem bytes: one tile, staged once, up to d = 7168 (a group of up to
// 8 rows while 8 d floats fit); for wider rows a row at a time, its tiles
// staged again for each 256 centers (a chain of fmaf stays in order across
// the tiles). Static and dynamic shared memory stay under the 48 KB that a
// launch may take without an attribute, for any d.
constexpr int kRedThreads = 256;
constexpr int kRedRows = 2048;       // rows a CTA scans, 256 a warp
constexpr int kRedGroup = 8;         // marked rows taken together, at most
constexpr int kRedSmem = 28 * 1024;  // a staged feature tile of the group
                                     // (with the static arrays, < 48 KB)

__host__ __device__ inline int red_group(int d) {
  const int g = kRedSmem / (4 * d);
  return g < 1 ? 1 : (g > kRedGroup ? kRedGroup : g);
}
__host__ __device__ inline int red_tile(int d) {  // features a staged tile
  const int t = kRedSmem / (4 * red_group(d));
  return d < t ? d : t;
}

template <typename T>
__global__ void __launch_bounds__(kRedThreads)
    kmeans_redecide_kernel(const T* __restrict__ x,
                           const float* __restrict__ centers_t,
                           const float* __restrict__ c_norm,
                           const float* __restrict__ scale, long long n,
                           int d, int k, int* __restrict__ best,
                           float* __restrict__ dist) {
  extern __shared__ float xv[];  // [group][tile]
  constexpr int kWarps = kRedThreads / 32;
  constexpr int kPerWarp = kRedRows / kWarps;
  __shared__ int seg[kRedRows];   // each warp's marked rows (offsets)
  __shared__ int list[kRedRows];  // all of them, in row order
  __shared__ int wcount[kWarps];
  __shared__ float xx[kRedGroup];
  __shared__ float red_v[kWarps][kRedGroup];
  __shared__ int red_i[kWarps][kRedGroup];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long r_begin = (long long)blockIdx.x * kRedRows;
  // the scan: each warp its 256 rows, all loads first
  {
    const int base = warp * kPerWarp;
    bool hit[kPerWarp / 32];
#pragma unroll
    for (int t = 0; t < kPerWarp / 32; ++t) {
      const long long r = r_begin + base + t * 32 + lane;
      hit[t] = r < n && dist[r] < 0.0f;
    }
    int count = 0;
#pragma unroll
    for (int t = 0; t < kPerWarp / 32; ++t) {
      const unsigned m = __ballot_sync(0xffffffffu, hit[t]);
      if (hit[t]) seg[base + count + __popc(m & ((1u << lane) - 1))] =
          base + t * 32 + lane;
      count += __popc(m);
    }
    if (lane == 0) wcount[warp] = count;
  }
  __syncthreads();
  int total = 0, before = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    if (w < warp) before += wcount[w];
    total += wcount[w];
  }
  for (int i = lane; i < wcount[warp]; i += 32)
    list[before + i] = seg[warp * kPerWarp + i];
  __syncthreads();

  const int group = red_group(d);
  const int tile = red_tile(d);
  const bool once = tile == d;  // the group's rows fit one staged tile
  for (int g0 = 0; g0 < total; g0 += group) {
    const int count = total - g0 < group ? total - g0 : group;
    auto row = [&](int m) {
      return x + (r_begin + list[g0 + m]) * (long long)d;
    };
    // features f0 .. f0 + width - 1 of the group's rows into xv
    auto stage = [&](int f0, int width) {
      __syncthreads();  // the tile before it is consumed
      for (int e = tid; e < count * width; e += kRedThreads) {
        const int m = e / width, f = e % width;
        xv[m * tile + f] = value(row(m), f0 + f, scale);
      }
      __syncthreads();
    };
    for (int m = warp; m < count; m += kWarps) {
      float s2 = 0.0f;  // row_norms' order and arithmetic
      for (int f = lane; f < d; f += 32) {
        const float v = value(row(m), f, scale);
        s2 = fmaf(v, v, s2);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        s2 += __shfl_xor_sync(0xffffffffu, s2, o);
      if (lane == 0) xx[m] = s2;
    }
    if (once) stage(0, d);  // its barriers also publish xx

    float bv[kRedGroup];
    int bi[kRedGroup];
#pragma unroll
    for (int m = 0; m < kRedGroup; ++m) {
      bv[m] = INFINITY;
      bi[m] = 0;
    }
    // every thread runs every pass, so that the staging's barriers match
    for (int c0 = 0; c0 < k; c0 += kRedThreads) {
      const int c = c0 + tid;
      float acc[kRedGroup];
#pragma unroll
      for (int m = 0; m < kRedGroup; ++m) acc[m] = 0.0f;
      for (int f0 = 0; f0 < d; f0 += tile) {
        const int width = d - f0 < tile ? d - f0 : tile;
        if (!once) stage(f0, width);
        if (c < k)
          for (int f = 0; f < width; ++f) {
            const float cf = centers_t[(long long)(f0 + f) * k + c];
#pragma unroll
            for (int m = 0; m < kRedGroup; ++m)
              if (m < count) acc[m] = fmaf(xv[m * tile + f], cf, acc[m]);
          }
      }
      if (c < k) {
        const float cn = c_norm[c];
#pragma unroll
        for (int m = 0; m < kRedGroup; ++m) {
          if (m >= count) break;
          const float v = (xx[m] - 2.0f * acc[m]) + cn;
          if (v < bv[m]) {
            bv[m] = v;
            bi[m] = c;
          }
        }
      }
    }
    // lexicographic (value, index) reduction: the warp, then the CTA
#pragma unroll
    for (int m = 0; m < kRedGroup; ++m) {
      if (m >= count) break;
      float v = bv[m];
      int i = bi[m];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, v, o);
        const int oi = __shfl_xor_sync(0xffffffffu, i, o);
        if (ov < v || (ov == v && oi < i)) {
          v = ov;
          i = oi;
        }
      }
      if (lane == 0) {
        red_v[warp][m] = v;
        red_i[warp][m] = i;
      }
    }
    __syncthreads();
    if (tid < count) {
      float v = red_v[0][tid];
      int i = red_i[0][tid];
      for (int w = 1; w < kWarps; ++w) {
        const float ov = red_v[w][tid];
        const int oi = red_i[w][tid];
        if (ov < v || (ov == v && oi < i)) {
          v = ov;
          i = oi;
        }
      }
      const long long r = r_begin + list[g0 + tid];
      best[r] = i;
      dist[r] = fmaxf(v, 0.0f);
    }
    __syncthreads();
  }
}

// -- the FMA instance (f32 X) -------------------------------------------------

constexpr int kThreads = 256;
constexpr int kRows = 128;     // rows of X a CTA owns
constexpr int kCenters = 128;  // centers per shared-memory tile
constexpr int kChunk = 16;     // features per stage
constexpr int kStride = 132;   // padded row of a transposed stage

// A CTA of 256 threads owns 128 rows and walks all centers in tiles of
// 128; each thread computes 8 rows x 8 centers of register-blocked float32
// FMAs from 16-feature stages of X and of the centers held transposed in
// shared memory (rows and centers of a thread strided by 64, so a quarter
// warp's float4 loads hit distinct banks). The epilogue is the tensor-core
// instance's, over 16 threads per row.
__global__ void __launch_bounds__(kThreads, 2)
    kmeans_assign_fma_kernel(const float* __restrict__ x,
                             const float* __restrict__ centers,
                             const float* __restrict__ c_norm,
                             const float* __restrict__ scale, long long n,
                             int d, int k, int* __restrict__ best,
                             float* __restrict__ dist) {
  __shared__ __align__(16) float xs[kChunk][kStride];
  __shared__ __align__(16) float cs[kChunk][kStride];
  __shared__ float x2s[kRows];

  const int tid = threadIdx.x;
  const int tx = tid & 15;  // centers tx*4 + j and 64 + tx*4 + j
  const int ty = tid >> 4;  // rows ty*4 + i and 64 + ty*4 + i
  const long long row0 = (long long)blockIdx.x * kRows;

  row_norms(x, scale, n, d, row0, kRows, kThreads / 32, x2s);

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

template <typename T>
cudaError_t launch_tc(const void* x, const void* parts, const float* c_norm,
                      const float* scale, long long n, int d, int k, int vec,
                      int* best, float* dist, cudaStream_t s) {
  const long long blocks = (n + kTcRows - 1) / kTcRows;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  auto kernel = blocks_of(d) <= kResidentBlocks
                    ? kmeans_assign_tc_kernel<T, true>
                    : kmeans_assign_tc_kernel<T, false>;
  const int smem = tc_smem(d);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const __nv_bfloat16* p = static_cast<const __nv_bfloat16*>(parts);
  kernel<<<(unsigned)blocks, kTcThreads, smem, s>>>(
      static_cast<const T*>(x), p, c_norm, scale, n, d, k, vec, best, dist);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // the value-space centers, transposed to (d, k), follow the parts
  const long long k_pad = (k + kTcCenters - 1) / kTcCenters * kTcCenters;
  const float* centers_t =
      reinterpret_cast<const float*>(p + 3 * k_pad * blocks_of(d) * kKb);
  const long long rblocks = (n + kRedRows - 1) / kRedRows;
  kmeans_redecide_kernel<T>
      <<<(unsigned)rblocks, kRedThreads, red_group(d) * red_tile(d) * 4,
         s>>>(
          static_cast<const T*>(x), centers_t, c_norm, scale, n, d, k, best,
          dist);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// One assignment pass. dtype: 0 = float32 X (FMA instance), 1 = bfloat16
// X, 2 = float8_e4m3fn codes (tensor-core instance). x: (n, d) row-major;
// centers: for dtype 0 the (k, d) float32 centers, row-major; for dtypes 1
// and 2 the (3, k_pad, d_pad) bfloat16 parts hi, mid, lo of the centers
// times the scale (k_pad = 128 ceil(k / 128), d_pad = 64 ceil(d / 64),
// zeros past k and d), followed by the float32 centers in value space,
// transposed to (d, k); c_norm: float32 |c|^2 in value space, (k,) for
// dtype 0 and (k_pad,) with +inf past k for dtypes 1 and 2; scale: (d,)
// float32 per-column dequantization, or null; best: (n,) int32 out; dist:
// (n,) float32 out.
int kmeans_assign_launch(int dtype, const void* x, const void* centers,
                         const float* c_norm, const float* scale, long long n,
                         int d, int k, int* best, float* dist, void* stream) {
  if (n < 0 || d < 1 || k < 1) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const uintptr_t addr = reinterpret_cast<uintptr_t>(x);
  if (dtype == 0) {
    const long long blocks = (n + kRows - 1) / kRows;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    kmeans_assign_fma_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(centers),
        c_norm, scale, n, d, k, best, dist);
    return (int)cudaGetLastError();
  }
  if (dtype == 1)
    return (int)launch_tc<__nv_bfloat16>(x, centers, c_norm, scale, n, d, k,
                                         d % 8 == 0 && addr % 16 == 0, best,
                                         dist, s);
  if (dtype == 2)
    return (int)launch_tc<__nv_fp8_e4m3>(x, centers, c_norm, scale, n, d, k,
                                         d % 8 == 0 && addr % 8 == 0, best,
                                         dist, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
