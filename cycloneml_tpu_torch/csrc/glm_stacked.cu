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
// Two instances, picked by X's dtype:
// - bf16 X and e4m3 codes: the tensor cores (glm_stacked_tc_kernel). It
//   took these dtypes over from the FMA instance because it measured
//   faster at the OneVsRest shape (chip_smoke.py's k1s_time lines; PERF.md
//   section 6 keeps the numbers).
// - f32 X: float32 FMAs (glm_stacked_kernel), the first design. On the
//   tensor cores an f32 X would need 3xTF32 or six bf16 passes; that is
//   later work (ROADMAP Queue 2 B7).
//
// Bound. X is read once per sweep for all K models (n*d bytes in e4m3,
// 2n*d in bf16, 4n*d in f32) plus the (n, K) labels. The arithmetic is
// 4*n*d*K flops on FMAs (margins and gradient); on the tensor cores, with
// B and the multipliers each in three bf16 parts, 12*n*d*K. At n=2M,
// d=1280, K=8 in bf16: 5.16 GB, 1.54 ms at an H100 SXM's 3.35 TB/s,
// against 246 GFLOP, 0.25 ms at its 989 TFLOP/s of bf16 tensor work (82
// GFLOP, 1.22 ms at its 67 TFLOP/s of f32 FMAs). So the tensor-core
// instance is bound by bytes at every K <= 16 (K=16: 1.55 ms of bytes,
// 0.50 ms of tensor work; on FMAs 2.45 ms), and e4m3 at K=8 by its 2.6 GB
// of codes and labels, 0.78 ms. Data-sheet rates, not measurements.
//
// The tensor-core instance, and the arithmetic behind it:
// - Exact operands, f32 sums. The wrapper splits B (after the fold)
//   exactly into three bf16 parts, B = hi + mid + lo (three 8-bit
//   significands cover float32's 24; ops/kernels.split_bf16x3). bf16 X is
//   exact as it is and every e4m3 code converts exactly to bf16, so each
//   product x * part is exact in f32 and the tensor cores sum exact
//   products in f32: the FMA instance's function to f32 rounding. The
//   multipliers are computed in f32 with the FMA instance's sigmoid and
//   softplus and Kahan sums of loss, sum(mult) and sum(w), then split in
//   registers the same way, so the gradient is sum_p X^T M_p.
// - mma.sync.m16n8k16 (bf16 in, f32 sums) with ldmatrix for both
//   products. wgmma would need 64 whole rows of X in shared memory at
//   once (160 KB at d = 1280, 256 KB at d = 2048), leaving no room for a
//   second stage; mma works on 16-row blocks, so a tile is 16 rows and
//   the models are the N side in n8 blocks (KG = 8 or 16 a launch).
// - A CTA is 16 warps, one CTA an SM (shared memory allows no second):
//   every phase below is a chain of latencies, and 16 warps hide more of
//   them than 8.
// - Margins: the 16-column k-blocks are split across the 16 warps (warp w
//   takes blocks w, w + 16, ...), so each part of B is read from shared
//   memory once a tile by the CTA (splitting the rows instead would make
//   every warp read all of B). Each X fragment is loaded once and used for
//   the three parts; each part sums into its own accumulator (three
//   independent chains), and a warp's margin is (lo + mid) + hi, smallest
//   first. The warps' partial margins (16 x KG f32) are summed in warp
//   order: a fixed order, so launches stay bitwise equal.
// - Epilogue: two threads for each (row, model) entry of the tile, in
//   different warps so that the two run side by side: one sums the
//   partial margins and turns the margin into the multiplier (its Kahan
//   sums, and sum(w) for model 0) and the multiplier's three bf16 parts
//   (model-major, the gradient's B operand), the other sums the same
//   partials in the same order and adds the loss. At KG = 8 that is half
//   the CTA; for e4m3 the other half copies and converts codes meanwhile
//   (bf16 X is copied by all threads as a tile starts).
// - Gradient: warp w owns the same 16-column blocks as mma's M side (X^T
//   through ldmatrix.trans), the models as N and the tile's 16 rows as K;
//   per block one X fragment and three products (lo, mid, hi) into one
//   f32 accumulator. The accumulators stay in registers (d x KG f32 over
//   512 threads: 20 at d = 1280, K = 8), and every 4,096 rows a thread
//   adds them, in double, into its CTA's partial row in device memory
//   (only this thread touches those entries) and restarts them.
// - Staging: tiles are 16 rows at a row pitch of d rounded up to 64
//   columns, the 16-byte chunks XOR-swizzled by the row (chunk c of row r
//   at c ^ (r % 8)), so ldmatrix's eight rows fall on eight bank groups at
//   every d (a plain 2,560-byte pitch at d = 1280 is 8-way conflicts). The
//   pad columns and B's pad columns are zeros. bf16 X goes by cp.async
//   (16, 8 or 4 bytes, as the row width and base allow; element by
//   element otherwise) into a ring of S tiles, S - 1 in flight while one
//   computes. e4m3 codes go by cp.async at one byte each into a ring of S
//   code tiles, S in flight; each copier converts exactly the codes it
//   copied itself (so no barrier stands between its copy and its
//   conversion) into one of two bf16 tiles during the tile before, or,
//   where two bf16 tiles do not fit, into one between tiles. A tile's
//   labels and weights go by 4-byte cp.async in the same group as its X,
//   into a ring of S + 2 label stages (global loads of them in the loop
//   measured slower). Rows past n are zeros with w = 0, so they add
//   exactly nothing.
// - A second kernel sums the partial rows column by column in CTA order,
//   in double, and rounds once to f32. No atomics: two launches on the
//   same inputs are bitwise equal. sum(w) is exact for n < 2^24 unit
//   weights per thread.
// - Shared memory and groups. An instance is (dtype, NB, KG): NB k-blocks
//   a warp at most (d <= 256 NB), KG models. B's parts take 6 KG d bytes,
//   a bf16 tile 32 d, a code tile 16 d, the partial margins 1,024 KG, a
//   label stage 64 KG + 64. The most stages (up to 4) that fit 227 KB are
//   taken; at d = 1280: bf16
//   three tiles at KG = 8 and two at KG = 16; e4m3 three code tiles and
//   two bf16 tiles at KG = 8, two code tiles and one bf16 tile at KG = 16.
//   For d > 1280 sixteen models leave no room for two stages (at d = 2048
//   the parts alone take 196,608 B), so the wrapper runs groups of 8
//   models there (glm_stacked_group), each one read of X; for d > 1536
//   even eight leave room for one bf16 stage only, and a tile's copy
//   waits for the one before.
// - Registers (ptxas, no spills): 74-115 a thread at KG = 8 and 92-123 at
//   KG = 16 for bf16, 76-105 and 80-128 for e4m3, within the 128 that 512
//   threads allow.
// - What holds it back (k1s_phases.py times the kernel with each phase
//   taken out; PERF.md section 6): a tile's phases run one after another
//   between three barriers, the epilogue's exp, division and log1p on 256
//   threads the longest of them at K = 8 in bf16; e4m3 adds the
//   conversion of every code.
//
// The FMA instance (f32 X), right and simple first: a CTA of 256 threads
// walks tiles of R rows, staged contiguously by cp.async (two stages where
// shared memory allows); warp w owns R/8 rows for the margins, lane l
// summing x_rj B_kj over j = l (mod 32) with B (f32) in shared memory and
// xor shuffles finishing the sums; lane k turns model k's margins into
// multipliers; thread t owns columns t, t + 256, ... for the gradient (C
// of them, one f32 sum per column and model in registers, flushed in
// double every 4,096 rows). Instances: C in {2, 4, 6, 8} x KG in {4, 8,
// 16}.
//
// Limits of these two: d <= 2048 and at most 16 models a launch (8 on the
// tensor cores for d > 1280); the wrapper runs groups, each one launch and
// one more read of X.
//
// The wide tensor-core instance (bf16 X and e4m3 codes, 2048 < d <= 8192),
// one read of X. B's three parts for sixteen models take 96 d bytes (295
// KB at d = 3,072), more than one CTA's shared memory, so the same kernel
// (glm_stacked_tc_kernel with CL > 1) runs on a cluster of CL CTAs, 4 up
// to d = 4,096 and 8 past it: CTA q stages columns [q dc, q dc + dc) of
// each tile and of B's parts (dc = d / CL rounded up to 64: 576 to 1,024
// columns, three or four k-blocks a warp), so every CTA keeps its slice
// of B resident and 16 models fit at every width (CIFAR-10's 10 classes
// in one launch). Per 16-row tile:
// - each CTA's partial margins of its slice (mma.sync as above; its warps
//   summed in warp order) go to a two-buffer array in its shared memory,
//   a cluster barrier (arrive.release, wait.acquire) publishes them, and
//   every CTA sums the CL CTAs' values in rank order through distributed
//   shared memory: the same bits in every CTA, so each computes the same
//   multipliers (the loss and sums are written by rank 0 alone);
// - each CTA then sums G^T += X^T M_p over its slice from the tile still
//   in its ring; the accumulators are flushed in double every 4,096 rows
//   into the cluster's partial row (one a cluster), each CTA its columns;
// - bf16: the loop is pipelined so that the barrier of a tile is waited
//   out while the next tile's margins are taken: iteration j arrives at
//   tile j - 1's barrier, takes tile j's margins, waits, then takes tile
//   j - 1's epilogue and gradient (tiles j - 1 and j resident, S - 2 in
//   flight). e4m3 codes keep the narrow loop with the exchange inserted
//   (each code converted once, as above). Both are the narrow loop's text
//   under `if constexpr`, so the narrow instance compiles as it did;
// - a last cluster barrier keeps every CTA until its peers' last reads.
// Registers: 105-128 a thread, 0 spills. What holds it back
// (k1s_phases.py --wide; PERF.md section 6): per tile a chain of barriers
// (two CTA barriers and the cluster's) over small slices (24 to 32 KB of X
// a CTA), each phase a few hundred cycles; taking the cluster barrier out
// still saves 18-25% at d = 8,192.
//
// The two-pass instances (f32 X past d = 2048, every dtype past 8192). A
// sweep is two passes over X, each streaming its operands by column
// block, then one reduction:
// - The margin pass: a CTA of 8 warps takes tiles of 128 rows (16 a
//   warp) and walks the columns in chunks of 64, X's chunk and the chunk
//   of B (three bf16 parts, or f32 on the FMAs) loaded into registers one
//   chunk ahead and stored into one of two shared stages (swizzled as the
//   narrow tensor-core instance's: ldmatrix's eight rows on eight bank
//   groups). Tensor cores: the warp's 16 rows against the KG = 8 models,
//   mma.sync m16n8k16, X's fragment once for the three parts, three
//   accumulators, (lo + mid) + hi for each chunk, as the narrow instance
//   sums, and the chunks added in column order in double (one f32 chain
//   over all of d, 512 k-blocks at d = 8192, lost 8e-6 of the gradient's
//   largest entry against float64; the narrow instance's chains are 8
//   k-blocks a warp, summed over 16 warps). FMAs: thread t owns model t %
//   KG of KG / 2 rows, an f32 chain a chunk, the chunks in double. Then
//   the tile's
//   epilogue: thread t the same model of its rows, the multiplier and loss
//   of the narrow instances (f32, their sigmoid and softplus), Kahan sums
//   of loss and sum(mult) per thread and of sum(w) by the threads of model
//   0; the multipliers go to an (n, kg) f32 scratch. At the end the
//   threads fold in thread order, in double, into the CTA's row of a small
//   partial array (2 kg + 1 doubles a CTA).
// - The gradient pass: a grid of (column block, row slab), one slab per
//   SM. Tensor cores: a block of 512 columns (four 16-column k-blocks a
//   warp), 16 rows a stage (mma's K) in two stages, the multipliers split
//   by split_bf16x3's arithmetic into three bf16 parts as they are staged;
//   G^T += X^T M_p by ldmatrix.trans and mma.sync, lo, mid, hi into one f32
//   accumulator, flushed in double into the slab's partial row every
//   4,096 rows, as the narrow instance flushes. FMAs: a block of 1,024
//   columns, four a thread, the slab's multipliers staged 64 rows at a
//   time; f32 sums flushed the same way.
// - The reduction sums the slabs' gradient rows and the margin CTAs'
//   scalars, each in order, in double, and rounds once to f32. Two
//   launches are bitwise equal; rows past n are zeros and add nothing.
// Scratch: n kg floats of multipliers, plus (slabs x kg d) doubles of
// gradient partials. KG = 8 on the tensor cores, 16 on the FMAs
// (glm_stacked_group past 8192; glm_stacked_two_pass_launch takes it at
// any d past 2048, for a comparison in one run).
//
// Plain C interface (loaded with ctypes): every entry point returns a
// cudaError_t, 0 on success.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cooperative_groups.h>

#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxModels = 16;   // K_MAX: models one launch sweeps at most
constexpr int kMaxD = 2048;  // the narrow instances' widest d
constexpr int kWideMaxD = 8192;  // the one-read wide instances' widest d
constexpr int kFlushRows = 4096; // rows an f32 gradient sum runs over
constexpr size_t kSmemLimit = 227 * 1024;

__host__ __device__ constexpr size_t align16(size_t v) {
  return (v + 15) & ~(size_t)15;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// `bytes` (16, 8 or 4) bytes global -> shared, by hopper.cuh's copies
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src,
                                         int bytes) {
  if (bytes == 16)
    hopper::cp_async16(dst, src, 16);
  else if (bytes == 8)
    hopper::cp_async8(dst, src, 8);
  else
    hopper::cp_async4(dst, src, 4);
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// `bytes` (16, 8, 4, 2 or 1) zero bytes at p
__device__ __forceinline__ void store_zeros(unsigned char* p, int bytes) {
  if (bytes == 16)
    *reinterpret_cast<uint4*>(p) = make_uint4(0u, 0u, 0u, 0u);
  else if (bytes == 8)
    *reinterpret_cast<uint2*>(p) = make_uint2(0u, 0u);
  else if (bytes == 4)
    *reinterpret_cast<uint32_t*>(p) = 0u;
  else if (bytes == 2)
    *reinterpret_cast<uint16_t*>(p) = 0;
  else
    *p = 0;
}

// Kahan step: the true sum is s - c.
__device__ __forceinline__ void kahan_add(float& s, float& c, float v) {
  const float y = v - c;
  const float t = s + y;
  c = (t - s) - y;
  s = t;
}

// the logistic link of margin m, label y and weight w: the multiplier
// w (sigmoid(m) - y) and the loss term w (softplus(m) - y m)
__device__ __forceinline__ float logistic_mult(float m, float y, float w) {
  const float e = expf(-fabsf(m));  // in (0, 1]
  const float sig = (m >= 0.0f) ? 1.0f / (1.0f + e) : e / (1.0f + e);
  return w * (sig - y);
}
__device__ __forceinline__ float logistic_loss(float m, float y, float w) {
  const float softplus = fmaxf(m, 0.0f) + log1pf(expf(-fabsf(m)));
  return w * (softplus - y * m);
}

// partials: gridDim.x rows of kg*(d+2)+1 doubles: per model k, grad (d),
// loss, msum at k*(d+2); then sum(w). Both instances write this layout.

// ===========================================================================
// The FMA instance (f32 X)
// ===========================================================================

// Shared memory for d columns: S stages of R rows of X, B (KG x d f32),
// the labels, weights and multipliers of a tile, and the warps' loss/msum/
// w sums. Every section is 16-byte aligned.
__host__ __device__ constexpr size_t smem_bytes(int S, int R, int KG,
                                                int d) {
  return S * align16((size_t)R * d * 4)          // X tiles
         + align16((size_t)KG * d * 4)           // B
         + align16((size_t)KG * 4)               // offsets
         + 2 * align16((size_t)R * KG * 4)       // labels, multipliers
         + align16((size_t)R * 4)                // weights
         + (size_t)kWarps * (2 * KG + 1) * 8;    // warp sums (double)
}

// Rows per tile and stages of an instance, for its widest d (256*C): the
// most rows (32, 16 or 8) whose two stages fit, else one stage of 8.
template <int C, int KG>
struct Plan {
  static constexpr int kDMax = 256 * C;
  static constexpr bool fits(int S, int R) {
    return smem_bytes(S, R, KG, kDMax) <= kSmemLimit;
  }
  static constexpr int kRows = fits(2, 32) ? 32 : fits(2, 16) ? 16 : 8;
  static constexpr int kStages = fits(2, kRows) ? 2 : 1;
  static_assert(fits(kStages, kRows), "instance does not fit shared memory");
};

// Tile `tile` of X (R rows from row tile*R) into shared memory at `dst`:
// cp.async of vec_bytes (16, 8 or 4) a copy, or element by element when
// vec_bytes is 0; bytes past row n are zeros.
template <int R>
__device__ __forceinline__ void copy_tile(const float* __restrict__ x,
                                          long long n, int d, long long tile,
                                          int vec_bytes, float* dst) {
  const long long r0 = tile * R;
  const long long rows = (n - r0 < R) ? (n - r0) : R;
  const size_t tile_bytes = (size_t)R * d * 4;
  const size_t valid = (size_t)rows * d * 4;
  const char* src = reinterpret_cast<const char*>(x + r0 * (long long)d);
  unsigned char* out = reinterpret_cast<unsigned char*>(dst);
  if (vec_bytes > 0) {
    for (size_t b = (size_t)threadIdx.x * vec_bytes; b < tile_bytes;
         b += (size_t)kThreads * vec_bytes) {
      if (b < valid)
        cp_async(smem_u32(out + b), src + b, vec_bytes);
      else
        store_zeros(out + b, vec_bytes);
    }
  } else {
    const uint32_t* s = reinterpret_cast<const uint32_t*>(src);
    uint32_t* o = reinterpret_cast<uint32_t*>(out);
    const size_t n_el = (size_t)R * d, n_valid = (size_t)rows * d;
    for (size_t e = threadIdx.x; e < n_el; e += kThreads)
      o[e] = (e < n_valid) ? s[e] : 0u;
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

template <int C, int KG>
__global__ void __launch_bounds__(kThreads, 1)
    glm_stacked_kernel(const float* __restrict__ x, const void* __restrict__ y,
                       int y_bf16, long long ldy, const float* __restrict__ w,
                       const float* __restrict__ B,
                       const float* __restrict__ off, long long n, int d,
                       int kg, int vec_bytes, double* __restrict__ partials) {
  using P = Plan<C, KG>;
  constexpr int R = P::kRows;
  constexpr int S = P::kStages;
  constexpr int RW = R / kWarps;  // rows of a tile each warp owns
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* p = smem;
  float* s_x = reinterpret_cast<float*>(p);
  const size_t stage_bytes = align16((size_t)R * d * 4);
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
    copy_tile<R>(x, n, d, tile, vec_bytes, s_x);
    lab.load(y, y_bf16, ldy, w, n, kg, tile);
    lab.store(s_y, s_w);
  }
  cp_async_commit();
  for (int it = 0; tile < n_tiles; tile += gridDim.x, ++it) {
    const int cur = (S == 2) ? (it & 1) : 0;
    const float* xt = reinterpret_cast<const float*>(
        reinterpret_cast<const unsigned char*>(s_x) + cur * stage_bytes);
    const long long nxt = tile + gridDim.x;
    if (nxt < n_tiles) lab.load(y, y_bf16, ldy, w, n, kg, nxt);
    if (S == 2) {
      if (nxt < n_tiles)
        copy_tile<R>(x, n, d, nxt, vec_bytes,
                     reinterpret_cast<float*>(
                         reinterpret_cast<unsigned char*>(s_x) +
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
      for (int rr = 0; rr < RW; ++rr) xv[rr] = xt[(warp * RW + rr) * d + j];
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
          const float m = dot + s_off[lane], yr = s_y[r * KG + lane];
          mult = logistic_mult(m, yr, s_w[r]);
          kahan_add(loss_s, loss_c, logistic_loss(m, yr, s_w[r]));
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
          const float xv = xt[r * d + col];
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
      if (nxt < n_tiles) copy_tile<R>(x, n, d, nxt, vec_bytes, s_x);
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

// ===========================================================================
// The tensor-core instance (bf16 X and e4m3 codes)
// ===========================================================================

constexpr int kTcWarps = 16;      // a CTA of the tensor-core instance
constexpr int kTcThreads = 32 * kTcWarps;
constexpr int kTcRows = 16;       // rows of a tile: mma's M (margins), K
                                  // (gradient)
constexpr int kKb = 16;           // columns of a k-block
constexpr int kParts = 3;         // hi, mid, lo (index 0, 1, 2)
constexpr int kTcMaxNb16 = 5;     // KG = 16 up to d = 16 kTcWarps 5 = 1280

// columns of a staged row: d rounded up to 64 (whole 8-chunk swizzle groups)
__host__ __device__ constexpr int pad64(int d) { return (d + 63) & ~63; }

// a tile's labels (16 x KG slots of 4 bytes; bf16 labels use the first
// half of each row) and weights (16 f32) in the label ring
__host__ __device__ constexpr int lab_bytes(int KG) {
  return kTcRows * KG * 4 + kTcRows * 4;
}
// stages of the label ring: S + 2, so that a tile's labels stay until its
// epilogue whichever path copies the tiles ahead
__host__ __device__ constexpr int lab_stages(int S) { return S + 2; }

// Shared memory of a tensor-core instance at padded width dp: the X ring
// (S bf16 tiles; for e4m3 `tiles` bf16 tiles and S code tiles), B's three
// parts (KG x dp bf16 each), the warps' partial margins (warps x 16 x KG
// f32), the multipliers' three parts (KG x 16 bf16 each) and the label
// ring. Every section is a multiple of 16 bytes.
__host__ __device__ constexpr size_t tc_smem(int item, int S, int tiles,
                                             int KG, int dp, int CL = 1) {
  return (item == 2 ? (size_t)S * kTcRows * dp * 2
                    : (size_t)tiles * kTcRows * dp * 2 +
                          (size_t)S * kTcRows * dp) +
         (size_t)kParts * KG * dp * 2 + (size_t)kTcWarps * kTcRows * KG * 4 +
         (size_t)kParts * KG * kTcRows * 2 +
         (size_t)lab_stages(S) * lab_bytes(KG) +
         (CL > 1 ? (size_t)2 * kTcRows * KG * 4 : 0);  // the cluster's sums
}

// The ring of an instance, for its widest d (16 kTcWarps NB): the most
// stages (up to 4) that fit; for e4m3 two bf16 tiles where they fit with a
// code stage (each tile's codes are converted while the tile before it
// computes), else one (converted between tiles).
template <typename T, int NB, int KG, int CL = 1>
struct TcPlan {
  static constexpr int kDMax = 16 * kTcWarps * NB;
  static constexpr bool kCodes = sizeof(T) == 1;
  static constexpr bool fits(int S, int tiles) {
    return tc_smem(sizeof(T), S, tiles, KG, kDMax, CL) <= kSmemLimit;
  }
  static constexpr int kTiles = kCodes ? (fits(1, 2) ? 2 : 1) : 0;
  static constexpr int kStages = fits(4, kTiles)   ? 4
                                 : fits(3, kTiles) ? 3
                                 : fits(2, kTiles) ? 2
                                                   : 1;
  static_assert(fits(kStages, kTiles), "instance does not fit shared memory");
};
static_assert(TcPlan<__nv_bfloat16, kTcMaxNb16, 16>::kStages >= 2 &&
                  TcPlan<__nv_fp8_e4m3, kTcMaxNb16, 16>::kStages >= 2,
              "16 models a launch need two stages up to d = 1280");

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr)
               : "memory");
}
// c (16 x 8 f32) += a (16 x 16 bf16, row) b (16 x 8 bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the cluster barrier: every thread of every CTA of the cluster arrives,
// then waits; the release and acquire order the shared-memory writes
// before the arrive before the reads after the wait, across the cluster
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_sync() {
  cluster_arrive();
  cluster_wait();
}

// byte offset of byte b of row r in a swizzled region of rows `pitch`
// bytes apart (a multiple of 128): 16-byte chunk c at c ^ (r % 8)
__device__ __forceinline__ int swz(int r, int b, int pitch) {
  return r * pitch + ((((b >> 4) ^ (r & 7)) << 4) | (b & 15));
}

// Copier ct's share of a 16-row tile, kCount copiers: kCount / 16 a row,
// row ct / that, units of vec bytes from byte b0 in steps of `step`.
template <int kCount>
struct RowShare {
  static constexpr int kPerRow = kCount / kTcRows;
  int r, b0, step;
  __device__ __forceinline__ RowShare(int vec, int ct)
      : r(ct / kPerRow), b0((ct % kPerRow) * vec), step(kPerRow * vec) {}
};

// Copier ct's share of rows [r0, r0 + 16) of X (the first row_bytes of
// each, rows `stride` bytes apart) into a stage, byte b of row r at swz(r,
// b, pitch) (kSwizzle) or r * pitch + b: cp.async units of vec bytes (16, 8
// or 4), or, for vec < 4, element by element (vec = the element's bytes);
// rows past n are zeros.
template <bool kSwizzle, int kCount>
__device__ __forceinline__ void tc_copy_tile(const unsigned char* __restrict__ x,
                                             long long n, int row_bytes,
                                             long long stride, long long r0,
                                             int vec, unsigned char* dst,
                                             int pitch, int ct) {
  const RowShare<kCount> sh(vec, ct);
  unsigned char* row = dst + sh.r * pitch;
  const int sw = kSwizzle ? (sh.r & 7) << 4 : 0;
  if (r0 + sh.r < n) {
    const unsigned char* src = x + (r0 + sh.r) * stride;
    for (int b = sh.b0; b < row_bytes; b += sh.step) {
      unsigned char* at = row + (b ^ sw);
      if (vec >= 4)
        cp_async(smem_u32(at), src + b, vec);
      else if (vec == 2)
        *reinterpret_cast<uint16_t*>(at) =
            __ldg(reinterpret_cast<const unsigned short*>(src + b));
      else
        *at = __ldg(src + b);
    }
  } else {
    for (int b = sh.b0; b < row_bytes; b += sh.step)
      store_zeros(row + (b ^ sw), vec);
  }
}

// Copier ct's share of a tile's labels and weights (rows [r0, r0 + 16))
// into a label stage by 4-byte cp.async: f32 labels one a copy, bf16
// labels two (the wrapper hands bf16 labels over only with an even kg and
// row stride and a 4-byte-aligned base); zeros past n. Slots of models past
// kg are never read.
template <int kCount, int KG>
__device__ __forceinline__ void tc_copy_labels(
    const unsigned char* __restrict__ y, int y_bf16, long long ldy,
    const float* __restrict__ w, long long n, int kg, long long r0,
    unsigned char* lab, int ct) {
  const int esz = y_bf16 ? 2 : 4;
  const int per_row = y_bf16 ? kg / 2 : kg;  // 4-byte units of a row
  for (int u = ct; u < kTcRows * (per_row + 1); u += kCount) {
    const int r = u / (per_row + 1), c = u - r * (per_row + 1);
    // unit per_row of a row is its weight
    unsigned char* at = c < per_row ? lab + (r * KG) * esz + 4 * c
                                    : lab + kTcRows * KG * 4 + 4 * r;
    if (r0 + r < n) {
      const void* src =
          c < per_row
              ? static_cast<const void*>(y + ((r0 + r) * ldy) * esz + 4 * c)
              : static_cast<const void*>(w + r0 + r);
      cp_async(smem_u32(at), src, 4);
    } else {
      *reinterpret_cast<uint32_t*>(at) = 0u;
    }
  }
}

// Copier ct's own units of a code tile (as tc_copy_tile<false, kCount>
// copied them, so no barrier is needed between its copy and this)
// converted exactly to bf16 into a swizzled bf16 tile: vec codes at byte b
// of row r become 2 vec bytes at byte 2 b.
template <int kCount>
__device__ __forceinline__ void tc_convert_own(const unsigned char* codes,
                                               int dp, int row_bytes,
                                               int vec, unsigned char* tile,
                                               int pitch, int ct) {
  using hopper::e4m3x2_to_bf16x2;
  const RowShare<kCount> sh(vec, ct);
  const unsigned char* src = codes + sh.r * dp;
  unsigned char* row = tile + sh.r * pitch;
  const int sw = (sh.r & 7) << 4;
  for (int b = sh.b0; b < row_bytes; b += sh.step) {
    if (vec == 16) {
      const uint4 v = *reinterpret_cast<const uint4*>(src + b);
      *reinterpret_cast<uint4*>(row + ((2 * b) ^ sw)) = make_uint4(
          e4m3x2_to_bf16x2((uint16_t)v.x),
          e4m3x2_to_bf16x2((uint16_t)(v.x >> 16)),
          e4m3x2_to_bf16x2((uint16_t)v.y),
          e4m3x2_to_bf16x2((uint16_t)(v.y >> 16)));
      *reinterpret_cast<uint4*>(row + ((2 * b + 16) ^ sw)) = make_uint4(
          e4m3x2_to_bf16x2((uint16_t)v.z),
          e4m3x2_to_bf16x2((uint16_t)(v.z >> 16)),
          e4m3x2_to_bf16x2((uint16_t)v.w),
          e4m3x2_to_bf16x2((uint16_t)(v.w >> 16)));
    } else if (vec == 8) {
      const uint2 v = *reinterpret_cast<const uint2*>(src + b);
      *reinterpret_cast<uint4*>(row + ((2 * b) ^ sw)) = make_uint4(
          e4m3x2_to_bf16x2((uint16_t)v.x),
          e4m3x2_to_bf16x2((uint16_t)(v.x >> 16)),
          e4m3x2_to_bf16x2((uint16_t)v.y),
          e4m3x2_to_bf16x2((uint16_t)(v.y >> 16)));
    } else if (vec == 4) {
      const uint32_t v = *reinterpret_cast<const uint32_t*>(src + b);
      *reinterpret_cast<uint2*>(row + ((2 * b) ^ sw)) =
          make_uint2(e4m3x2_to_bf16x2((uint16_t)v),
                     e4m3x2_to_bf16x2((uint16_t)(v >> 16)));
    } else {
      *reinterpret_cast<uint16_t*>(row + ((2 * b) ^ sw)) =
          (uint16_t)e4m3x2_to_bf16x2(src[b]);
    }
  }
}

// parts: (3, kg, pad64(d)) bf16, B's hi, mid and lo parts, zero past d;
// vec: the copy unit of X's rows in bytes (16, 8, 4, or the element's
// bytes). CL > 1: the wide instance, a cluster of CL CTAs on each tile,
// CTA q taking columns [q dc, q dc + dc) (dc a multiple of 64; CL = 1
// ignores it) and one partial row a cluster.
template <typename T, int NB, int KG, int CL = 1>
__global__ void __launch_bounds__(kTcThreads, 1)
    glm_stacked_tc_kernel(const T* __restrict__ x, const void* __restrict__ y,
                          int y_bf16, long long ldy,
                          const float* __restrict__ w,
                          const __nv_bfloat16* __restrict__ parts,
                          const float* __restrict__ off, long long n, int d,
                          int kg, int vec, int dc,
                          double* __restrict__ partials) {
  using P = TcPlan<T, NB, KG, CL>;
  constexpr int R = kTcRows;
  constexpr int S = P::kStages;
  constexpr int NT = KG / 8;  // n8 blocks of models
  constexpr bool kCodes = P::kCodes;
  constexpr int kTiles = P::kTiles;  // e4m3's bf16 tiles
  // the epilogue: two threads for each of the tile's R KG (row, model)
  // entries, one in each half of kEpi; the threads from kCopyFrom on copy
  // X: all of them for bf16 (at the top of a tile); for e4m3 those past
  // the epilogue, which copy and convert the codes during it (where
  // there are any; else all, after the margins). Each measured faster.
  constexpr int kEntries = R * KG;
  constexpr int kEpi = 2 * kEntries;
  static_assert(kEpi <= kTcThreads, "two threads an entry");
  constexpr int kCopyFrom = (kCodes && kEpi < kTcThreads) ? kEpi : 0;
  constexpr int kCopiers = kTcThreads - kCopyFrom;
  extern __shared__ __align__(16) unsigned char smem[];

  // the cluster's CTA `rank` stages columns [c0, c0 + dl) of X and B at a
  // pitch of dp columns; the clusters walk the tiles as the CTAs of the
  // narrow instance do
  const int rank = CL > 1 ? (int)cg::this_cluster().block_rank() : 0;
  const long long cid = CL > 1 ? blockIdx.x / CL : blockIdx.x;
  const int c0 = rank * (CL > 1 ? dc : 0);
  const int dl = CL > 1 ? max(0, min(dc, d - c0)) : d;
  const int dp = CL > 1 ? dc : pad64(d);
  const int ldp = pad64(d);               // B's parts' row stride
  const int pitch = dp * 2;               // bytes of a bf16 row
  const int nkb = (dl + kKb - 1) / kKb;   // 16-column blocks
  const int tile_bytes = R * pitch;       // a bf16 tile
  const int ring_pitch = kCodes ? dp : pitch;
  const int stage_bytes = R * ring_pitch;
  unsigned char* s_x = smem;  // e4m3: the bf16 tiles
  unsigned char* s_ring = smem + kTiles * tile_bytes;
  unsigned char* s_p = s_ring + S * stage_bytes;  // [3][KG] rows of B
  float* s_pm = reinterpret_cast<float*>(s_p + kParts * KG * pitch);
  __nv_bfloat16* s_mp =  // [3][KG][R]: the multipliers' parts
      reinterpret_cast<__nv_bfloat16*>(s_pm + kTcWarps * R * KG);
  unsigned char* s_lab =  // the label ring
      reinterpret_cast<unsigned char*>(s_mp + kParts * KG * R);
  constexpr int kLab = lab_stages(S);
  float* s_cm =  // CL > 1: [2][R * KG], this CTA's margins of a tile
      reinterpret_cast<float*>(s_lab + kLab * lab_bytes(KG));

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int i8 = lane & 7, q = lane >> 3;
  const long long n_tiles = (n + R - 1) / R;
  const int width = kg * (d + 2) + 1;
  double* part = partials + cid * width;
  const int row_bytes = dl * (int)sizeof(T);
  // X's rows are `stride` bytes apart (CL = 1: row_bytes)
  const long long stride =
      CL > 1 ? (long long)d * (long long)sizeof(T) : (long long)row_bytes;
  const unsigned char* xs = reinterpret_cast<const unsigned char*>(x) +
                            (long long)c0 * (long long)sizeof(T);
  // this lane's ldmatrix offsets at the warp's first k-block (2 warp + h
  // is 16-byte chunk h of it); the warp's block i is 2 kTcWarps chunks
  // (kStep bytes) further, since the swizzle moves only the low 3 bits of
  // a chunk index. Margins, A = X: matrix q is rows 8 (q & 1) + i8, chunk
  // q >> 1; B = part p: models 8 (q >> 1) + i8 (8 x NT models), chunk
  // q & 1. Gradient, A = X^T by ldmatrix.trans: rows 8 (q >> 1) + i8,
  // chunk q & 1. Every row is 8k + i8, so row % 8 == i8.
  const int a_off = (i8 + 8 * (q & 1)) * pitch +
                    (((2 * warp + (q >> 1)) ^ i8) << 4);
  const int b_off = (8 * ((q >> 1) % NT) + i8) * pitch +
                    (((2 * warp + (q & 1)) ^ i8) << 4);
  const int t_off = (i8 + 8 * (q >> 1)) * pitch +
                    (((2 * warp + (q & 1)) ^ i8) << 4);
  constexpr int kStep = 32 * kTcWarps;

  // zero the X ring (pad columns stay zero), then B's parts, swizzled
  for (int b = tid * 16; b < (int)(s_p - smem); b += kTcThreads * 16)
    store_zeros(smem + b, 16);
  for (int u = tid; u < kParts * KG * (dp / 8); u += kTcThreads) {
    const int row = u / (dp / 8), c = u - row * (dp / 8);
    const int p = row / KG, k = row - p * KG;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (k < kg && (CL == 1 || c0 + c * 8 < ldp))
      v = __ldg(reinterpret_cast<const uint4*>(
          parts + ((long long)p * kg + k) * ldp + c0 + c * 8));
    *reinterpret_cast<uint4*>(s_p + p * KG * pitch + swz(k, c * 16, pitch)) =
        v;
  }
  __syncthreads();  // the zeros are down before the first copies land

  const long long grid = gridDim.x / CL;  // the clusters (CTAs when CL = 1)
  const bool copier = tid >= kCopyFrom;
  const int ct = tid - kCopyFrom;
  // a copier's share of the j-th tile of this CTA into ring stage
  // `stage`, with its labels and weights into label stage j % kLab, in one
  // group (global loads of the labels in the loop would wait behind the
  // ring's cp.async waits)
  auto issue = [&](long long j, int stage) {
    const long long t = cid + j * grid;
    if (t < n_tiles) {
      tc_copy_tile<!kCodes, kCopiers>(xs, n, row_bytes, stride, t * R, vec,
                                      s_ring + stage * stage_bytes,
                                      ring_pitch, ct);
      tc_copy_labels<kCopiers, KG>(
          reinterpret_cast<const unsigned char*>(y), y_bf16, ldy, w, n, kg,
          t * R, s_lab + (int)(j % kLab) * lab_bytes(KG), ct);
    }
    cp_async_commit();  // an empty group past the end keeps the count
  };
  // a copier's own codes of the j-th tile, once they landed, into bf16
  // tile `dst`, then its share of the (j + S)-th tile into the freed stage
  auto convert = [&](long long j, unsigned char* dst) {
    cp_async_wait<S - 1>();
    if (cid + j * grid < n_tiles)
      tc_convert_own<kCopiers>(s_ring + (int)(j % S) * stage_bytes, dp,
                               row_bytes, vec, dst, pitch, ct);
    issue(j + S, (int)(j % S));
  };
  // e4m3 with two bf16 tiles: the next tile's conversion, during the j-th
  auto ahead = [&](long long j) {
    if constexpr (kTiles == 2)
      convert(j + 1, s_x + (int)((j + 1) & 1) * tile_bytes);
  };

  // the epilogue's entry (row er, model ek) and this thread's part in it:
  // sub 0 the multiplier, sum(mult) and sum(w), sub 1 the loss
  const int entry = tid % kEntries, sub = tid / kEntries;
  const int er = entry / KG, ek = entry % KG;
  const float off_k = (ek < kg) ? off[ek] : 0.0f;

  float acc[NB][NT][4];
#pragma unroll
  for (int i = 0; i < NB; ++i)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][nt][e] = 0.0f;
  float sum_s = 0.0f, sum_c = 0.0f;  // sub 0: sum(mult); sub 1: the loss
  float w_s = 0.0f, w_c = 0.0f;      // sub 0 of model 0: sum(w)
  bool flushed = false;
  constexpr int kFlushTiles = kFlushRows / R;
  int since_flush = 0;

  // bf16 on a cluster (kPipe): iteration j takes the margins of tile j,
  // then the epilogue and gradient of tile j - 1, whose cluster barrier
  // was arrived at first and is waited out after tile j's margins; so the
  // loop runs once more, and tiles j - 1 and j are resident
  constexpr bool kPipe = CL > 1 && !kCodes;
  static_assert(!kPipe || S >= 3, "two resident tiles and one in flight");
  // CL > 1: this CTA's margins of the j-th tile (its warps in warp order,
  // from s_pm) to the cluster's buffer s_cm[j & 1], published by the
  // cluster barrier; a CTA writes a buffer again only after every CTA has
  // passed the next tile's barrier, so after its reads of it
  auto own_margins = [&](long long j) {
    if (tid < kEntries) {
      float dot = 0.0f;
#pragma unroll
      for (int wi = 0; wi < kTcWarps; ++wi) dot += s_pm[wi * kEntries + tid];
      s_cm[(int)(j & 1) * kEntries + tid] = dot;
    }
  };

  // prologue: bf16 keeps S - 1 tiles in flight (one with a single stage;
  // S - 2 when pipelined); e4m3 S code tiles, and with two bf16 tiles the
  // first converted
  constexpr int kAhead = kCodes ? S : kPipe ? S - 2 : (S >= 2 ? S - 1 : 1);
  if (copier) {
#pragma unroll
    for (int s = 0; s < kAhead; ++s) issue(s, s);
    if constexpr (kTiles == 2) convert(0, s_x);
  }

  for (long long j = 0; cid + (kPipe ? j - 1 : j) * grid < n_tiles; ++j) {
    if constexpr (kPipe) {
      if (j > 0) {  // tile j - 1's partial margins are in s_pm
        own_margins(j - 1);
        cluster_arrive();
      }
    }
    const long long tile = cid + j * grid;
    const unsigned char* xt;
    if constexpr (kTiles == 2) {
      __syncthreads();  // this tile's bf16 tile is in place
      xt = s_x + (int)(j & 1) * tile_bytes;
    } else if constexpr (kCodes) {
      __syncthreads();  // the last tile's gradient is done with the tile
      if (copier) convert(j, s_x);
      __syncthreads();  // the bf16 tile is in place
      xt = s_x;
    } else if constexpr (kPipe) {
      cp_async_wait<S - 3>();
      __syncthreads();  // tile j in place; s_pm read; tile j - 2 done
      xt = s_ring + (int)(j % S) * stage_bytes;
      if (copier) issue(j + S - 2, (int)((j + S - 2) % S));
    } else if constexpr (S >= 2) {
      cp_async_wait<S - 2>();
      __syncthreads();  // this tile is in place; the last one's stage free
      xt = s_ring + (int)(j % S) * stage_bytes;
      if (copier) issue(j + S - 1, (int)((j + S - 1) % S));
    } else {
      cp_async_wait<0>();
      __syncthreads();
      xt = s_ring;
    }
    const uint32_t xb = smem_u32(xt);
    const uint32_t pb = smem_u32(s_p);

    // -- margins: warp w takes k-blocks w, w + kTcWarps, ...; one
    // accumulator per part of B
    if (!kPipe || tile < n_tiles) {
      float pm[kParts][NT][4];
#pragma unroll
      for (int p = 0; p < kParts; ++p)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) pm[p][nt][e] = 0.0f;
#pragma unroll
      for (int i = 0; i < NB; ++i) {
        const int kb = warp + kTcWarps * i;
        if (kb < nkb) {
          uint32_t a[4];
          ldsm_x4(a, xb + a_off + kStep * i);
#pragma unroll
          for (int p = 0; p < kParts; ++p) {
            // B = part p (16 columns x models), model-major
            const uint32_t at = pb + p * KG * pitch + b_off + kStep * i;
            if constexpr (NT == 2) {
              uint32_t b[4];
              ldsm_x4(b, at);
              mma_bf16(pm[p][0], a, b[0], b[1]);
              mma_bf16(pm[p][1], a, b[2], b[3]);
            } else {
              uint32_t b[2];
              ldsm_x2(b, at);
              mma_bf16(pm[p][0], a, b[0], b[1]);
            }
          }
        }
      }
      // this warp's partial margins, (lo + mid) + hi: c0, c1 at row g,
      // models 2 (lane % 4) + {0, 1}; c2, c3 at row g + 8
      {
        const int g = lane >> 2, m0 = 2 * (lane & 3);
        float* dst = s_pm + warp * R * KG;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          float v[4];
#pragma unroll
          for (int e = 0; e < 4; ++e)
            v[e] = (pm[2][nt][e] + pm[1][nt][e]) + pm[0][nt][e];
          *reinterpret_cast<float2*>(dst + g * KG + nt * 8 + m0) =
              make_float2(v[0], v[1]);
          *reinterpret_cast<float2*>(dst + (g + 8) * KG + nt * 8 + m0) =
              make_float2(v[2], v[3]);
        }
      }
    }
    // e4m3's next conversion: here by every thread when all of them take
    // part in the epilogue, else by the copiers during it
    if constexpr (kCopyFrom == 0) ahead(j);
    if constexpr (kPipe) {
      if (j == 0) {
        __syncthreads();  // tile 0's partial margins are in place
        continue;
      }
      cluster_wait();  // tile j - 1's margins, cluster-wide
    } else {
      __syncthreads();  // every warp's partial margins are in place
      if constexpr (CL > 1) {  // e4m3 codes on a cluster
        own_margins(j);
        cluster_sync();
      }
    }

    // the tile of this iteration's epilogue and gradient: its index among
    // this CTA's tiles, its tile and its bf16 rows
    const long long je = kPipe ? j - 1 : j;
    const long long tg = kPipe ? tile - grid : tile;
    const uint32_t xg =
        kPipe ? smem_u32(s_ring + (int)(je % S) * stage_bytes) : xb;

    // -- epilogue: the entry's two threads each sum the margins (the
    // warps' in warp order; on a cluster its CTAs' in rank order; the same
    // bits); sub 0 the multiplier, its sums and its three bf16 parts
    // (model-major) for the gradient, sub 1 (other warps, so the two run
    // side by side) the loss; the copiers copy meanwhile
    if (tid < kEpi) {
      // this tile's label and weight, from the label ring
      const unsigned char* lab = s_lab + (int)(je % kLab) * lab_bytes(KG);
      const float wv =
          *reinterpret_cast<const float*>(lab + R * KG * 4 + 4 * er);
      float yv = 0.0f;
      if (ek < kg)
        yv = y_bf16 ? __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(
                          lab + (er * KG + ek) * 2))
                    : *reinterpret_cast<const float*>(lab + (er * KG + ek) * 4);
      float dot = 0.0f;
      if constexpr (CL > 1) {
        cg::cluster_group cluster = cg::this_cluster();
#pragma unroll
        for (int c = 0; c < CL; ++c)
          dot += cluster.map_shared_rank(s_cm, c)[(int)(je & 1) * kEntries +
                                                  entry];
      } else {
#pragma unroll
        for (int wi = 0; wi < kTcWarps; ++wi)
          dot += s_pm[wi * kEntries + entry];
      }
      const float m = dot + off_k;
      if (sub == 0) {
        float mult = 0.0f;
        if (ek < kg) {
          mult = logistic_mult(m, yv, wv);
          kahan_add(sum_s, sum_c, mult);
        }
        if (ek == 0) kahan_add(w_s, w_c, wv);
        const __nv_bfloat16 hi = __float2bfloat16_rn(mult);
        const float r1 = mult - __bfloat162float(hi);
        const __nv_bfloat16 mid = __float2bfloat16_rn(r1);
        const __nv_bfloat16 lo =
            __float2bfloat16_rn(r1 - __bfloat162float(mid));
        s_mp[(0 * KG + ek) * R + er] = hi;
        s_mp[(1 * KG + ek) * R + er] = mid;
        s_mp[(2 * KG + ek) * R + er] = lo;
      } else if (ek < kg) {
        kahan_add(sum_s, sum_c, logistic_loss(m, yv, wv));
      }
    } else if constexpr (kCopyFrom > 0) {
      ahead(j);
    }
    __syncthreads();  // the multipliers' parts are in place

    // -- gradient: G^T (columns x models) += X^T (columns x rows) M_p
    // (rows x models); B fragments of the parts: matrix q is models
    // nt 8 + i8, rows 8 (q & 1)
    uint32_t bm[kParts][NT][2];
    {
      const uint32_t mb = smem_u32(s_mp);
#pragma unroll
      for (int p = 0; p < kParts; ++p)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          ldsm_x2(bm[p][nt],
                  mb + ((p * KG + nt * 8 + i8) * R + 8 * (q & 1)) * 2);
    }
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      const int cb = warp + kTcWarps * i;
      if (cb < nkb) {
        // A = X^T (16 columns x 16 rows) by ldmatrix.trans
        uint32_t a[4];
        ldsm_x4_trans(a, xg + t_off + kStep * i);
#pragma unroll
        for (int p = kParts - 1; p >= 0; --p)  // lo, mid, hi
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
            mma_bf16(acc[i][nt], a, bm[p][nt][0], bm[p][nt][1]);
      }
    }

    if (++since_flush == kFlushTiles || tg + grid >= n_tiles) {
      // add the f32 sums, in double, into the partial row (the first
      // flush writes it): c0, c1 at column g, models 2 (lane % 4) +
      // {0, 1}; c2, c3 at column g + 8
      const int g = lane >> 2, m0 = 2 * (lane & 3);
#pragma unroll
      for (int i = 0; i < NB; ++i) {
        const int cb = warp + kTcWarps * i;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = cb * kKb + g + 8 * (e >> 1);
            const int k = nt * 8 + m0 + (e & 1);
            if (cb < nkb && col < dl && k < kg) {
              double* at = part + (long long)k * (d + 2) + c0 + col;
              *at = (flushed ? *at : 0.0) + (double)acc[i][nt][e];
            }
            acc[i][nt][e] = 0.0f;
          }
      }
      flushed = true;
      since_flush = 0;
    }
    if constexpr (!kCodes && S == 1) {
      __syncthreads();  // the stage is free
      if (copier) issue(j + 1, 0);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is idle: the final sums reuse it

  // a CTA with no tile still writes its (zero) partial row
  if (!flushed) {
    const int g = lane >> 2, m0 = 2 * (lane & 3);
    for (int i = 0; i < NB; ++i)
      for (int nt = 0; nt < NT; ++nt)
        for (int e = 0; e < 4; ++e) {
          const int cb = warp + kTcWarps * i;
          const int col = cb * kKb + g + 8 * (e >> 1);
          const int k = nt * 8 + m0 + (e & 1);
          if (cb < nkb && col < dl && k < kg)
            part[(long long)k * (d + 2) + c0 + col] = 0.0;
        }
  }

  // fold the entries' loss, msum and w sums in row order, in double
  double* s_red = reinterpret_cast<double*>(smem);  // [R * KG][2], [R]
  if (tid < kEpi) s_red[2 * entry + 1 - sub] = (double)sum_s - (double)sum_c;
  if (sub == 0 && ek == 0) s_red[2 * R * KG + er] = (double)w_s - (double)w_c;
  __syncthreads();
  // every CTA of a cluster holds the same sums: rank 0 writes them
  if (tid < kg && rank == 0) {
    double l = 0.0, ms = 0.0;
    for (int r = 0; r < R; ++r) {
      l += s_red[2 * (r * KG + tid)];
      ms += s_red[2 * (r * KG + tid) + 1];
    }
    part[(long long)tid * (d + 2) + d] = l;
    part[(long long)tid * (d + 2) + d + 1] = ms;
  }
  if (tid == 0 && rank == 0) {
    double ws = 0.0;
    for (int r = 0; r < R; ++r) ws += s_red[2 * R * KG + r];
    part[(long long)kg * (d + 2)] = ws;
  }
  // no CTA leaves while another may still read its margins
  if constexpr (CL > 1) cluster_sync();
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

// ===========================================================================
// The wide instances (d > 2048): two passes
// ===========================================================================

constexpr int kWRows = 128;            // rows of a margin tile, 16 a warp
constexpr int kWCols = 64;             // columns of a margin chunk
constexpr int kWUnits = kWRows * kWCols / 8 / kThreads;  // X units a thread
constexpr int kWGradCols = 512;        // columns of a tensor-core gradient CTA
constexpr int kWGradRows = 16;         // rows of a gradient stage (mma's K)
constexpr int kWFmaCols = 4 * kThreads;  // columns of an FMA gradient CTA
constexpr int kWFmaRows = 64;          // rows of staged FMA multipliers
constexpr int kWTcModels = 8;          // KG of the tensor-core instances
static_assert(kWUnits == 4, "four 8-element units a thread a chunk");

// 4 consecutive f32 elements of row r from column c0, zeros past d or for
// a dead row; vec: one 16-byte load (d % 4 == 0 and an aligned base)
__device__ __forceinline__ float4 load4(const float* __restrict__ x,
                                        long long r, int c0, int d,
                                        bool live, bool vec) {
  const float* xr = x + r * d;
  if (vec)
    return (live && c0 < d) ? __ldg(reinterpret_cast<const float4*>(xr + c0))
                            : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  float v[4];
#pragma unroll
  for (int e = 0; e < 4; ++e)
    v[e] = (live && c0 + e < d) ? __ldg(xr + c0 + e) : 0.0f;
  return make_float4(v[0], v[1], v[2], v[3]);
}

// the label of (row r, model k) at row stride ldy, f32 or bf16
__device__ __forceinline__ float label_at(const void* __restrict__ y,
                                          int y_bf16, long long ldy,
                                          long long r, int k) {
  const long long at = r * ldy + k;
  return y_bf16 ? __bfloat162float(
                      reinterpret_cast<const __nv_bfloat16*>(y)[at])
                : __ldg(reinterpret_cast<const float*>(y) + at);
}

// The margin tile's epilogue: s_m holds the tile's margins (kWRows x KG
// f32, row-major, without the offsets). Thread t owns model t % KG of
// rows t / KG + (kThreads / KG) i; it writes their multipliers and adds to
// its Kahan sums (sum(w) by the threads of model 0, each row once).
template <int KG>
__device__ __forceinline__ void wide_epilogue(
    const float* s_m, long long r0, long long n, int kg, float off_k,
    const void* __restrict__ y, int y_bf16, long long ldy,
    const float* __restrict__ w, float* __restrict__ mult_out, float& loss_s,
    float& loss_c, float& mult_s, float& mult_c, float& w_s, float& w_c) {
  constexpr int kPer = kWRows * KG / kThreads;
  const int k = threadIdx.x % KG;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int e = threadIdx.x + kThreads * i;
    const long long r = r0 + e / KG;
    if (r >= n) continue;
    const float wv = __ldg(w + r);
    if (k == 0) kahan_add(w_s, w_c, wv);
    if (k >= kg) continue;
    const float m = s_m[e] + off_k;
    const float yv = label_at(y, y_bf16, ldy, r, k);
    const float mult = logistic_mult(m, yv, wv);
    kahan_add(loss_s, loss_c, logistic_loss(m, yv, wv));
    kahan_add(mult_s, mult_c, mult);
    mult_out[r * kg + k] = mult;
  }
}

// The threads' sums folded in thread order, in double, into this CTA's
// row of mpart (2 kg + 1 doubles: loss and sum(mult) of each model, then
// sum(w)). s_red: kThreads x 3 doubles of shared memory.
template <int KG>
__device__ __forceinline__ void wide_fold(double* s_red, int kg,
                                          float loss_s, float loss_c,
                                          float mult_s, float mult_c,
                                          float w_s, float w_c,
                                          double* __restrict__ mpart) {
  __syncthreads();  // the stages are free
  s_red[3 * threadIdx.x] = (double)loss_s - (double)loss_c;
  s_red[3 * threadIdx.x + 1] = (double)mult_s - (double)mult_c;
  s_red[3 * threadIdx.x + 2] = (double)w_s - (double)w_c;
  __syncthreads();
  double* row = mpart + (long long)blockIdx.x * (2 * kg + 1);
  const int k = threadIdx.x;
  if (k < kg) {
    double l = 0.0, ms = 0.0;
    for (int t = k; t < kThreads; t += KG) {
      l += s_red[3 * t];
      ms += s_red[3 * t + 1];
    }
    row[2 * k] = l;
    row[2 * k + 1] = ms;
  }
  if (k == 0) {
    double ws = 0.0;
    for (int t = 0; t < kThreads; t += KG) ws += s_red[3 * t + 2];
    row[2 * kg] = ws;
  }
}

// The tensor-core margin pass (bf16 X or e4m3 codes). parts: (3, kg, dp)
// bf16, zero past d (dp = d rounded up to 64); off: (kg,); mult_out: (n,
// kg) f32; mpart: gridDim.x rows of 2 kg + 1 doubles.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    glm_wide_tc_margin_kernel(const T* __restrict__ x,
                              const void* __restrict__ y, int y_bf16,
                              long long ldy, const float* __restrict__ w,
                              const __nv_bfloat16* __restrict__ parts,
                              const float* __restrict__ off, long long n,
                              int d, int kg, int vec,
                              float* __restrict__ mult_out,
                              double* __restrict__ mpart) {
  constexpr int KG = kWTcModels;
  constexpr int kPitch = kWCols * 2;                 // bytes of a staged row
  constexpr int kXBytes = kWRows * kPitch;           // 16 KB
  constexpr int kBBytes = kParts * KG * kPitch;      // 3 KB
  constexpr int kBUnits = kParts * KG * (kWCols / 8);
  constexpr int kStage = kXBytes + kBBytes;
  static_assert(kBUnits <= kThreads, "one unit of B a thread");
  static_assert(kWRows * KG * 4 <= 2 * kStage &&
                    kThreads * 3 * 8 <= 2 * kStage,
                "the margins and the fold fit in the stages");
  __shared__ __align__(128) unsigned char s_buf[2 * kStage];
  float* s_m = reinterpret_cast<float*>(s_buf);  // after a tile's chunks

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int i8 = lane & 7, q = lane >> 3;
  const int dp = pad64(d);
  const int n_chunks = (d + kWCols - 1) / kWCols;
  const long long n_tiles = (n + kWRows - 1) / kWRows;
  const float off_k = (tid % KG < kg) ? off[tid % KG] : 0.0f;
  // this lane's ldmatrix offsets in a stage: A = X rows 16 warp + 8 (q & 1)
  // + i8, chunk q >> 1 of k-block 0; B = part rows (models) i8, chunk q & 1
  const int a_off = (16 * warp + i8 + 8 * (q & 1)) * kPitch;
  const int a_chunk = q >> 1, b_chunk = q & 1;
  const int b_off = kXBytes + i8 * kPitch;

  float loss_s = 0.0f, loss_c = 0.0f, mult_s = 0.0f, mult_c = 0.0f;
  float w_s = 0.0f, w_c = 0.0f;
  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long r0 = tile * kWRows;
    uint4 xr[kWUnits], br = make_uint4(0u, 0u, 0u, 0u);
    // chunk c of the tile (X and B's parts) into registers
    auto load = [&](int c) {
#pragma unroll
      for (int i = 0; i < kWUnits; ++i) {
        const int u = tid + kThreads * i, row = u / 8, c8 = u % 8;
        xr[i] = hopper::load8(x, r0 + row, c * kWCols + c8 * 8, d,
                              r0 + row < n, vec != 0);
      }
      if (tid < kBUnits) {
        const int p = tid / (KG * 8), k = (tid / 8) % KG, c8 = tid % 8;
        br = (k < kg) ? __ldg(reinterpret_cast<const uint4*>(
                            parts + ((long long)p * kg + k) * dp +
                            c * kWCols + c8 * 8))
                      : make_uint4(0u, 0u, 0u, 0u);
      }
    };
    // the registers into stage st, swizzled: chunk c8 of row r at c8 ^ (r
    // % 8); B's rows are (part, model), each model row k at k % 8
    auto store = [&](int st) {
      unsigned char* base = s_buf + st * kStage;
#pragma unroll
      for (int i = 0; i < kWUnits; ++i) {
        const int u = tid + kThreads * i, row = u / 8, c8 = u % 8;
        *reinterpret_cast<uint4*>(base + row * kPitch +
                                  ((c8 ^ (row & 7)) << 4)) = xr[i];
      }
      if (tid < kBUnits) {
        const int p = tid / (KG * 8), k = (tid / 8) % KG, c8 = tid % 8;
        *reinterpret_cast<uint4*>(base + kXBytes + (p * KG + k) * kPitch +
                                  ((c8 ^ (k & 7)) << 4)) = br;
      }
    };

    double md[4] = {0.0, 0.0, 0.0, 0.0};  // the chunks' margins, in order
    load(0);
    store(0);
    __syncthreads();
    for (int c = 0; c < n_chunks; ++c) {
      if (c + 1 < n_chunks) load(c + 1);  // in flight during the products
      const uint32_t sb = smem_u32(s_buf + (c & 1) * kStage);
      float pm[kParts][4];
#pragma unroll
      for (int p = 0; p < kParts; ++p)
#pragma unroll
        for (int e = 0; e < 4; ++e) pm[p][e] = 0.0f;
#pragma unroll
      for (int kb = 0; kb < kWCols / kKb; ++kb) {
        uint32_t a[4];
        ldsm_x4(a, sb + a_off + (((2 * kb + a_chunk) ^ i8) << 4));
#pragma unroll
        for (int p = 0; p < kParts; ++p) {
          uint32_t b[2];
          ldsm_x2(b, sb + b_off + p * KG * kPitch +
                         (((2 * kb + b_chunk) ^ i8) << 4));
          mma_bf16(pm[p], a, b[0], b[1]);
        }
      }
      // the chunk's margins, (lo + mid) + hi, into the double sums
#pragma unroll
      for (int e = 0; e < 4; ++e)
        md[e] += (double)((pm[2][e] + pm[1][e]) + pm[0][e]);
      if (c + 1 < n_chunks) store((c + 1) & 1);
      __syncthreads();
    }
    // the warp's margins: c0, c1 at row g, models 2 (lane % 4) + {0, 1};
    // c2, c3 at row g + 8
    {
      const int g = 16 * warp + (lane >> 2), m0 = 2 * (lane & 3);
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] = (float)md[e];
      *reinterpret_cast<float2*>(s_m + g * KG + m0) = make_float2(v[0], v[1]);
      *reinterpret_cast<float2*>(s_m + (g + 8) * KG + m0) =
          make_float2(v[2], v[3]);
    }
    __syncthreads();
    wide_epilogue<KG>(s_m, r0, n, kg, off_k, y, y_bf16, ldy, w, mult_out,
                      loss_s, loss_c, mult_s, mult_c, w_s, w_c);
    __syncthreads();  // s_m is read before the next tile's first store
  }
  wide_fold<KG>(reinterpret_cast<double*>(s_buf), kg, loss_s, loss_c, mult_s,
                mult_c, w_s, w_c, mpart);
}

// The FMA margin pass (f32 X): B (kg, d) f32 as it is; otherwise as the
// tensor-core pass. Thread t owns model t % KG of rows t / KG + (256 /
// KG) i; X and B are staged at a row pitch of 65 floats, so a warp's rows
// and models fall on distinct banks.
template <int KG>
__global__ void __launch_bounds__(kThreads)
    glm_wide_fma_margin_kernel(const float* __restrict__ x,
                               const void* __restrict__ y, int y_bf16,
                               long long ldy, const float* __restrict__ w,
                               const float* __restrict__ B,
                               const float* __restrict__ off, long long n,
                               int d, int kg, int vec,
                               float* __restrict__ mult_out,
                               double* __restrict__ mpart) {
  constexpr int kP = kWCols + 1;                   // floats of a staged row
  constexpr int kXUnits = kWRows * kWCols / 4 / kThreads;  // float4 a thread
  constexpr int kBUnits = KG * kWCols / 4;
  constexpr int kBPer = (kBUnits + kThreads - 1) / kThreads;
  constexpr int kStage = (kWRows + KG) * kP;       // floats
  constexpr int kPer = kWRows * KG / kThreads;     // margins a thread
  constexpr int kRowStep = kThreads / KG;
  static_assert(kWRows * KG <= 2 * kStage && kThreads * 6 <= 2 * kStage,
                "the margins and the fold fit in the stages");
  extern __shared__ __align__(16) unsigned char dsmem[];
  float* s_buf = reinterpret_cast<float*>(dsmem);
  float* s_m = s_buf;

  const int tid = threadIdx.x, k = tid % KG, rq = tid / KG;
  const int n_chunks = (d + kWCols - 1) / kWCols;
  const long long n_tiles = (n + kWRows - 1) / kWRows;
  const float off_k = (k < kg) ? off[k] : 0.0f;
  float loss_s = 0.0f, loss_c = 0.0f, mult_s = 0.0f, mult_c = 0.0f;
  float w_s = 0.0f, w_c = 0.0f;
  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long r0 = tile * kWRows;
    float4 xr[kXUnits], br[kBPer];
    auto load = [&](int c) {
#pragma unroll
      for (int i = 0; i < kXUnits; ++i) {
        const int u = tid + kThreads * i, row = u / (kWCols / 4),
                  c4 = u % (kWCols / 4);
        xr[i] = load4(x, r0 + row, c * kWCols + c4 * 4, d, r0 + row < n,
                      vec != 0);
      }
#pragma unroll
      for (int i = 0; i < kBPer; ++i) {
        const int u = tid + kThreads * i, m = u / (kWCols / 4),
                  c4 = u % (kWCols / 4);
        br[i] = load4(B, m, c * kWCols + c4 * 4, d, u < kBUnits && m < kg,
                      vec != 0);
      }
    };
    auto store = [&](int st) {
      float* base = s_buf + st * kStage;
#pragma unroll
      for (int i = 0; i < kXUnits; ++i) {
        const int u = tid + kThreads * i, row = u / (kWCols / 4),
                  c4 = u % (kWCols / 4);
        float* at = base + row * kP + c4 * 4;
        at[0] = xr[i].x;
        at[1] = xr[i].y;
        at[2] = xr[i].z;
        at[3] = xr[i].w;
      }
#pragma unroll
      for (int i = 0; i < kBPer; ++i) {
        const int u = tid + kThreads * i, m = u / (kWCols / 4),
                  c4 = u % (kWCols / 4);
        if (u < kBUnits) {
          float* at = base + (kWRows + m) * kP + c4 * 4;
          at[0] = br[i].x;
          at[1] = br[i].y;
          at[2] = br[i].z;
          at[3] = br[i].w;
        }
      }
    };

    double accd[kPer];  // the chunks' margins, in order
#pragma unroll
    for (int i = 0; i < kPer; ++i) accd[i] = 0.0;
    load(0);
    store(0);
    __syncthreads();
    for (int c = 0; c < n_chunks; ++c) {
      if (c + 1 < n_chunks) load(c + 1);
      const float* st = s_buf + (c & 1) * kStage;
      const float* bk = st + (kWRows + k) * kP;
      float acc[kPer];
#pragma unroll
      for (int i = 0; i < kPer; ++i) acc[i] = 0.0f;
#pragma unroll 8
      for (int j = 0; j < kWCols; ++j) {
        const float b = bk[j];
#pragma unroll
        for (int i = 0; i < kPer; ++i)
          acc[i] = fmaf(st[(rq + kRowStep * i) * kP + j], b, acc[i]);
      }
#pragma unroll
      for (int i = 0; i < kPer; ++i) accd[i] += (double)acc[i];
      if (c + 1 < n_chunks) store((c + 1) & 1);
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < kPer; ++i)
      s_m[(rq + kRowStep * i) * KG + k] = (float)accd[i];
    __syncthreads();
    wide_epilogue<KG>(s_m, r0, n, kg, off_k, y, y_bf16, ldy, w, mult_out,
                      loss_s, loss_c, mult_s, mult_c, w_s, w_c);
    __syncthreads();
  }
  wide_fold<KG>(reinterpret_cast<double*>(dsmem), kg, loss_s, loss_c,
                mult_s, mult_c, w_s, w_c, mpart);
}

// Adds an f32 gradient sum, in double, into its entry of the slab's row
// (the first flush writes it).
__device__ __forceinline__ void wide_flush_one(double* at, float v,
                                               bool flushed) {
  *at = (flushed ? *at : 0.0) + (double)v;
}

// The tensor-core gradient pass: CTA (block, slab) sums M_k^T X over the
// slab's rows for the block's 512 columns and the KG = 8 models. mult:
// (n, kg) f32; gpart: gridDim.y rows of kg d doubles (model-major).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    glm_wide_tc_grad_kernel(const T* __restrict__ x,
                            const float* __restrict__ mult, long long n,
                            int d, int kg, int vec, long long slab_rows,
                            double* __restrict__ gpart) {
  constexpr int KG = kWTcModels;
  constexpr int R = kWGradRows;
  constexpr int kPitch = kWGradCols * 2;        // 1,024 bytes a staged row
  constexpr int kXBytes = R * kPitch;           // 16 KB
  constexpr int kMBytes = kParts * KG * R * 2;  // the multipliers' parts
  constexpr int kStage = kXBytes + kMBytes;
  constexpr int kUnits = R * kWGradCols / 8 / kThreads;  // 4
  constexpr int kNb = kWGradCols / kKb / kWarps;         // k-blocks a warp
  __shared__ __align__(128) unsigned char s_buf[2 * kStage];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int i8 = lane & 7, q = lane >> 3;
  const int col0 = blockIdx.x * kWGradCols;
  const long long lo = (long long)blockIdx.y * slab_rows;
  const long long hi = (lo + slab_rows < n) ? lo + slab_rows : n;
  double* part = gpart + (long long)blockIdx.y * kg * d;
  // A = X^T by ldmatrix.trans: rows 8 (q >> 1) + i8, chunk q & 1 of the
  // warp's k-block; every row is 8k + i8
  const int t_row = (i8 + 8 * (q >> 1)) * kPitch;

  float acc[kNb][4];
#pragma unroll
  for (int i = 0; i < kNb; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.0f;
  bool flushed = false;
  constexpr int kFlushStages = kFlushRows / R;
  int since_flush = 0;

  uint4 xr[kUnits];
  float mr = 0.0f;  // one multiplier a thread (KG x R = 128 of them)
  auto load = [&](long long r0) {
#pragma unroll
    for (int i = 0; i < kUnits; ++i) {
      const int u = tid + kThreads * i, row = u / (kWGradCols / 8),
                c8 = u % (kWGradCols / 8);
      xr[i] = hopper::load8(x, r0 + row, col0 + c8 * 8, d, r0 + row < hi,
                            vec != 0);
    }
    if (tid < KG * R) {
      const int k = tid / R, r = tid % R;
      mr = (k < kg && r0 + r < hi) ? __ldg(mult + (r0 + r) * kg + k) : 0.0f;
    }
  };
  // X swizzled (chunk c8 of row r at c8 ^ (r % 8)), and the multiplier's
  // three bf16 parts at [p][k][r] (models as mma's N, rows as its K)
  auto store = [&](int st) {
    unsigned char* base = s_buf + st * kStage;
#pragma unroll
    for (int i = 0; i < kUnits; ++i) {
      const int u = tid + kThreads * i, row = u / (kWGradCols / 8),
                c8 = u % (kWGradCols / 8);
      *reinterpret_cast<uint4*>(base + row * kPitch +
                                ((c8 ^ (row & 7)) << 4)) = xr[i];
    }
    if (tid < KG * R) {
      __nv_bfloat16* mp = reinterpret_cast<__nv_bfloat16*>(base + kXBytes);
      const __nv_bfloat16 h = __float2bfloat16_rn(mr);
      const float r1 = mr - __bfloat162float(h);
      const __nv_bfloat16 md = __float2bfloat16_rn(r1);
      const __nv_bfloat16 l = __float2bfloat16_rn(r1 - __bfloat162float(md));
      mp[tid] = h;  // tid = k R + r
      mp[KG * R + tid] = md;
      mp[2 * KG * R + tid] = l;
    }
  };

  const long long n_stages = (hi > lo) ? (hi - lo + R - 1) / R : 0;
  if (n_stages > 0) {
    load(lo);
    store(0);
  }
  __syncthreads();
  for (long long j = 0; j < n_stages; ++j) {
    const long long r0 = lo + j * R;
    if (j + 1 < n_stages) load(r0 + R);
    const uint32_t sb = smem_u32(s_buf + (int)(j & 1) * kStage);
    uint32_t bm[kParts][2];
#pragma unroll
    for (int p = 0; p < kParts; ++p)
      ldsm_x2(bm[p], sb + kXBytes + ((p * KG + i8) * R + 8 * (q & 1)) * 2);
#pragma unroll
    for (int i = 0; i < kNb; ++i) {
      const int cb = warp * kNb + i;  // the CTA's k-block
      uint32_t a[4];
      ldsm_x4_trans(a, sb + t_row + (((2 * cb + (q & 1)) ^ i8) << 4));
#pragma unroll
      for (int p = kParts - 1; p >= 0; --p)  // lo, mid, hi
        mma_bf16(acc[i], a, bm[p][0], bm[p][1]);
    }
    if (j + 1 < n_stages) store((int)((j + 1) & 1));
    if (++since_flush == kFlushStages || j + 1 == n_stages) {
      // c0, c1 at column g, models 2 (lane % 4) + {0, 1}; c2, c3 at g + 8
      const int g = lane >> 2, m0 = 2 * (lane & 3);
#pragma unroll
      for (int i = 0; i < kNb; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = col0 + (warp * kNb + i) * kKb + g + 8 * (e >> 1);
          const int k = m0 + (e & 1);
          if (col < d && k < kg)
            wide_flush_one(part + (long long)k * d + col, acc[i][e],
                           flushed);
          acc[i][e] = 0.0f;
        }
      flushed = true;
      since_flush = 0;
    }
    __syncthreads();
  }
  if (!flushed) {  // an empty slab still writes its (zero) row
    const int g = lane >> 2, m0 = 2 * (lane & 3);
    for (int i = 0; i < kNb; ++i)
      for (int e = 0; e < 4; ++e) {
        const int col = col0 + (warp * kNb + i) * kKb + g + 8 * (e >> 1);
        const int k = m0 + (e & 1);
        if (col < d && k < kg) part[(long long)k * d + col] = 0.0;
      }
  }
}

// The FMA gradient pass (f32 X): thread t owns columns col0 + 4t .. + 3 of
// the block for the KG models; the slab's multipliers are staged
// kWFmaRows rows at a time.
template <int KG>
__global__ void __launch_bounds__(kThreads)
    glm_wide_fma_grad_kernel(const float* __restrict__ x,
                             const float* __restrict__ mult, long long n,
                             int d, int kg, int vec, long long slab_rows,
                             double* __restrict__ gpart) {
  __shared__ __align__(16) float s_mult[kWFmaRows * KG];
  const int tid = threadIdx.x;
  const int c0 = blockIdx.x * kWFmaCols + 4 * tid;
  const long long lo = (long long)blockIdx.y * slab_rows;
  const long long hi = (lo + slab_rows < n) ? lo + slab_rows : n;
  double* part = gpart + (long long)blockIdx.y * kg * d;
  float acc[4][KG];
#pragma unroll
  for (int c = 0; c < 4; ++c)
#pragma unroll
    for (int k = 0; k < KG; ++k) acc[c][k] = 0.0f;
  bool flushed = false;
  long long since_flush = 0;
  auto flush = [&]() {
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int k = 0; k < KG; ++k) {
        if (c0 + c < d && k < kg)
          wide_flush_one(part + (long long)k * d + c0 + c, acc[c][k],
                         flushed);
        acc[c][k] = 0.0f;
      }
    flushed = true;
  };
  for (long long t0 = lo; t0 < hi; t0 += kWFmaRows) {
    __syncthreads();  // the last tile's multipliers are read
    for (int i = tid; i < kWFmaRows * KG; i += kThreads) {
      const long long r = t0 + i / KG;
      const int k = i % KG;
      s_mult[i] = (r < hi && k < kg) ? __ldg(mult + r * kg + k) : 0.0f;
    }
    __syncthreads();
    const int rows = (int)((hi - t0 < kWFmaRows) ? hi - t0 : kWFmaRows);
#pragma unroll 1
    for (int r = 0; r < rows; r += 4) {
      float4 xv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        xv[j] = load4(x, t0 + r + j, c0, d, r + j < rows, vec != 0);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float* m = s_mult + (r + j) * KG;  // zeros past the slab
#pragma unroll
        for (int k = 0; k < KG; ++k) {
          const float mk = m[k];
          acc[0][k] = fmaf(mk, xv[j].x, acc[0][k]);
          acc[1][k] = fmaf(mk, xv[j].y, acc[1][k]);
          acc[2][k] = fmaf(mk, xv[j].z, acc[2][k]);
          acc[3][k] = fmaf(mk, xv[j].w, acc[3][k]);
        }
      }
    }
    since_flush += rows;
    if (since_flush >= kFlushRows) {
      flush();
      since_flush = 0;
    }
  }
  flush();  // the rest, or the (zero) row of an empty slab
}

// out: per model k, [grad_k (d), loss_k, msum_k] at k (d + 2), then
// sum(w): the slabs' gradient rows and the margin CTAs' rows, each summed
// in order in double, rounded once to f32.
__global__ void glm_wide_reduce_kernel(const double* __restrict__ gpart,
                                       int n_slabs,
                                       const double* __restrict__ mpart,
                                       int n_ctas, int d, int kg,
                                       float* __restrict__ out) {
  const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long n_grad = (long long)kg * d;
  double s = 0.0;
  if (j < n_grad) {
    for (int c = 0; c < n_slabs; ++c) s += gpart[(long long)c * n_grad + j];
    out[(j / d) * (d + 2) + j % d] = (float)s;
  } else if (j < n_grad + 2 * kg + 1) {
    const int m = (int)(j - n_grad);
    for (int c = 0; c < n_ctas; ++c) s += mpart[(long long)c * (2 * kg + 1) + m];
    const long long at = (m < 2 * kg) ? (long long)(m / 2) * (d + 2) + d + m % 2
                                      : (long long)kg * (d + 2);
    out[at] = (float)s;
  }
}

// ===========================================================================
// Host side: instances
// ===========================================================================

struct Instance {
  const void* fn;  // a kernel instance, nullptr when none takes the shape
  int threads;     // a CTA's
  int item;        // bytes per element of X
  int rows;        // rows of a tile
  int stages;
  int tiles;       // e4m3 on the tensor cores: bf16 tiles
  int kg;          // models of the instance (KG)
  bool tc;         // the tensor-core instance
  int cluster;     // CTAs a cluster (the wide tensor-core instance), else 1
};

template <int C, int KG>
Instance make_fma() {
  using P = Plan<C, KG>;
  return {reinterpret_cast<const void*>(&glm_stacked_kernel<C, KG>),
          kThreads, 4, P::kRows, P::kStages, 0, KG, false, 1};
}

template <int C>
Instance fma_models(int kg) {
  if (kg <= 4) return make_fma<C, 4>();
  if (kg <= 8) return make_fma<C, 8>();
  return make_fma<C, 16>();
}

Instance fma_instance(int d, int kg) {
  const int c = (d + 255) / 256;
  if (c <= 2) return fma_models<2>(kg);
  if (c <= 4) return fma_models<4>(kg);
  if (c <= 6) return fma_models<6>(kg);
  return fma_models<8>(kg);
}

template <typename T, int NB, int KG, int CL = 1>
Instance make_tc() {
  using P = TcPlan<T, NB, KG, CL>;
  return {reinterpret_cast<const void*>(
              &glm_stacked_tc_kernel<T, NB, KG, CL>),
          kTcThreads, (int)sizeof(T), kTcRows, P::kStages, P::kTiles, KG,
          true, CL};
}

// k-blocks a warp takes at width d, rounded up to an instance's NB
constexpr int kNbs[] = {1, 2, 3, 4, 5, 6, 8};
int nb_of(int d) {
  const int per_warp = ((d + kKb - 1) / kKb + kTcWarps - 1) / kTcWarps;
  for (int nb : kNbs)
    if (per_warp <= nb) return nb;
  return 0;
}

template <typename T>
Instance tc_instance(int d, int kg) {
  const Instance none = {nullptr, 0, 0, 0, 0, 0, 0, false, 1};
  const int nb = nb_of(d);
  if (kg <= 8) {
    switch (nb) {
      case 1: return make_tc<T, 1, 8>();
      case 2: return make_tc<T, 2, 8>();
      case 3: return make_tc<T, 3, 8>();
      case 4: return make_tc<T, 4, 8>();
      case 5: return make_tc<T, 5, 8>();
      case 6: return make_tc<T, 6, 8>();
      case 8: return make_tc<T, 8, 8>();
      default: return none;
    }
  }
  switch (nb) {
    case 1: return make_tc<T, 1, 16>();
    case 2: return make_tc<T, 2, 16>();
    case 3: return make_tc<T, 3, 16>();
    case 4: return make_tc<T, 4, 16>();
    case 5: return make_tc<T, 5, 16>();
    default: return none;
  }
}

// The wide tensor-core instance (2048 < d <= 8192): a cluster of CL = 4
// CTAs up to d = 4096, 8 past it, each CTA dc = pad64(ceil(d / CL))
// columns (577 to 1024: three or four k-blocks a warp), KG = 8 or 16.
int cluster_of(int d) { return d <= 4096 ? 4 : 8; }
int slice_of(int d) {
  const int cl = cluster_of(d);
  return pad64((d + cl - 1) / cl);
}

template <typename T>
Instance tc_cluster_instance(int d, int kg) {
  const int cl = cluster_of(d), nb = nb_of(slice_of(d));
  if (kg <= 8) {
    if (cl == 4) return nb == 3 ? make_tc<T, 3, 8, 4>() : make_tc<T, 4, 8, 4>();
    return nb == 3 ? make_tc<T, 3, 8, 8>() : make_tc<T, 4, 8, 8>();
  }
  if (cl == 4) return nb == 3 ? make_tc<T, 3, 16, 4>() : make_tc<T, 4, 16, 4>();
  return nb == 3 ? make_tc<T, 3, 16, 8>() : make_tc<T, 4, 16, 8>();
}

// models one launch takes for (dtype, d): 16, or 8 on the tensor cores
// past d = 1280 up to 2048 and in the two-pass instance past 8192; 0 for
// a shape no instance takes
int group_of(int dtype, int d) {
  if (d < 1 || dtype < 0 || dtype > 2) return 0;
  if (d > kWideMaxD) return dtype == 0 ? kMaxModels : kWTcModels;
  if (dtype == 0 || d > kMaxD) return kMaxModels;
  return nb_of(d) <= kTcMaxNb16 ? 16 : 8;
}

// A wide instance: its two kernels, the margin kernel's dynamic shared
// memory, and the columns of a gradient CTA.
struct WideInstance {
  const void* margin;
  const void* grad;
  size_t margin_smem;
  int cols;
};

template <int KG>
WideInstance wide_fma() {
  return {reinterpret_cast<const void*>(&glm_wide_fma_margin_kernel<KG>),
          reinterpret_cast<const void*>(&glm_wide_fma_grad_kernel<KG>),
          (size_t)2 * (kWRows + KG) * (kWCols + 1) * 4, kWFmaCols};
}

template <typename T>
WideInstance wide_tc() {
  return {reinterpret_cast<const void*>(&glm_wide_tc_margin_kernel<T>),
          reinterpret_cast<const void*>(&glm_wide_tc_grad_kernel<T>), 0,
          kWGradCols};
}

// the two-pass instance for (dtype, d > 2048, kg): the route of f32 X past
// d = 2048 and of every dtype past 8192, and at any wide d for a
// comparison in one run (8 models a launch on the tensor cores, 16 on the
// FMAs); margin == nullptr when none
WideInstance wide_for(int dtype, int d, int kg) {
  const WideInstance none = {nullptr, nullptr, 0, 0};
  if (d <= kMaxD || kg < 1 || dtype < 0 || dtype > 2 ||
      kg > (dtype == 0 ? kMaxModels : kWTcModels))
    return none;
  if (dtype == 0) return kg <= 8 ? wide_fma<8>() : wide_fma<16>();
  if (dtype == 1) return wide_tc<__nv_bfloat16>();
  return wide_tc<__nv_fp8_e4m3>();
}

// the instance of one read for (dtype, d, kg): narrow up to d = 2048, the
// wide tensor-core one (bf16, e4m3) up to 8192; fn == nullptr when none
// takes them
Instance instance_for(int dtype, int d, int kg) {
  const Instance none = {nullptr, 0, 0, 0, 0, 0, 0, false, 1};
  if (d > kWideMaxD || kg < 1 || kg > group_of(dtype, d)) return none;
  if (d > kMaxD) {
    if (dtype == 1) return tc_cluster_instance<__nv_bfloat16>(d, kg);
    if (dtype == 2) return tc_cluster_instance<__nv_fp8_e4m3>(d, kg);
    return none;
  }
  if (dtype == 0) return fma_instance(d, kg);
  if (dtype == 1) return tc_instance<__nv_bfloat16>(d, kg);
  return tc_instance<__nv_fp8_e4m3>(d, kg);
}

// a CTA's staged width: its slice in a cluster, else d rounded up to 64
int staged_width(const Instance& inst, int d) {
  return inst.cluster > 1 ? slice_of(d) : pad64(d);
}

size_t smem_for(const Instance& inst, int d) {
  return inst.tc ? tc_smem(inst.item, inst.stages, inst.tiles, inst.kg,
                           staged_width(inst, d), inst.cluster)
                 : smem_bytes(inst.stages, inst.rows, inst.kg, d);
}

// the launch of a tensor-core instance: a grid of `parts` CTAs, or of
// `parts` clusters of inst.cluster CTAs
cudaLaunchConfig_t launch_config(const Instance& inst, int parts,
                                 size_t smem, cudaStream_t s,
                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)parts * inst.cluster);
  cfg.blockDim = dim3(inst.threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = inst.cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = inst.cluster > 1 ? 1 : 0;
  return cfg;
}

}  // namespace

extern "C" {

// Largest d the narrow instances take; past it the wide ones run.
int glm_stacked_max_d() { return kMaxD; }

// Largest d the one-read wide instance (bf16 X, e4m3 codes) takes; past it
// the two-pass one runs.
int glm_stacked_wide_max_d() { return kWideMaxD; }

// Models one launch takes for X of (dtype, d): the wrapper's group size
// (0 when no instance takes d). dtype: 0 = float32 X, 1 = bfloat16 X,
// 2 = float8_e4m3fn codes.
int glm_stacked_group(int dtype, int d) { return group_of(dtype, d); }

// Partial rows a sweep of n rows of (dtype, d) for kg models uses on the
// current device: CTAs of a narrow instance, clusters of the wide one (as
// many as are resident at once, at most one per tile, at least one).
int glm_stacked_num_parts(int dtype, int d, int kg, long long n,
                          int* n_parts) {
  const Instance inst = instance_for(dtype, d, kg);
  if (inst.fn == nullptr || n < 0) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_for(inst, d);
  cudaError_t err = cudaFuncSetAttribute(
      inst.fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  if (inst.cluster > 1) {
    // clusters resident at once (a cluster's CTAs on SMs of one GPC)
    cudaLaunchAttribute attr;
    cudaLaunchConfig_t cfg = launch_config(inst, sms / inst.cluster, smem,
                                           0, &attr);
    err = cudaOccupancyMaxActiveClusters(&per_sm, inst.fn, &cfg);
    if (err != cudaSuccess) return (int)err;
    sms = 1;  // per_sm is the cluster count
  } else {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, inst.fn,
                                                        inst.threads, smem);
  }
  if (err != cudaSuccess) return (int)err;
  long long parts = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const long long tiles = (n + inst.rows - 1) / inst.rows;
  if (tiles < parts) parts = tiles;
  if (parts < 1) parts = 1;
  *n_parts = (int)parts;
  return 0;
}

// The partial rows of a two-pass sweep (d > 2048) of n rows for kg models
// on the current device: the margin pass's CTAs (as many as are resident,
// at most one per 128-row tile) and the gradient pass's row slabs (one per
// SM, at most one per 16 rows), each at least one.
int glm_stacked_two_pass_parts(int dtype, int d, int kg, long long n,
                               int* n_ctas, int* n_slabs) {
  const WideInstance inst = wide_for(dtype, d, kg);
  if (inst.margin == nullptr || n < 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      inst.margin, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)inst.margin_smem);
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, inst.margin, kThreads, inst.margin_smem);
  if (err != cudaSuccess) return (int)err;
  long long ctas = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const long long tiles = (n + kWRows - 1) / kWRows;
  if (tiles < ctas) ctas = tiles;
  long long slabs = sms;
  const long long stages = (n + kWGradRows - 1) / kWGradRows;
  if (stages < slabs) slabs = stages;
  *n_ctas = (int)(ctas < 1 ? 1 : ctas);
  *n_slabs = (int)(slabs < 1 ? 1 : slabs);
  return 0;
}

// One two-pass sweep (d > 2048) of kg models (at most 8 for bf16 X and
// e4m3 codes, 16 for f32 X). x, y, y_bf16, ldy, w, B, off, out as for
// glm_stacked_launch; mult: n kg floats of scratch; mpart: n_ctas (2 kg +
// 1) and gpart: n_slabs kg d doubles of scratch
// (glm_stacked_two_pass_parts).
int glm_stacked_two_pass_launch(int dtype, const void* x, const void* y,
                                int y_bf16, long long ldy, const float* w,
                                const void* B, const float* off, long long n,
                                int d, int kg, float* mult, double* mpart,
                                int n_ctas, double* gpart, int n_slabs,
                                float* out, void* stream) {
  const WideInstance inst = wide_for(dtype, d, kg);
  if (inst.margin == nullptr || n_ctas < 1 || n_slabs < 1 || n < 0 ||
      ldy < kg)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      inst.margin, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)inst.margin_smem);
  if (err != cudaSuccess) return (int)err;
  // whole 16-byte loads where the row width and X's base allow them: 4
  // f32, 8 bf16 or 8 e4m3 codes (8 bytes); else element by element
  const int item = dtype == 0 ? 4 : dtype == 1 ? 2 : 1;
  const int per = dtype == 0 ? 4 : 8;
  const int vec = (d % per == 0) &&
                  reinterpret_cast<uintptr_t>(x) % (size_t)(per * item) == 0;
  long long slab_rows = (n + n_slabs - 1) / n_slabs;
  if (slab_rows < 1) slab_rows = 1;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  void* margs[] = {const_cast<void**>(&x), const_cast<void**>(&y), &y_bf16,
                   &ldy, &w, const_cast<void**>(&B), &off, &n, &d, &kg,
                   const_cast<int*>(&vec), &mult, &mpart};
  err = cudaLaunchKernel(inst.margin, dim3(n_ctas), dim3(kThreads), margs,
                         inst.margin_smem, s);
  if (err == cudaSuccess) err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int blocks = (d + inst.cols - 1) / inst.cols;
  void* gargs[] = {const_cast<void**>(&x), &mult, &n, &d, &kg,
                   const_cast<int*>(&vec), &slab_rows, &gpart};
  err = cudaLaunchKernel(inst.grad, dim3(blocks, n_slabs), dim3(kThreads),
                         gargs, 0, s);
  if (err == cudaSuccess) err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long width = (long long)kg * d + 2 * kg + 1;
  glm_wide_reduce_kernel<<<(unsigned)((width + 255) / 256), 256, 0, s>>>(
      gpart, n_slabs, mpart, n_ctas, d, kg, out);
  return (int)cudaGetLastError();
}

// One sweep of kg models (kg <= glm_stacked_group(dtype, d)). x: (n, d)
// row-major at storage width; y: labels of the group's first model, row
// stride ldy elements, float32 (y_bf16 = 0) or bfloat16 (1; for bf16 X and
// e4m3 codes only with kg and ldy even and y 4-byte aligned); w: (n,) f32;
// B: for float32 X the (kg, d) f32 coefficients, row-major; for bf16 X
// and e4m3 codes their three bf16 parts (hi, mid, lo), (3, kg, dp) with dp
// = d rounded up to 64, zero past d; off: (kg,) f32; partials: n_parts *
// (kg*(d+2)+1) doubles of scratch; out: kg*(d+2)+1 floats, written as
// [grad_k (d), loss_k, msum_k] for each model k, then sum(w).
int glm_stacked_launch(int dtype, const void* x, const void* y, int y_bf16,
                       long long ldy, const float* w, const void* B,
                       const float* off, long long n, int d, int kg,
                       double* partials, int n_parts, float* out,
                       void* stream) {
  const Instance inst = instance_for(dtype, d, kg);
  if (inst.fn == nullptr || n_parts < 1 || n < 0 || ldy < kg)
    return (int)cudaErrorInvalidValue;
  // the tensor-core instance copies bf16 labels two at a time
  if (inst.tc && y_bf16 &&
      (kg % 2 != 0 || ldy % 2 != 0 || reinterpret_cast<uintptr_t>(y) % 4))
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_for(inst, d);
  cudaError_t err = cudaFuncSetAttribute(
      inst.fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  // the widest copy that the row width and X's base both allow: 16, 8 or
  // 4 bytes; else element by element (the FMA instance's 0, the
  // tensor-core instance's element bytes)
  const size_t row_bytes = (size_t)d * inst.item;
  const uintptr_t base = reinterpret_cast<uintptr_t>(x);
  int vec = inst.tc ? inst.item : 0;
  for (int v = 16; v >= 4; v >>= 1) {
    if (row_bytes % v == 0 && base % v == 0) {
      vec = v;
      break;
    }
  }
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  int dc = staged_width(inst, d);
  if (inst.tc) {
    void* args[] = {const_cast<void**>(&x), const_cast<void**>(&y),
                    &y_bf16, &ldy, &w, const_cast<void**>(&B), &off, &n, &d,
                    &kg, &vec, &dc, &partials};
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg =
        launch_config(inst, n_parts, smem, s, &attr);
    err = cudaLaunchKernelExC(&cfg, inst.fn, args);
  } else {
    void* args[] = {const_cast<void**>(&x), const_cast<void**>(&y),
                    &y_bf16, &ldy, &w, const_cast<void**>(&B), &off, &n, &d,
                    &kg, &vec, &partials};
    err = cudaLaunchKernel(inst.fn, dim3(n_parts), dim3(inst.threads), args,
                           smem, s);
  }
  if (err == cudaSuccess) err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int width = kg * (d + 2) + 1;
  glm_stacked_reduce_kernel<<<(width + 255) / 256, 256, 0, s>>>(
      partials, n_parts, width, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
