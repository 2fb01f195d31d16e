// Gramian X^T X for Hopper (sm_90a), with padding rows masked by weight.
//
// Replaces cycloneml_tpu/ops/kernels.py:fused_gramian (the Pallas kernel
// behind RowMatrix.compute_gramian, and through it covariance, principal
// components, the small-d SVD and PCA):
//   G = sum over rows r of (x~_r [w_r > 0])^T (x~_r [w_r > 0])
// in float32, from float32, bfloat16 or float8_e4m3fn X, where x~ = x o s
// with the fp8 rung's per-column scale s (the reference's x_scale operand,
// kernels.py:501; null for no scale).
//
// Two instances, picked by X's dtype:
// - bf16 and e4m3 X: the tensor cores (gramian_tc_kernel), wgmma bf16 x
//   bf16 -> f32. The reference runs the products at Precision.HIGHEST.
//   A bf16 x bf16 product is exact in float32, and every e4m3 code is a
//   bf16 value, so the tensor cores form exactly HIGHEST's products and
//   sum them in float32: the same function, at the bf16 tensor-core rate.
// - f32 X: float32 FMAs (gramian_fma_kernel). A tensor-core product of f32
//   values would need 3xTF32 or a six-pass bf16 split to stay f32-exact,
//   and no fit on the card hands K4 an f32 X at these shapes; that is
//   later work (ROADMAP Queue 2b).
//
// Bound at n=400k, d=2000: the upper triangle is n d (d + 1) = 1.6 TFLOP,
// 1.62 ms at 989 TFLOP/s (bf16 tensor cores); X is 1.6 GB in bf16 (0.48
// ms at 3.35 TB/s), 0.8 GB in e4m3. At the f32 FMA rate (67 TFLOP/s) the
// same work takes 23.9 ms.
//
// Design of the tensor-core instance, and the arithmetic behind it:
// - Only the upper-triangle 128 x 128 tiles of G are computed (136 at
//   d=2000); the reduction pass writes each sum to (i, j) and (j, i) from
//   the same partials in the same order, so G == G^T bitwise.
// - Rows are split across CTAs; grid = tiles x splits, one CTA of two
//   warpgroups per SM (192 KB of shared memory for stages), the tile index
//   running fastest, so the CTAs running at one time are about one split's
//   tiles, which walk the same rows at the same pace: device memory sees X
//   about once and L2 serves the re-reads. gramian_plan takes at most 16
//   waves of CTAs in all (the scratch is one 128 KB double partial a CTA:
//   at most 16 x 132 x 128 KB = 264 MB on 132 SMs, whatever n), and of
//   those counts the one whose last wave is fullest: 15 splits at d=2000
//   (2,040 CTAs in 16 waves, 97% full, 255 MB), 33 at d=777 (100%).
// - Each warpgroup owns 64 rows of the tile and runs m64n128k16: A is
//   the tile's column block ti, B the block tj, both MN-major (the
//   reduction runs over X's rows), so both are staged from row-major X as
//   they lie. A stage is 64 rows of both column blocks (2 x 16 KB) in the
//   128-byte swizzled layout, in a ring of six; a diagonal tile stages one
//   block and reads it as A and B. Each product waits only for the one
//   before it, so the tensor cores work while the next stage is set up.
// - Staging, with no masked copy of X: a masked or out-of-range row's
//   chunks are copied with a source size of 0 (zero fill), or loaded as
//   zeros.
//   - bf16 rows with d % 8 == 0: cp.async, 16 bytes a thread, four 64-row
//     stages (128 KB) in flight ahead of the product.
//   - e4m3 rows with d % 16 == 0: cp.async of the codes (16 a thread, four
//     code stages ahead), each thread converting its own codes exactly to
//     bf16 into one of three stages just before the product. wgmma
//     transposes only 16-bit operands in shared memory, and fp8 wgmma
//     would need its low-precision accumulator promoted, so e4m3 runs the
//     same bf16 MMAs over half the bytes of device memory. Loading the
//     codes into registers one stage ahead instead (the ragged path
//     below) leaves their latency exposed: 2.4x slower at 400k x 2000
//     (chip_smoke.py times both, PERF.md §6).
//   - Ragged rows (a bf16 row of 1,554 bytes at d=777, an e4m3 row of 777
//     bytes: strides cp.async cannot take) are loaded into registers one
//     stage ahead, element by element, and stored after the next product
//     is started; nothing is padded in memory.
// - The fold. Float32 sums stay short: the tensor cores sum at most 1024
//   rows into the accumulators, which are then added to a second float32
//   register tile and restart from zero; every 32 such folds (a window of
//   32,768 rows) and at its last row the CTA adds that tile into its
//   double partial in device memory. A float32 running sum over ~100k
//   rows of squares drifts upward (small squares round unevenly into a
//   large sum; PERF.md §6); a sum of at most 32 fold sums does not.
//   Folding every 1024 rows into device memory, as the FMA instance does,
//   would move 256 KB per fold, ~10 us at one SM's ~25 GB/s share of HBM,
//   against ~4.5 us for the 33.5 MFLOP of products it follows (one SM's
//   share of 989 TFLOP/s); a window follows 32 times that work. At 400k x
//   2000 a CTA's 26,688 rows are one window, so each partial is written
//   once (255 MB in all) and read once by the reduction.
// - Re-read traffic. Each CTA stages both column blocks of its rows: 256
//   columns x 2 bytes per row, 128 for a diagonal tile. At d=2000 that is
//   (120 x 512 + 16 x 256) B x 400k = 26.2 GB staged per Gramian against
//   1.6 GB of X, from L2 (above): at ~5 TB/s of L2 that is ~5 ms, which
//   bounds this design above the 1.62 ms compute bound (wider tiles or a
//   cluster multicast of the column blocks would cut it; ROADMAP Queue 2b).
// - A second kernel sums the partials of each element in split order, in
//   double, times s_min s_max when a scale is given (so the main pass runs
//   the same instances for every scale, and G stays exactly symmetric),
//   and rounds once to float32. No atomics: two launches are bitwise
//   equal.
//
// The FMA instance (f32 X) is the earlier design: register-blocked 8 x 8
// float32 FMA tiles over 16-row stages, the same upper-triangle tiles,
// row splits, 1024-row folds (into its double partial in device memory)
// and reduction pass.
//
// Plain C interface (loaded with ctypes): every entry point returns a
// cudaError_t, 0 on success.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kTile = 128;       // rows and columns of a tile of G
constexpr int kFoldRows = 1024;  // rows summed in float32 between folds
constexpr int kTileElems = kTile * kTile;

// -- the tensor-core instance (bf16 and e4m3 X) -------------------------------

constexpr int kTcThreads = 256;     // two warpgroups
constexpr int kStageBudget = 192 * 1024;     // shared memory for stages
constexpr int kTcSmem = kStageBudget + 1024;  // + alignment
constexpr int kWindowFolds = 32;  // folds summed in float32 between flushes

// How a stage of X reaches shared memory:
// - kCopyBf16: bf16 rows that cp.async copies 16 bytes at a time into the
//   stage (d % 8 == 0, X 16-byte aligned);
// - kCopyCodes: e4m3 rows likewise copied as codes into a ring of code
//   slots, kAhead stages ahead, which each thread converts to bf16 (its
//   own 16 codes) into the stage just before the product (d % 16 == 0, X
//   16-byte aligned);
// - kLoad: any row (ragged strides): loads into registers one stage ahead,
//   converted and stored after the next product is started.
enum Staging { kCopyBf16 = 0, kCopyCodes = 1, kLoad = 2 };

// rows per stage, bf16 stage slots, copies in flight ahead of the
// product, e4m3 code slots. A slot is refilled kSlots - kAhead >= 2
// products after it was read (each product waits only for the one before
// it). 64-row stages halve the barriers of 32-row ones, which cost the
// bf16 instance twice its time on the H100.
template <int kStaging> struct Stages {
  static constexpr int kRows = 64, kSlots = 6, kAhead = 4, kCodeSlots = 0;
};
template <> struct Stages<kCopyCodes> {
  static constexpr int kRows = 64, kSlots = 3, kAhead = 4, kCodeSlots = 6;
};

template <int kStaging> struct StageBytes {
  using S = Stages<kStaging>;
  static constexpr int kBlock = S::kRows * 128;   // rows x 64 bf16 columns
  static constexpr int kOperand = 2 * kBlock;     // 128 columns
  static constexpr int kSlot = 2 * kOperand;      // A and B
  static constexpr int kCodeSlot = 2 * S::kRows * kTile;  // A, B as codes
  static_assert(S::kSlots * kSlot + S::kCodeSlots * kCodeSlot <=
                    kStageBudget,
                "the stages fit their shared memory");
  static_assert(S::kAhead <= S::kSlots - 2 || S::kCodeSlots > 0,
                "a slot is refilled while the product may read it");
  static_assert(S::kCodeSlots == 0 || (S::kAhead <= S::kCodeSlots - 2 &&
                                       S::kSlots >= 3),
                "a code slot or stage is refilled while read");
};

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

// grid: (tiles, splits); partials: splits * tiles * 128 * 128 doubles.
template <typename T, int kStaging>
__global__ void __launch_bounds__(kTcThreads, 1)
    gramian_tc_kernel(const T* __restrict__ x, const float* __restrict__ w,
                      long long n, int d, long long rows_per_split, int vec,
                      double* __restrict__ partials) {
  using namespace hopper;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = align1024(smem_raw);
  using S = Stages<kStaging>;
  using B = StageBytes<kStaging>;
  constexpr int kRows = S::kRows, kSlots = S::kSlots, kAhead = S::kAhead;
  constexpr int kPer = kRows / 16;  // 16-byte chunks a thread per operand
  uint8_t* slots = base;                           // bf16 stages
  uint8_t* codes = slots + kSlots * B::kSlot;      // e4m3 code slots

  const int side = tiles_per_side(d);
  int ti, tj;
  tile_coords(blockIdx.x, side, ti, tj);
  const bool diag = ti == tj;
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  const long long r_begin = (long long)blockIdx.y * rows_per_split;
  long long r_end = r_begin + rows_per_split;
  if (r_end > n) r_end = n;
  const long long nch =
      r_end > r_begin ? (r_end - r_begin + kRows - 1) / kRows : 0;

  // acc: the products of the current fold (at most 1024 rows); sum: the
  // folds of the current window (at most 32)
  float acc[64], sum[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    acc[i] = 0.0f;
    sum[i] = 0.0f;
  }

  // the stage address of 16-byte bf16 chunk g (columns 8g..8g+7 of the
  // 128) of stage row k of operand op (0 = A, block ti; 1 = B, block tj)
  auto chunk_dst = [&](int slot, int op, int k, int g) -> uint32_t {
    return smem_u32(slots + slot * B::kSlot + op * B::kOperand) +
           (g >> 3) * B::kBlock + sw128(k, g & 7);
  };
  auto row_live = [&](long long r) {
    return r < r_end && (w == nullptr || __ldg(w + r) > 0.0f);
  };
  const int ops = diag ? 1 : 2;  // a diagonal tile reads its block twice

  // kCopyBf16 and kLoad: this thread moves chunk g = q % 16 of row q / 16,
  // q = tid + 256 j, of each operand
  uint4 held[2][kPer];
  auto copy_bf16 = [&](long long c, int slot) {
    const long long r0 = r_begin + c * kRows;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int q = tid + kTcThreads * j;
      const int k = q >> 4, g = q & 15;
      const bool live = row_live(r0 + k);
#pragma unroll
      for (int op = 0; op < 2; ++op) {
        if (op >= ops) break;
        const int c0 = (op == 0 ? ti : tj) * kTile + g * 8;
        if constexpr (kStaging == kCopyBf16) {
          const bool in = live && c0 < d;
          cp_async16(chunk_dst(slot, op, k, g),
                     in ? x + (r0 + k) * d + c0 : x, in ? 16 : 0);
        } else {
          held[op][j] = load8(x, r0 + k, c0, d, live, vec != 0);
        }
      }
    }
  };
  auto store_held = [&](int slot) {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int q = tid + kTcThreads * j;
#pragma unroll
      for (int op = 0; op < 2; ++op)
        if (op < ops)
          st_shared16(chunk_dst(slot, op, q >> 4, q & 15), held[op][j]);
    }
  };
  // kCopyCodes: this thread copies codes 16 h .. 16 h + 15 (h = tid % 8)
  // of rows tid / 8 + 32 m of each operand, and later converts them itself
  const int ck = tid >> 3, ch = tid & 7;
  constexpr int kCodeSlots = S::kCodeSlots > 0 ? S::kCodeSlots : 1;
  auto code_at = [&](long long c, int op, int k) {
    return codes + (int)(c % kCodeSlots) * B::kCodeSlot + op * kRows * kTile +
           k * kTile + ch * 16;
  };
  auto copy_codes = [&](long long c) {
#pragma unroll
    for (int m = 0; m < kRows / 32; ++m) {
      const int k = ck + 32 * m;
      const long long r = r_begin + c * kRows + k;
      const bool live = row_live(r);
#pragma unroll
      for (int op = 0; op < 2; ++op) {
        if (op >= ops) break;
        const int c0 = (op == 0 ? ti : tj) * kTile + ch * 16;
        const bool in = live && c0 < d;
        cp_async16(smem_u32(code_at(c, op, k)), in ? x + r * d + c0 : x,
                   in ? 16 : 0);
      }
    }
  };
  auto convert_codes = [&](long long c, int slot) {
#pragma unroll
    for (int m = 0; m < kRows / 32; ++m) {
      const int k = ck + 32 * m;
#pragma unroll
      for (int op = 0; op < 2; ++op) {
        if (op >= ops) break;
        const uint4 v = *reinterpret_cast<const uint4*>(code_at(c, op, k));
        const uint32_t in[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          uint32_t p[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const uint32_t word = in[2 * half + e / 2];
            p[e] = e4m3x2_to_bf16x2((uint16_t)(word >> (16 * (e & 1))));
          }
          st_shared16(chunk_dst(slot, op, k, 2 * ch + half),
                      make_uint4(p[0], p[1], p[2], p[3]));
        }
      }
    }
  };

  // the window's sums into this CTA's double partial, element (li, lj) of
  // the tile: accumulator i of a thread is row 16 warp + lane / 4 + 8
  // ((i / 2) % 2) of its warpgroup's 64, column 2 (lane % 4) + i % 2 + 8
  // (i / 4)
  double* out = partials +
                ((long long)blockIdx.y * gridDim.x + blockIdx.x) * kTileElems;
  auto flush = [&](bool first) {
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const int li = wg * 64 + warp * 16 + (lane >> 2) + 8 * ((i >> 1) & 1);
      const int lj = 2 * (lane & 3) + (i & 1) + 8 * (i >> 2);
      double* p = out + li * kTile + lj;
      *p = first ? (double)sum[i] : *p + (double)sum[i];
      sum[i] = 0.0f;
    }
  };

  // prologue: the first stages on their way
  if constexpr (kStaging == kLoad) {
    if (nch > 0) {
      copy_bf16(0, 0);
      store_held(0);
    }
    fence_proxy_async();
    __syncthreads();
  } else {
    for (int c = 0; c < kAhead; ++c) {
      if (c < nch) {
        if constexpr (kStaging == kCopyBf16)
          copy_bf16(c, c % kSlots);
        else
          copy_codes(c);
      }
      cp_async_commit();  // an empty group past the end keeps the count
    }
  }

  // Each product waits only for the one before it (wgmma_wait<1>), so it
  // runs while the next stage is set up; a stage's slot is refilled
  // kSlots - kAhead >= 2 products after it was read. The inner loop has no
  // other wait, so the compiler keeps the products in flight across it.
  constexpr int kFoldChunks = kFoldRows / kRows;
  bool first = true;
  int folds = 0;
  for (long long f0 = 0; f0 < nch; f0 += kFoldChunks) {
    const long long f1 = f0 + kFoldChunks < nch ? f0 + kFoldChunks : nch;
    for (long long c = f0; c < f1; ++c) {
      const int slot = (int)(c % kSlots);
      if constexpr (kStaging == kCopyBf16) {
        cp_async_wait<kAhead - 1>();
        fence_proxy_async();
        __syncthreads();  // stage c landed for every thread
        if (c + kAhead < nch)
          copy_bf16(c + kAhead, (int)((c + kAhead) % kSlots));
        cp_async_commit();
      } else if constexpr (kStaging == kCopyCodes) {
        cp_async_wait<kAhead - 1>();  // this thread's codes of stage c
        convert_codes(c, slot);
        if (c + kAhead < nch) copy_codes(c + kAhead);
        cp_async_commit();
        fence_proxy_async();
        __syncthreads();  // stage c converted by every thread
      } else {
        if (c + 1 < nch) copy_bf16(c + 1, 0);  // into registers
      }

      const uint32_t a0 = smem_u32(slots + slot * B::kSlot) + wg * B::kBlock;
      const uint32_t b0 =
          smem_u32(slots + slot * B::kSlot + (diag ? 0 : B::kOperand));
      fence_operand(acc);
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < kRows / 16; ++s)
        wgmma_m64n128k16<1, 1>(acc,
                               desc_sw128(a0 + s * 2048, B::kBlock, 1024),
                               desc_sw128(b0 + s * 2048, B::kBlock, 1024));
      wgmma_commit();
      if constexpr (kStaging == kLoad) {
        if (c + 1 < nch) store_held((int)((c + 1) % kSlots));
      }
      wgmma_wait<1>();
      fence_operand(acc);
      if constexpr (kStaging == kLoad) {
        fence_proxy_async();
        __syncthreads();  // stage c + 1 stored by every thread
      }
    }
    wgmma_wait<0>();
    fence_operand(acc);
#pragma unroll
    for (int i = 0; i < 64; ++i) {  // the fold (see the note at the top)
      sum[i] += acc[i];
      acc[i] = 0.0f;
    }
    if (++folds == kWindowFolds || f1 == nch) {
      flush(first);
      first = false;
      folds = 0;
    }
  }
  if (first) flush(true);  // no rows: a partial of zeros
}

// -- the FMA instance (f32 X) -------------------------------------------------

constexpr int kThreads = 256;
constexpr int kChunk = 16;    // rows of X per stage
constexpr int kStride = 132;  // padded stage row (keeps float4 alignment)

// grid: (tiles, splits); partials: splits * tiles * 128 * 128 doubles
__global__ void __launch_bounds__(kThreads, 2)
    gramian_fma_kernel(const float* __restrict__ x,
                       const float* __restrict__ w, long long n, int d,
                       long long rows_per_split,
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
        const float* xr = x + r * (long long)d;
        as[rr][lc] = (live && ca < d) ? xr[ca] : 0.0f;
        bs[rr][lc] = (live && cb < d) ? xr[cb] : 0.0f;
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

// For element (lo, hi), lo <= hi, of upper-triangle tile t (one thread
// each, reading the partials in their own layout, so a warp's reads are
// contiguous): the sum over splits, in order, in double, of its partials,
// times scale[lo] scale[hi] when a scale is given, rounded once to float32
// and written to g[lo][hi] and g[hi][lo]
__global__ void gramian_reduce_kernel(const double* __restrict__ partials,
                                      const float* __restrict__ scale,
                                      int splits, int tiles, int d,
                                      float* __restrict__ g) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (long long)tiles * kTileElems) return;
  const int t = (int)(e / kTileElems);
  const int li = (int)(e % kTileElems) / kTile;
  const int lj = (int)(e % kTile);
  int ti, tj;
  tile_coords(t, tiles_per_side(d), ti, tj);
  const int lo = ti * kTile + li;
  const int hi = tj * kTile + lj;
  if (lo > hi || hi >= d) return;  // the mirror, or past the edge
  double s = 0.0;
  for (int p = 0; p < splits; ++p)
    s += partials[(long long)p * tiles * kTileElems + e];
  if (scale != nullptr) s *= (double)scale[lo] * (double)scale[hi];
  const float v = (float)s;
  g[(long long)lo * d + hi] = v;
  g[(long long)hi * d + lo] = v;
}

template <typename T, int kStaging>
cudaError_t launch_tc(const void* x, const float* w, long long n, int d,
                      long long per, int vec, int tiles, int splits,
                      double* partials, cudaStream_t s) {
  auto kernel = gramian_tc_kernel<T, kStaging>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kTcSmem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(tiles, splits), kTcThreads, kTcSmem, s>>>(
      static_cast<const T*>(x), w, n, d, per, vec, partials);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Upper-triangle tiles of a (d, d) Gramian and the row splits a pass over
// n rows uses on the current device; the scratch the caller allocates is
// splits * tiles * 128 * 128 doubles. The CTAs (tiles x splits, at most
// one a split and tile) are at most 16 waves of one CTA per SM, so the
// scratch is at most 16 x SMs x 128 KB whatever n is, and at least a fold
// of rows a split; of those counts, the least whose last wave is fullest.
int gramian_plan(int d, long long n, int* tiles, int* splits) {
  if (d < 1 || n < 0) return (int)cudaErrorInvalidValue;
  const int side = tiles_per_side(d);
  const int t = side * (side + 1) / 2;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  long long most = 16LL * sms / t;
  const long long by_rows = n / kFoldRows;  // at least a fold a split
  if (most > by_rows) most = by_rows;
  if (most > 65535) most = 65535;
  long long best = 1;
  double best_fill = 0.0;
  for (long long s = 1; s <= most; ++s) {
    const long long ctas = (long long)t * s;
    const long long waves = (ctas + sms - 1) / sms;
    const double fill = (double)ctas / (double)(waves * sms);
    if (fill > best_fill + 1e-9) {
      best_fill = fill;
      best = s;
    }
  }
  *tiles = t;
  *splits = (int)best;
  return 0;
}

// One Gramian. dtype: 0 = float32 X (FMA instance), 1 = bfloat16 X, 2 =
// float8_e4m3fn codes (tensor-core instance). x: (n, d) row-major; w: (n,)
// float32 or null; scale: (d,) float32 per-column dequantization, or
// null; partials: scratch of splits * tiles * 128 * 128 doubles; g: (d, d)
// float32 out.
int gramian_launch(int dtype, const void* x, const float* w,
                   const float* scale, long long n, int d, int tiles,
                   int splits, double* partials, float* g, void* stream) {
  const int side = tiles_per_side(d);
  if (d < 1 || n < 0 || splits < 1 || tiles != side * (side + 1) / 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const uintptr_t addr = reinterpret_cast<uintptr_t>(x);
  long long per = (n + splits - 1) / splits;
  cudaError_t err;
  if (dtype == 0) {
    per = ((per + kChunk - 1) / kChunk) * kChunk;
    gramian_fma_kernel<<<dim3(tiles, splits), kThreads, 0, s>>>(
        static_cast<const float*>(x), w, n, d, per, partials);
    err = cudaGetLastError();
  } else if (dtype == 1) {
    per = ((per + 63) / 64) * 64;  // whole stages of every staging
    if (d % 8 == 0 && addr % 16 == 0)
      err = launch_tc<__nv_bfloat16, kCopyBf16>(x, w, n, d, per, 1, tiles,
                                                splits, partials, s);
    else
      err = launch_tc<__nv_bfloat16, kLoad>(x, w, n, d, per, 0, tiles,
                                            splits, partials, s);
  } else if (dtype == 2) {
    per = ((per + 63) / 64) * 64;  // whole stages of every staging
    if (d % 16 == 0 && addr % 16 == 0)
      err = launch_tc<__nv_fp8_e4m3, kCopyCodes>(x, w, n, d, per, 1, tiles,
                                                 splits, partials, s);
    else
      err = launch_tc<__nv_fp8_e4m3, kLoad>(x, w, n, d, per,
                                            d % 8 == 0 && addr % 8 == 0,
                                            tiles, splits, partials, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  const long long blocks = ((long long)tiles * kTileElems + 255) / 256;
  gramian_reduce_kernel<<<(unsigned)blocks, 256, 0, s>>>(partials, scale,
                                                         splits, tiles, d, g);
  return (int)cudaGetLastError();
}

}  // extern "C"
