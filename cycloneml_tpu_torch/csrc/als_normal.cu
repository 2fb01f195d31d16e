// ALS normal equations in a fixed order (sm_90a): for every destination
// entity e of a half-step (a user given the item factors, or an item given
// the user factors), over its ratings (s, r) with source factor rows v_s:
//   explicit: A_e = sum v v^T,             b_e = sum r v;
//   implicit: A_e = sum (alpha |r|) v v^T, b_e = sum (1 + alpha |r|) [r > 0] v;
// then A_e += reg max(n_e, 1) I and, when given, A_e += Y^T Y (n_e counts
// every rating, r <= 0 too).
//
// Replaces the reference's chunked scatter-add of outer products
// (cycloneml_tpu/ml/recommendation/als.py:490, `a.at[d_i].add(outer)` in
// _normal_eq_local; the same at :390 in _train_blocked), not a Pallas
// kernel. It is written by hand because its direct counterpart on CUDA,
// index_add_, adds with float atomics in a run-dependent order, so two fits
// of the same ratings could end with different factors; it also writes and
// re-reads a (chunk, r, r) block of outer products per chunk (nnz r^2
// floats a half-step, 393 GB at MovieLens-25M's shape and rank 64). Here
// every sum runs in one fixed order and each destination's sum stays on
// chip until it is written.
//
// The order. The wrapper sorts the ratings stably by destination once a fit
// (each destination's ratings in input order) and cuts each destination's
// into pieces of at most P ratings (a destination with no rating has one
// empty piece). A destination with one piece (every destination at
// MovieLens-25M's shape) is finished by the CTA that sums it: reg max(n, 1)
// on the diagonal, then Y^T Y's upper entry, the result written to (i, j)
// and (j, i) from the same register, so A == A^T bitwise. The pieces of a
// destination with more than one write their partials to consecutive
// scratch slots; als_reduce_kernel, one CTA per (such destination, 32 x 32
// tile pair), sums their upper entries in piece order and finishes them the
// same way. No float atomics: two launches on the same inputs are bitwise
// equal.
//
// Two instances of the first stage:
// - float32: the tensor cores (als_tc_kernel), below;
// - float64 (the cyclone.compute.dtype=float64 fits and the checks):
//   float64 FMAs (als_piece_kernel<double>), one CTA of 64 threads per
//   (piece, 32 x 32 tile pair (ti, tj), ti <= tj), each thread a 4 x 4
//   block of the tile in registers, (c v_i) v_j added rating after rating
//   by one fma from a batch of 32 staged rows; the diagonal tile's first
//   warp sums b in the same loop. The same kernel at float32 is the
//   earlier float32 design (the wrapper's instance="fma"), kept to be
//   timed beside the tensor cores in one run; no fit launches it.
//
// Bounds at configuration 4 (MovieLens-25M's shape: 24,000,095 training
// ratings, rank 64; an H100 SXM's data-sheet rates):
// - bytes: A written once (n_dst r (r + 1) floats, as chip_smoke.py counts
//   it: 2.70 GB for the 162,541 users, 1.04 GB for the 62,423 items), the
//   int32 ids, the ratings and the factors read once: 0.871 ms (users) and
//   0.380 ms (items) at 3.35 TB/s;
// - operations on the FMA pipes: nnz (r (r + 1) + 2 r) = 1.03e11 float32
//   operations, 1.536 ms at 67 TFLOP/s (the FMA design's bound);
// - operations on the tensor cores: the upper entries' products three
//   times over (below), nnz r (r + 1) / 2 * 2 * 3 = 3.0e11, 0.605 ms at
//   495 TFLOP/s of TF32. So the tensor-core instance is bound by bytes for
//   the users (0.871 ms) and by operations for the items (0.605 ms); the
//   FMA bound is no floor for it and no share is taken against it.
//
// The tensor-core instance, and what it does about the six limits of the
// FMA design (which ran at 13-16% of its bound, PERF.md section 6):
// 1. FMA pipes only -> mma.sync.m16n8k8 TF32 with float32 sums. The
//    tensor cores read only the top 10 mantissa bits of a TF32 operand
//    (about three digits), so each operand value x is split into hi =
//    rna(x) and lo = rna(x - hi), rna the rounding of cvt.rna.tf32.f32 (to
//    nearest, ties away from zero), done by an integer add and mask (the
//    same bits for finite x; ptxas expands cvt.rna.tf32.f32 into a
//    compare-and-select sequence). Each product is lo*hi, then hi*lo, then
//    hi*hi, smallest first (as K1s sums its split parts): the dropped lo*lo
//    is below 2^-21 of the product. The scale c multiplies the B operand in
//    float32 before its split (A = v_i, B = c v_j). The accumulators
//    restart every stage of 32 ratings (12 products in a chain) and each
//    stage's sums are added to the running sums by ordinary float32 adds:
//    the tensor cores' additions are not rounded to nearest, and a piece
//    of 1,024 ratings in one chain would let their error grow with its 384
//    products. Nothing here reads torch.backends.cuda.matmul.allow_tf32.
//    mma.sync and not wgmma: TF32 wgmma takes K-major operands only (the
//    staged rows would have to be transposed), and its M of 64 rows would
//    compute the whole 64 x 64 square, where the triangle needs 10 of its
//    16 blocks of 16 x 16.
// 2. Lower halves of the diagonal tiles -> only the 16 x 16 blocks of the
//    upper triangle are computed: at rank 64, 10 of 16 (2,560 products a
//    rating for 2,080 upper entries, against 3,072 before). Three warps
//    take 32 x 32 warp tiles, (0, 0), (0, 32) and (32, 32), each 8 m16n8
//    jobs: the diagonal ones skip their lower-left 16 x 16 block and take
//    b instead, as an n8 job a 16-row block whose B column holds the b
//    weights (the other seven columns zero), so b has the same 3xTF32
//    products in the same pass.
// 3. ~27 issued instructions per 16 fmas -> one mma.sync is 1,024
//    products. A warp's k-step (8 ratings) loads and splits 8 A values and
//    8 B values a lane (each B fragment serves both 16-row blocks of the
//    warp tile) for 24 mma.sync. The warps run one of two shapes of code
//    (a diagonal or a full warp tile) and the k-step loop is not unrolled:
//    a first version with a code path of its own for each warp and every
//    loop unrolled was bound by fetching its instructions.
// 4. Each row gathered once per tile pair (three times at rank 64) -> one
//    CTA per piece covers the whole upper triangle up to rank 64 (the rank
//    padded to 64 columns in shared memory, the output masked), so each
//    rating's 256-byte row is gathered once a half-step. Past rank 64 a
//    CTA of four warps takes a (piece, 64 x 64 tile pair ti <= tj) of the
//    upper triangle with the same warp tiles (off the diagonal all four
//    full, no b) and gathers the two 64-column slices.
// 5. Synchronous gathers -> cp.async, 16 bytes a lane (4 where the rank is
//    not a multiple of 4 or the factors are not 16-byte aligned), into a
//    ring of kRing = 2 stages of 32 ratings: the rows (by ids staged one
//    stage ahead) and the ratings; stage s + 1 is in flight while the
//    tensor cores work on stage s, one barrier a stage. A last stage's
//    missing rows are zero-filled by the copies themselves. Staged rows
//    are 72 floats apart: at a pitch of 64 the lanes with the same lane / 4
//    of a fragment load hit one bank; at 72 (8 banks mod 32) the 32 lanes
//    hit 32 banks.
// 6. Scalar, strided stores -> an epilogue through shared memory: each
//    upper entry, finished (+ reg max(n, 1) on the diagonal, + Y^T Y), is
//    written into a 64 x 68 tile in shared memory (over the ring) at both
//    (i, j) and (j, i) from the same register, and the tile goes out as
//    whole 16-byte rows by coalesced streaming stores (16 KB a destination
//    at rank 64; evict-first, so that A does not push the gathered factors
//    out of L2; element stores where the rank is not a multiple of 4). b
//    goes out from the registers of the lanes that hold it.
// Registers: 122 a thread up to rank 64 (5 CTAs of 3 warps an SM), no
// spills. Where its time goes: als_phases.py (PERF.md section 5).
//
// Plain C interface (loaded with ctypes): the entry point returns a
// cudaError_t, 0 on success.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kTile = 32;          // side of a tile of A
constexpr int kThreads = 64;       // threads of a CTA: 8 x 8, 4 x 4 entries each
constexpr int kBlock = 4;          // rows and columns of a thread's block
constexpr int kBatch = 32;         // ratings staged at a time
constexpr int kMaxPairsY = 65535;  // tile pairs a launch's grid.y holds

template <typename T>
struct __align__(16) Stage {
  T vi[kBatch][kTile];  // the batch's source rows, columns of tile ti
  T vj[kBatch][kTile];  // ... of tile tj (unused for a diagonal tile)
  T c[kBatch];          // each rating's scale: 1, or alpha |r|
  T bw[kBatch];         // each rating's b weight: r, or (1 + alpha |r|) [r > 0]
};

// four consecutive entries of a staged row (16-byte aligned: a thread's
// block starts at a multiple of 4 columns), one 16-byte load of float32
__device__ __forceinline__ void load4(const float* p, float (&v)[kBlock]) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  v[0] = x.x;
  v[1] = x.y;
  v[2] = x.z;
  v[3] = x.w;
}
__device__ __forceinline__ void load4(const double* p, double (&v)[kBlock]) {
  const double2 x = *reinterpret_cast<const double2*>(p);
  const double2 y = *reinterpret_cast<const double2*>(p + 2);
  v[0] = x.x;
  v[1] = x.y;
  v[2] = y.x;
  v[3] = y.y;
}

// the p-th tile pair (ti <= tj) of the upper triangle, row after row
__device__ __forceinline__ void tile_pair(int p, int tiles, int& ti,
                                          int& tj) {
  int row = tiles;
  ti = 0;
  while (p >= row) {
    p -= row;
    ++ti;
    --row;
  }
  tj = ti + p;
}

// A's upper entry (i, j) finished: + reg max(n, 1) on the diagonal, then +
// Y^T Y's (i, j), written to (i, j) and (j, i)
template <typename T>
__device__ __forceinline__ void finish(T* __restrict__ a, int r, int i, int j,
                                       T v, T lam,
                                       const T* __restrict__ yty) {
  if (i == j) v += lam;
  if (yty != nullptr) v += yty[(long long)i * r + j];
  a[(long long)i * r + j] = v;
  a[(long long)j * r + i] = v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) als_piece_kernel(
    const T* __restrict__ fac, int r, const int* __restrict__ src,
    const T* __restrict__ rating, const int64_t* __restrict__ offsets,
    const int64_t* __restrict__ piece_start,
    const int* __restrict__ piece_dst, const int* __restrict__ piece_slot,
    int piece, int tiles, int pairs, int implicit, T alpha, T reg,
    const T* __restrict__ yty, T* __restrict__ part_a,
    T* __restrict__ part_b, T* __restrict__ a_out, T* __restrict__ b_out) {
  __shared__ Stage<T> s;
  const long long g = blockIdx.x;
  const int d = piece_dst[g];
  const long long first = offsets[d] + (g - piece_start[d]) * piece;
  const long long rest = offsets[d + 1] - first;
  const int len = (int)(rest < piece ? rest : piece);
  const int t = threadIdx.x;
  const int bi = (t >> 3) * kBlock, bj = (t & 7) * kBlock;
  const int slot = piece_slot[g];
  const long long rr = (long long)r * r;
  for (int p = blockIdx.y; p < pairs; p += gridDim.y) {
    int ti, tj;
    tile_pair(p, tiles, ti, tj);
    const bool diag = ti == tj;
    const int ci = ti * kTile, cj = tj * kTile;
    T acc[kBlock][kBlock];
#pragma unroll
    for (int q = 0; q < kBlock; ++q)
#pragma unroll
      for (int u = 0; u < kBlock; ++u) acc[q][u] = T(0);
    T bacc = T(0);
    for (int base = 0; base < len; base += kBatch) {
      const int nb = min(kBatch, len - base);
      if (t < kBatch) {
        T c = T(1), w = T(0);
        if (t < nb) {
          const T rt = rating[first + base + t];
          if (implicit) {
            c = alpha * fabs(rt);
            w = rt > T(0) ? T(1) + c : T(0);
          } else {
            w = rt;
          }
        }
        s.c[t] = c;
        s.bw[t] = w;
      }
      // a warp stages one rating's slice a step: 32 lanes, 128 contiguous
      // bytes of one row (the row's id read once, broadcast); unrolled, so
      // that the batch's gathers are in flight together
#pragma unroll
      for (int e = t; e < kBatch * kTile; e += kThreads) {
        const int k = e / kTile, col = e % kTile;
        T x = T(0), y = T(0);
        if (k < nb) {
          const T* row = fac + (long long)src[first + base + k] * r;
          if (ci + col < r) x = row[ci + col];
          if (!diag && cj + col < r) y = row[cj + col];
        }
        s.vi[k][col] = x;
        if (!diag) s.vj[k][col] = y;
      }
      __syncthreads();
      const T(*vj)[kTile] = diag ? s.vi : s.vj;
      for (int k = 0; k < nb; ++k) {
        const T c = s.c[k];
        T xi[kBlock], yj[kBlock];
        load4(&s.vi[k][bi], xi);
        load4(&vj[k][bj], yj);
#pragma unroll
        for (int q = 0; q < kBlock; ++q) xi[q] = c * xi[q];
#pragma unroll
        for (int q = 0; q < kBlock; ++q)
#pragma unroll
          for (int u = 0; u < kBlock; ++u)
            acc[q][u] = fma(xi[q], yj[u], acc[q][u]);
        if (diag && t < kTile) bacc = fma(s.vi[k][t], s.bw[k], bacc);
      }
      __syncthreads();
    }
    if (slot < 0) {  // the destination's only piece: finish it here
      T* a = a_out + (long long)d * rr;
      const T n = T(len);
      const T lam = reg * (n > T(1) ? n : T(1));
#pragma unroll
      for (int q = 0; q < kBlock; ++q)
#pragma unroll
        for (int u = 0; u < kBlock; ++u) {
          const int i = ci + bi + q, j = cj + bj + u;
          if (i < r && j < r && (!diag || i <= j))
            finish(a, r, i, j, acc[q][u], lam, yty);
        }
      if (diag && t < kTile && ci + t < r)
        b_out[(long long)d * r + ci + t] = bacc;
    } else {  // a partial, summed in piece order by als_reduce_kernel
      T* a = part_a + (long long)slot * rr;
#pragma unroll
      for (int q = 0; q < kBlock; ++q)
#pragma unroll
        for (int u = 0; u < kBlock; ++u) {
          const int i = ci + bi + q, j = cj + bj + u;
          if (i < r && j < r && (!diag || i <= j))
            a[(long long)i * r + j] = acc[q][u];
        }
      if (diag && t < kTile && ci + t < r)
        part_b[(long long)slot * r + ci + t] = bacc;
    }
  }
}

// the destinations with more than one piece: their partials (consecutive
// slots from that of their first piece) summed in piece order, finished
template <typename T>
__global__ void __launch_bounds__(kThreads) als_reduce_kernel(
    int r, const int64_t* __restrict__ offsets,
    const int64_t* __restrict__ piece_start,
    const int* __restrict__ piece_slot, const int* __restrict__ multi,
    int tiles, int pairs, T reg, const T* __restrict__ yty,
    const T* __restrict__ part_a, const T* __restrict__ part_b,
    T* __restrict__ a_out, T* __restrict__ b_out) {
  const int d = multi[blockIdx.x];
  const long long s0 = piece_slot[piece_start[d]];
  const int np = (int)(piece_start[d + 1] - piece_start[d]);
  const T n = T(offsets[d + 1] - offsets[d]);
  const T lam = reg * (n > T(1) ? n : T(1));
  const int t = threadIdx.x;
  const long long rr = (long long)r * r;
  T* a = a_out + (long long)d * rr;
  for (int p = blockIdx.y; p < pairs; p += gridDim.y) {
    int ti, tj;
    tile_pair(p, tiles, ti, tj);
    const bool diag = ti == tj;
    const int ci = ti * kTile, cj = tj * kTile;
    // the tile's entries a row of 32 at a time: neighbouring threads read
    // neighbouring partials
#pragma unroll 1
    for (int e = t; e < kTile * kTile; e += kThreads) {
      const int i = ci + e / kTile, j = cj + e % kTile;
      if (i < r && j < r && (!diag || i <= j)) {
        const T* src = part_a + s0 * rr + (long long)i * r + j;
        T v = src[0];
        for (int k = 1; k < np; ++k) v += src[k * rr];
        finish(a, r, i, j, v, lam, yty);
      }
    }
    if (diag && t < kTile && ci + t < r) {
      const T* src = part_b + s0 * r + ci + t;
      T v = src[0];
      for (int k = 1; k < np; ++k) v += src[(long long)k * r];
      b_out[(long long)d * r + ci + t] = v;
    }
  }
}

// -- the tensor-core instance (float32) ------------------------------------

constexpr int kSide = 64;           // side of A's tiles (the rank, up to 64)
constexpr int kPitch = kSide + 8;   // staged row pitch: 8 banks mod 32
constexpr int kTilePitch = kSide + 4;  // the epilogue's tiles
constexpr int kStage = 32;          // ratings a stage
constexpr int kRing = 2;            // stages in the ring
constexpr int kIdSlots = 2 * kRing;  // stages of ids: kRing - 1 ahead
constexpr int kJobs = 8;            // m16n8 jobs of a warp tile

// CTA shape: up to rank 64, 3 warps, each a 32 x 32 warp tile of the upper
// triangle at (row, column) (0, 0), (0, 32), (32, 32); past it, 4 (the
// tile pairs off the diagonal also take (32, 0)). CTAs an SM that the
// registers must allow: 5 up to rank 64 (at most 136 registers a thread;
// under the thread bound alone ptxas keeps to 128 and spills), 3 past it.
template <bool kTiled>
struct TcShape {
  static constexpr int warps = kTiled ? 4 : 3;
  static constexpr int threads = 32 * warps;
  static constexpr int min_blocks = kTiled ? 3 : 5;
};

// The rounding of cvt.rna.tf32.f32 (to nearest, ties away from zero; the
// low 13 bits zero) by an integer add and mask: for finite x the same bits.
// ptxas expands cvt.rna.tf32.f32 into a compare-and-select sequence.
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}
// x = hi + lo + (below 2^-21 |x|), both TF32
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}
// c (16 x 8 f32) += a (16 x 8 tf32, row) b (8 x 8 tf32, col)
__device__ __forceinline__ void mma_tf32(float (&c)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// lo*hi, then hi*lo, then hi*hi: the smallest terms first
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], uint32_t bh0,
                                     uint32_t bh1, uint32_t bl0,
                                     uint32_t bl1) {
  mma_tf32(c, al, bh0, bh1);
  mma_tf32(c, ah, bl0, bl1);
  mma_tf32(c, ah, bh0, bh1);
}

// A warp tile's jobs: rows 16m .. 16m + 15 (m = 0, 1) of its 32, by the n8
// column blocks t = 0..3 of its 32 columns: job 4m + t. On the diagonal
// (DIAG) the block below it (m = 1, t < 2) is not computed and jobs 4, 5
// are (1, 2), (1, 3), 6 and 7 b's column for rows m = 0, 1.
template <bool DIAG>
__device__ __forceinline__ constexpr int job(int m, int t) {
  return DIAG ? (m == 0 ? t : t + 2) : 4 * m + t;
}

// One stage's nb ratings for a warp tile: A's rows from column ca of the
// staged rows ri, its columns from cb of rj (the same rows on the
// diagonal), each job's products into a stage sum from zero, then added to
// its running sum tot.
template <bool DIAG>
__device__ __forceinline__ void tc_stage(float (&tot)[kJobs][4],
                                         const float* ri, const float* rj,
                                         const float* rat, int ca, int cb,
                                         int nb, int implicit, float alpha,
                                         int lane) {
  const int g = lane >> 2, q = lane & 3;
  float acc[kJobs][4];
#pragma unroll
  for (int j = 0; j < kJobs; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll 1
  for (int k0 = 0; k0 < nb; k0 += 8) {
    const float* a = ri + (k0 + q) * kPitch + ca + g;
    const float* b = DIAG ? a : rj + (k0 + q) * kPitch + cb + g;
    const float r0 = rat[k0 + q], r1 = rat[k0 + q + 4];
    float c0 = 1.f, c1 = 1.f, w0 = r0, w1 = r1;
    if (implicit) {
      c0 = alpha * fabsf(r0);
      c1 = alpha * fabsf(r1);
      w0 = r0 > 0.f ? 1.f + c0 : 0.f;
      w1 = r1 > 0.f ? 1.f + c1 : 0.f;
    }
    // A (row g, rating q), (g + 8, q), (g, q + 4), (g + 8, q + 4) of each
    // 16-row block
    uint32_t ah[2][4], al[2][4];
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      split(a[16 * m], ah[m][0], al[m][0]);
      split(a[16 * m + 8], ah[m][1], al[m][1]);
      split(a[4 * kPitch + 16 * m], ah[m][2], al[m][2]);
      split(a[4 * kPitch + 16 * m + 8], ah[m][3], al[m][3]);
    }
    // B (rating q, column g) and (q + 4, g) of each n8 block: c v, split
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      uint32_t bh0, bl0, bh1, bl1;
      split(c0 * b[8 * t], bh0, bl0);
      split(c1 * b[4 * kPitch + 8 * t], bh1, bl1);
#pragma unroll
      for (int m = 0; m < 2; ++m)
        if (!DIAG || m == 0 || t >= 2)
          mma3(acc[job<DIAG>(m, t)], ah[m], al[m], bh0, bh1, bl0, bl1);
    }
    if (DIAG) {  // b: column 0 of B holds the b weights, 1-7 zeros
      uint32_t bh0, bl0, bh1, bl1;
      split(g == 0 ? w0 : 0.f, bh0, bl0);
      split(g == 0 ? w1 : 0.f, bh1, bl1);
#pragma unroll
      for (int m = 0; m < 2; ++m)
        mma3(acc[6 + m], ah[m], al[m], bh0, bh1, bl0, bl1);
    }
  }
#pragma unroll
  for (int j = 0; j < kJobs; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) tot[j][e] += acc[j][e];
}

// A warp tile's sums into the shared tiles: entry (i, j) of the tile pair
// (i = ra + local row, j = rb + local column; i <= j on the diagonal),
// finished (+ lam on the diagonal, + Y^T Y's (ci + i, cj + j)) where
// `finish`, into up[i][j] and lo[j][i] (the same tile on the diagonal);
// b straight from the lanes that hold it to bdst[ci + i].
template <bool DIAG>
__device__ __forceinline__ void tc_store(const float (&tot)[kJobs][4],
                                         float* up, float* lo, int r, int ci,
                                         int cj, int ra, int rb, int wi,
                                         int wj, bool finish, float lam,
                                         const float* __restrict__ yty,
                                         float* bdst, int lane) {
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      if (DIAG && m == 1 && t < 2) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = ra + 16 * m + g + 8 * (e >> 1);
        const int j = rb + 8 * t + 2 * q + (e & 1);
        if (i >= wi || j >= wj || (DIAG && i > j)) continue;
        float v = tot[job<DIAG>(m, t)][e];
        if (finish) {
          if (DIAG && i == j) v += lam;
          if (yty != nullptr) v += yty[(long long)(ci + i) * r + cj + j];
        }
        up[i * kTilePitch + j] = v;
        lo[j * kTilePitch + i] = v;
      }
    }
  if (DIAG && q == 0) {  // column 0 of b's jobs: c0 (row g), c2 (row g + 8)
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = ra + 16 * m + g + 8 * h;
        if (i < wi) __stcs(bdst + ci + i, tot[6 + m][2 * h]);
      }
  }
}

// rows x cols of a shared tile to dst's rows row0.. and columns col0..
// (row-major, r columns): whole 16-byte rows where vec, coalesced
template <int kThreadsN>
__device__ __forceinline__ void tc_copy_out(const float* tile,
                                            float* __restrict__ dst, int r,
                                            int row0, int col0, int rows,
                                            int cols, bool vec, int tid) {
  if (vec) {
    const int n4 = cols / 4;
    for (int u = tid; u < rows * n4; u += kThreadsN) {
      const int i = u / n4, c = 4 * (u - i * n4);
      __stcs(reinterpret_cast<float4*>(dst + (long long)(row0 + i) * r +
                                       col0 + c),
             *reinterpret_cast<const float4*>(tile + i * kTilePitch + c));
    }
  } else {
    for (int u = tid; u < rows * cols; u += kThreadsN) {
      const int i = u / cols, c = u - i * cols;
      __stcs(dst + (long long)(row0 + i) * r + col0 + c,
             tile[i * kTilePitch + c]);
    }
  }
}

// dynamic shared memory (bytes): the ring (one slice of the staged rows a
// stage up to rank 64, two past it), the ratings and the ids
__host__ __device__ constexpr int tc_smem_bytes(bool tiled) {
  return (kRing * (tiled ? 2 : 1) * kStage * kPitch + kRing * kStage +
          kIdSlots * kStage) *
         4;
}
static_assert(2 * kSide * kTilePitch <= kRing * 2 * kStage * kPitch &&
                  kSide * kTilePitch <= kRing * kStage * kPitch,
              "the epilogue's tiles fit over the ring");

// One CTA per (piece, tile pair): kTiled = false up to rank 64 (one tile,
// the whole triangle), true past it (64 x 64 tile pairs ti <= tj).
// vec_rows: 16-byte copies of the factor rows; vec_out: 16-byte stores of A.
template <bool kTiled>
__global__ void __launch_bounds__(TcShape<kTiled>::threads,
                                  TcShape<kTiled>::min_blocks) als_tc_kernel(
    const float* __restrict__ fac, int r, const int* __restrict__ src,
    const float* __restrict__ rating, const int64_t* __restrict__ offsets,
    const int64_t* __restrict__ piece_start,
    const int* __restrict__ piece_dst, const int* __restrict__ piece_slot,
    int piece, int tiles, int pairs, int implicit, float alpha, float reg,
    const float* __restrict__ yty, float* __restrict__ part_a,
    float* __restrict__ part_b, float* __restrict__ a_out,
    float* __restrict__ b_out, int vec_rows, int vec_out) {
  constexpr int kThreadsN = TcShape<kTiled>::threads;
  constexpr int slices = kTiled ? 2 : 1;
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);
  float* rat = ring + kRing * slices * kStage * kPitch;
  int* ids = reinterpret_cast<int*>(rat + kRing * kStage);

  const long long gp = blockIdx.x;
  const int d = piece_dst[gp];
  const long long first = offsets[d] + (gp - piece_start[d]) * piece;
  const long long rest = offsets[d + 1] - first;
  const int len = (int)(rest < piece ? rest : piece);
  const int nst = (len + kStage - 1) / kStage;
  const int slot = piece_slot[gp];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // the warp's 32 x 32 tile: rows ra.., columns rb.. of the tile pair
  const int ra = warp == 2 || warp == 3 ? 32 : 0;
  const int rb = warp == 0 || warp == 3 ? 0 : 32;

  for (int p = blockIdx.y; p < pairs; p += gridDim.y) {
    int ti = 0, tj = 0;
    if (kTiled) tile_pair(p, tiles, ti, tj);
    const bool diag = ti == tj;
    const int ci = ti * kSide, cj = tj * kSide;
    const int wi = min(kSide, r - ci), wj = min(kSide, r - cj);
    const int nsl = diag ? 1 : 2;  // slices staged: A's rows, its columns
    // the warp's tile lies in the triangle and within the rank
    const bool live = (!diag || warp < 3) && ra < wi && rb < wj;

    // group s: stage s's rows (by its ids, staged kRing - 1 stages ahead)
    // and ratings, and the ids of stage s + kRing - 1; a last stage's
    // missing rows and ratings zero-filled; an empty group past the last
    // stage keeps the groups counted. The copies fill the columns below
    // the rank; the pad columns past it (garbage) reach only entries past
    // the rank, which are not stored.
    auto issue = [&](int s) {
      const int base = s * kStage, nb = min(kStage, len - base);
      const int* sid = ids + (s % kIdSlots) * kStage;
      for (int h = 0; h < nsl && s < nst; ++h) {
        const int c0 = h ? cj : ci, w = h ? wj : wi;
        float* dst = ring + ((s % kRing) * slices + h) * kStage * kPitch;
        if (vec_rows) {  // 16 lanes a row: 256 contiguous bytes
          for (int u = tid; u < kStage * 16; u += kThreadsN) {
            const int k = u >> 4, c = 4 * (u & 15);
            if (c < w) {
              const bool in = k < nb;
              hopper::cp_async16(
                  hopper::smem_u32(dst + k * kPitch + c),
                  in ? fac + (long long)sid[k] * r + c0 + c : fac,
                  in ? 16 : 0);
            }
          }
        } else {
          for (int u = tid; u < kStage * kSide; u += kThreadsN) {
            const int k = u >> 6, c = u & 63;
            if (c < w) {
              const bool in = k < nb;
              hopper::cp_async4(
                  hopper::smem_u32(dst + k * kPitch + c),
                  in ? fac + (long long)sid[k] * r + c0 + c : fac,
                  in ? 4 : 0);
            }
          }
        }
      }
      if (tid < kStage) {
        const bool in = tid < nb;
        if (s < nst)
          hopper::cp_async4(
              hopper::smem_u32(rat + (s % kRing) * kStage + tid),
              in ? rating + first + base + tid : rating, in ? 4 : 0);
      } else if (tid < 2 * kStage) {
        const int k = tid - kStage, ahead = s + kRing - 1;
        if (ahead * kStage + k < len)
          hopper::cp_async4(
              hopper::smem_u32(ids + (ahead % kIdSlots) * kStage + k),
              src + first + ahead * kStage + k, 4);
      }
      hopper::cp_async_commit();
    };

    float tot[kJobs][4];
#pragma unroll
    for (int j = 0; j < kJobs; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) tot[j][e] = 0.f;
    // the ids of the first kRing - 1 stages (slots 0 .. kRing - 2)
    for (int u = tid; u < min((kRing - 1) * kStage, len); u += kThreadsN)
      ids[u] = src[first + u];
    __syncthreads();  // the first stages' ids
    for (int s = 0; s < kRing - 1; ++s) issue(s);
    for (int s = 0; s < nst; ++s) {
      hopper::cp_async_wait<kRing - 2>();
      __syncthreads();  // stage s landed; every warp is done with s - 1
      issue(s + kRing - 1);
      const float* ri = ring + (s % kRing) * slices * kStage * kPitch;
      const float* rj = diag ? ri : ri + kStage * kPitch;
      const float* rt = rat + (s % kRing) * kStage;
      const int nb = min(kStage, len - s * kStage);
      if (live) {
        if (diag && ra == rb)
          tc_stage<true>(tot, ri, rj, rt, ra, rb, nb, implicit, alpha, lane);
        else
          tc_stage<false>(tot, ri, rj, rt, ra, rb, nb, implicit, alpha,
                          lane);
      }
    }
    __syncthreads();  // the ring is free: the tiles go over it
    const long long rr = (long long)r * r;
    const bool finish = slot < 0;  // the destination's only piece
    const float lam = reg * fmaxf((float)len, 1.f);
    float* adst = finish ? a_out + (long long)d * rr : part_a + slot * rr;
    float* bdst =
        finish ? b_out + (long long)d * r : part_b + (long long)slot * r;
    float* up = ring;
    float* lo = diag ? up : up + kSide * kTilePitch;
    if (live) {
      if (diag && ra == rb)
        tc_store<true>(tot, up, lo, r, ci, cj, ra, rb, wi, wj, finish, lam,
                       yty, bdst, lane);
      else
        tc_store<false>(tot, up, lo, r, ci, cj, ra, rb, wi, wj, finish, lam,
                        yty, bdst, lane);
    }
    __syncthreads();
    tc_copy_out<kThreadsN>(up, adst, r, ci, cj, wi, wj, vec_out, tid);
    if (!diag)
      tc_copy_out<kThreadsN>(lo, adst, r, cj, ci, wj, wi, vec_out, tid);
    __syncthreads();  // the tiles are read before the next pair's zeros
  }
}

// the second stage, for the destinations with more than one piece
template <typename T>
cudaError_t launch_reduce(int r, const int64_t* offsets,
                          const int64_t* piece_start, const int* piece_slot,
                          const int* multi, int n_multi, double reg,
                          const void* yty, const void* part_a,
                          const void* part_b, void* a, void* b,
                          cudaStream_t s) {
  if (n_multi == 0) return cudaSuccess;
  const int tiles = (r + kTile - 1) / kTile;
  const long long pairs_ll = (long long)tiles * (tiles + 1) / 2;
  if (pairs_ll > INT_MAX) return cudaErrorInvalidValue;
  const int pairs = (int)pairs_ll;
  const dim3 grid((unsigned)n_multi,
                  (unsigned)(pairs < kMaxPairsY ? pairs : kMaxPairsY));
  als_reduce_kernel<T><<<grid, dim3(kThreads), 0, s>>>(
      r, offsets, piece_start, piece_slot, multi, tiles, pairs, T(reg),
      static_cast<const T*>(yty), static_cast<const T*>(part_a),
      static_cast<const T*>(part_b), static_cast<T*>(a), static_cast<T*>(b));
  return cudaGetLastError();
}

// the FMA instance's first stage (float64; float32 for comparison), then
// the second
template <typename T>
cudaError_t launch_fma(int implicit, const void* fac, int r, const int* src,
                       const void* rating, const int64_t* offsets,
                       const int64_t* piece_start, const int* piece_dst,
                       const int* piece_slot, long long n_pieces, int piece,
                       const int* multi, int n_multi, double alpha,
                       double reg, const void* yty, void* part_a,
                       void* part_b, void* a, void* b, cudaStream_t s) {
  const int tiles = (r + kTile - 1) / kTile;
  const long long pairs_ll = (long long)tiles * (tiles + 1) / 2;
  if (pairs_ll > INT_MAX) return cudaErrorInvalidValue;
  const int pairs = (int)pairs_ll;
  if (n_pieces > 0) {
    const dim3 grid((unsigned)n_pieces,
                    (unsigned)(pairs < kMaxPairsY ? pairs : kMaxPairsY));
    als_piece_kernel<T><<<grid, dim3(kThreads), 0, s>>>(
        static_cast<const T*>(fac), r, src, static_cast<const T*>(rating),
        offsets, piece_start, piece_dst, piece_slot, piece, tiles, pairs,
        implicit, T(alpha), T(reg), static_cast<const T*>(yty),
        static_cast<T*>(part_a), static_cast<T*>(part_b), static_cast<T*>(a),
        static_cast<T*>(b));
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return launch_reduce<T>(r, offsets, piece_start, piece_slot, multi, n_multi,
                          reg, yty, part_a, part_b, a, b, s);
}

bool aligned16(const void* p) {
  return p == nullptr || reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// the tensor-core instance's first stage (float32), then the second
cudaError_t launch_tc(int implicit, const float* fac, int r, const int* src,
                      const float* rating, const int64_t* offsets,
                      const int64_t* piece_start, const int* piece_dst,
                      const int* piece_slot, long long n_pieces, int piece,
                      const int* multi, int n_multi, double alpha, double reg,
                      const float* yty, float* part_a, float* part_b,
                      float* a, float* b, cudaStream_t s) {
  const bool tiled = r > kSide;
  const int tiles = (r + kSide - 1) / kSide;
  const long long pairs_ll = (long long)tiles * (tiles + 1) / 2;
  if (pairs_ll > INT_MAX) return cudaErrorInvalidValue;
  const int pairs = (int)pairs_ll;
  if (n_pieces > 0) {
    const int vec_rows = r % 4 == 0 && aligned16(fac);
    const int vec_out = r % 4 == 0 && aligned16(a) && aligned16(part_a);
    const dim3 grid((unsigned)n_pieces,
                    (unsigned)(pairs < kMaxPairsY ? pairs : kMaxPairsY));
    const int smem = tc_smem_bytes(tiled);
    const dim3 block(tiled ? TcShape<true>::threads : TcShape<false>::threads);
    auto kernel = tiled ? als_tc_kernel<true> : als_tc_kernel<false>;
    const cudaError_t attr = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (attr != cudaSuccess) return attr;
    kernel<<<grid, block, smem, s>>>(
        fac, r, src, rating, offsets, piece_start, piece_dst, piece_slot,
        piece, tiles, pairs, implicit, (float)alpha, (float)reg, yty, part_a,
        part_b, a, b, vec_rows, vec_out);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return launch_reduce<float>(r, offsets, piece_start, piece_slot, multi,
                              n_multi, reg, yty, part_a, part_b, a, b, s);
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 float64 (the factors, the ratings, yty, the scratch
// and the outputs alike); fma: float32 through the FMA instance (the
// earlier design, for timing; float64 always takes it). fac: (n_src, r)
// row-major; src, rating: (nnz,) in the order (int32 ids); offsets,
// piece_start: (n_dst + 1,) int64; piece_dst, piece_slot: (n_pieces,)
// int32; multi: (n_multi,) int32; yty: (r, r) or null; part_a, part_b:
// (slots, r, r) and (slots, r), null when no destination has two pieces.
// Writes a (n_dst, r, r) and b (n_dst, r).
int als_normal_launch(int dtype, int fma, int implicit, const void* fac,
                      int r, const int* src, const void* rating,
                      const int64_t* offsets, const int64_t* piece_start,
                      const int* piece_dst, const int* piece_slot,
                      long long n_pieces, int piece, const int* multi,
                      int n_multi, double alpha, double reg, const void* yty,
                      void* part_a, void* part_b, void* a, void* b,
                      void* stream) {
  if (r < 1 || piece < 1 || n_pieces < 0 || n_pieces > INT_MAX ||
      n_multi < 0 || (n_multi > 0 && (part_a == nullptr || part_b == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 0 && !fma)
    return (int)launch_tc(
        implicit, static_cast<const float*>(fac), r, src,
        static_cast<const float*>(rating), offsets, piece_start, piece_dst,
        piece_slot, n_pieces, piece, multi, n_multi, alpha, reg,
        static_cast<const float*>(yty), static_cast<float*>(part_a),
        static_cast<float*>(part_b), static_cast<float*>(a),
        static_cast<float*>(b), s);
  if (dtype == 0)
    return (int)launch_fma<float>(implicit, fac, r, src, rating, offsets,
                                  piece_start, piece_dst, piece_slot,
                                  n_pieces, piece, multi, n_multi, alpha, reg,
                                  yty, part_a, part_b, a, b, s);
  if (dtype == 1)
    return (int)launch_fma<double>(implicit, fac, r, src, rating, offsets,
                                   piece_start, piece_dst, piece_slot,
                                   n_pieces, piece, multi, n_multi, alpha,
                                   reg, yty, part_a, part_b, a, b, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
