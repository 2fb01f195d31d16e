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
// kernel. On CUDA its direct counterpart, index_add_, adds with float
// atomics in a run-dependent order, so two fits of the same ratings could
// end with different factors; it also writes and re-reads a (chunk, r, r)
// block of outer products per chunk (nnz r^2 floats a half-step, 393 GB at
// MovieLens-25M's shape and rank 64). Here every sum runs in one fixed
// order and each destination's sum stays on chip until it is written.
//
// The order. The wrapper sorts the ratings stably by destination once a fit
// (each destination's ratings in input order) and cuts each destination's
// into pieces of at most P ratings (a destination with no rating has one
// empty piece). als_piece_kernel runs one CTA per (piece, tile pair): a
// pair (ti, tj), ti <= tj, of the 32 x 32 tiles of the upper triangle of
// A, so any rank works (ceil(r / 32) tiles a side). The CTA stages a batch
// of the piece's ratings at a time: their source rows' two 32-column slices
// (one for a diagonal tile), gathered from the factors into shared memory,
// with each rating's scale (1, or alpha |r|) and b weight. Each of its 64
// threads holds a 4 x 4 block of the tile in registers and adds, rating
// after rating in the piece's order, (c v_i) v_j by one fma, its four
// v_i and four v_j read by one 16-byte shared-memory load each; the
// diagonal tile's first warp sums b in the same loop, lane l entry l of
// the tile (in a loop of its own, ptxas spills 12 bytes a thread).
// A destination with one piece (every destination at MovieLens-25M's
// shape) is finished in the same CTA: reg max(n, 1) on the diagonal, then
// Y^T Y's upper entry, written to (i, j) and (j, i) alike, so A == A^T
// bitwise. The pieces of a destination with more than one write their
// upper tiles' partials to consecutive scratch slots; als_reduce_kernel,
// one CTA per (such destination, tile pair), sums them in piece order and
// finishes them the same way. No float atomics: two launches on the same
// inputs are bitwise equal.
//
// Bound: operations. A half-step makes nnz r (r + 1) / 2 fmas of the upper
// triangles (nnz r (r + 1) float32 operations) and nnz r of b; at
// MovieLens-25M's 24M training ratings and rank 64 that is 1.0e11, 1.5 ms
// at an H100 SXM's 67 TFLOP/s of float32 outside the tensor cores (data
// sheet), against 0.9 ms for its bytes (A written once, 2.66 GB for the
// users; the int32 ids, the ratings and the factors read once). The tiles
// of the diagonal compute their lower halves too (3 tiles, 3,072 fmas a
// rating at rank 64 for 2,080 useful), and a thread issues about 27
// instructions (2 shared-memory loads, 4 multiplies by c, the loop) for
// its 16 fmas a rating: a first design that is right, for the tensor
// cores to replace (its time beside the bound: PERF.md section 6).
//
// Plain C interface (loaded with ctypes): the entry point returns a
// cudaError_t, 0 on success.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

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

template <typename T>
cudaError_t launch(int implicit, const void* fac, int r, const int* src,
                   const void* rating, const int64_t* offsets,
                   const int64_t* piece_start, const int* piece_dst,
                   const int* piece_slot, long long n_pieces, int piece,
                   const int* multi, int n_multi, double alpha, double reg,
                   const void* yty, void* part_a, void* part_b, void* a,
                   void* b, cudaStream_t s) {
  const int tiles = (r + kTile - 1) / kTile;
  const long long pairs_ll = (long long)tiles * (tiles + 1) / 2;
  if (pairs_ll > INT_MAX) return cudaErrorInvalidValue;
  const int pairs = (int)pairs_ll;
  const dim3 block(kThreads);
  if (n_pieces > 0) {
    const dim3 grid((unsigned)n_pieces,
                    (unsigned)(pairs < kMaxPairsY ? pairs : kMaxPairsY));
    als_piece_kernel<T><<<grid, block, 0, s>>>(
        static_cast<const T*>(fac), r, src, static_cast<const T*>(rating),
        offsets, piece_start, piece_dst, piece_slot, piece, tiles, pairs,
        implicit, T(alpha), T(reg), static_cast<const T*>(yty),
        static_cast<T*>(part_a), static_cast<T*>(part_b), static_cast<T*>(a),
        static_cast<T*>(b));
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (n_multi > 0) {
    const dim3 grid((unsigned)n_multi,
                    (unsigned)(pairs < kMaxPairsY ? pairs : kMaxPairsY));
    als_reduce_kernel<T><<<grid, block, 0, s>>>(
        r, offsets, piece_start, piece_slot, multi, tiles, pairs, T(reg),
        static_cast<const T*>(yty), static_cast<const T*>(part_a),
        static_cast<const T*>(part_b), static_cast<T*>(a),
        static_cast<T*>(b));
    return cudaGetLastError();
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 float64 (the factors, the ratings, yty, the scratch
// and the outputs alike). fac: (n_src, r) row-major; src, rating: (nnz,)
// in the order (int32 ids); offsets, piece_start: (n_dst + 1,) int64;
// piece_dst, piece_slot: (n_pieces,) int32; multi: (n_multi,) int32; yty:
// (r, r) or null; part_a, part_b: (slots, r, r) and (slots, r), null when
// no destination has two pieces. Writes a (n_dst, r, r) and b (n_dst, r).
int als_normal_launch(int dtype, int implicit, const void* fac, int r,
                      const int* src, const void* rating,
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
  if (dtype == 0)
    return (int)launch<float>(implicit, fac, r, src, rating, offsets,
                              piece_start, piece_dst, piece_slot, n_pieces,
                              piece, multi, n_multi, alpha, reg, yty, part_a,
                              part_b, a, b, s);
  if (dtype == 1)
    return (int)launch<double>(implicit, fac, r, src, rating, offsets,
                               piece_start, piece_dst, piece_slot, n_pieces,
                               piece, multi, n_multi, alpha, reg, yty, part_a,
                               part_b, a, b, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
