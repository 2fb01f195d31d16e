// The sparse (ELL) tier's two passes (sm_90a): S1, the row pass, and S2,
// the column pass. Together they are one evaluation of a sparse GLM
// aggregator (loss, gradient, sum(mult), sum(w)), one Lanczos matvec
// X^T (X q) on the sparse tier, or (S2 alone) the weighted feature moments
// of sparse_summary.
//
// Replaces the reference's jnp passes of cycloneml_tpu/ml/optim/
// sparse_aggregators.py (not Pallas kernels): the margins by jnp.take
// gathers (:34-37, :188-193) and the gradient and moments by
// jax.ops.segment_sum (:40-45, :114-134, :196-202). The port's
// straightforward counterpart, index_add_, adds with float atomics in an
// order that changes from run to run on CUDA; here every sum runs in one
// fixed order, with no float atomics, so two launches on the same inputs
// are bitwise equal and two fits of the same data give the same model.
//
// S1 (ell_rows_kernel): ELL rows, indices (n, k) int32 and values (n, k)
// float32, row-major, padding slots (0, 0.0). Each warp takes 32 rows at a
// time, whose 32 k slots lie contiguous: it reads them flat, every lane busy
// (lane l takes elements l, l + 32, ...; 16-byte loads of four slots when
// the rows fit one tile, k <= 40, as Criteo's 39 do; 32-bit offsets inside
// the warp's rows), forms each float32 product v * beta[c] (v times
// scale[c] first where the dataset is standardized: the same float32
// product the reference stores as its standardized values) and writes it
// into the warp's tile of 32 rows x up to 40 slots (an odd pitch, so that
// lane l reading row l hits its own bank); lane l then sums row l's
// products in slot order in double. A row's COO tail (row-sorted,
// tail_ptr) is added after its ELL slots, then b0. beta, and the scale
// where given, come as one gather of a (scale, beta) pair (one L2 sector,
// not two), from a shared-memory table where the column is one of the hot
// ones: ``hot`` lists, for each of H slots (a power of two), the most
// frequent column c with c mod H = slot (chosen at ingest from the column
// counts; -1 where none), and a CTA copies those H pairs from the
// coefficients before its rows. A gather that hits the table costs a
// shared-memory read instead of an L1/L2 request; the product is the same
// float either way. A CTA is 32 warps, so that one CTA an SM (the tiles of
// 32 warps and a 2,048-slot table, 184 KB at k = 39) holds one table for
// all its warps, and the grid of up to 2,048 CTAs runs in ~16 even waves.
// Then the link, in double: logistic (loss w(softplus(m)
// - y m), mult w(sigmoid(m) - y)), squared (1/2 w err^2, w err), hinge
// (w max(0, 1 - s m), -s w where active, s = 2y - 1), or the Gram link of
// the Lanczos matvec (mult = m [w > 0], no loss). mult is written as
// float32; loss, sum(mult) and sum(w) are summed per lane in row order,
// per warp by a fixed shuffle tree, per CTA in warp order, and across CTAs
// by one CTA in a fixed tree (ell_rows_finish). The grid depends on n
// only.
//
// S2 (ell_cols_piece_kernel + ell_cols_reduce_kernel): the nonzeros in
// (row block, column, row) order: a copy built once at ingest, block by
// block (R rows, a power of two: 2^22 at the Criteo shape, 16.8 MB of
// mult), each block's entries sorted stably by column, the COO tail's
// entries in their row's block after its ELL entries. Each (block, column)
// segment is cut into pieces of at most kPiece entries, numbered in
// storage order, so the CTAs in flight at any moment work inside one
// block and gather its slice of r from L2, not from device memory (a
// column-ordered copy spans every row at once: 183 MB of mult at the
// Criteo shape, 3.7x the L2). One warp sums one piece (lanes strided,
// streaming reads of rows and values, the gather r[row], the float32
// product r * v summed in double per lane, then a fixed shuffle tree)
// into a double partial at the piece's slot, fixed at ingest: the slots
// are in (column, block, piece) order, so each column's partials are
// contiguous and in block order; one warp per column then sums them,
// lanes strided and a fixed tree. No float atomics: two launches are
// bitwise equal. Modes: the gradient X^T mult (r = mult), and the three
// moments of sparse_summary (r = w: sum w v, sum (w v) v, sum w [v != 0]).
//
// Bound: bytes. S1 reads the ELL once (8 n k bytes) plus y, w and writes
// mult (12 n); its gathers of (scale, beta) hit L2 at d <= 2^20 (8 MB),
// but each costs an L1 request for its line, which at 1.79e9 slots is a
// limit of its own: the hot table serves the most frequent columns (the
// 13 integer columns and the zipf heads of the hashed ones) from shared
// memory instead. S2 reads the column copy once (8 bytes a nonzero) and
// gathers r[row] from the block's slice in L2. At the Criteo shape (45.8M
// rows, 39 slots, 1.79e9 nonzeros) that is 14.3 GB a pass, 4.3 ms at an
// H100 SXM's 3.35 TB/s (data sheet).
//
// Plain C interface (loaded with ctypes): every entry point returns a
// cudaError_t, 0 on success.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;                  // warps a CTA of S2
constexpr int kThreads = 32 * kWarps;
constexpr int kRowWarps = 32;              // warps a CTA of S1: one CTA
                                           // an SM shares one hot table
constexpr int kRowThreads = 32 * kRowWarps;
constexpr int kPiece = 1024;               // nonzeros of one S2 piece, at most
constexpr int kMaxRowBlocks = 2048;        // S1's CTAs, at most
constexpr int kSlotTile = 40;              // S1: slots a warp's tile holds
constexpr int kMaxHot = 4096;              // S1's hot-column slots, at most
                                           // (216 KB of shared memory with
                                           // the widest tiles)
constexpr unsigned kFull = 0xffffffffu;

enum Link { kLogistic = 0, kSquared = 1, kHinge = 2, kGram = 3 };

// the sum of v over the warp, in lane 0, by a fixed tree
__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(kFull, v, off);
  return v;
}

// loss and mult of one row at margin m (double), label y, weight w
template <int LINK>
__device__ __forceinline__ void row_link(double m, double y, double w,
                                         double* loss, double* mult) {
  if (LINK == kLogistic) {
    const double e = exp(-fabs(m));
    const double softplus = fmax(m, 0.0) + log1p(e);
    const double sigmoid = m >= 0.0 ? 1.0 / (1.0 + e) : e / (1.0 + e);
    *loss = w * (softplus - y * m);
    *mult = w * (sigmoid - y);
  } else if (LINK == kSquared) {
    const double err = m - y;
    *loss = 0.5 * w * err * err;
    *mult = w * err;
  } else if (LINK == kHinge) {
    const double s = 2.0 * y - 1.0;
    const double slack = 1.0 - s * m;
    *loss = w * fmax(0.0, slack);
    *mult = slack > 0.0 ? -s * w : 0.0;
  } else {  // the Gram link: X^T (X q) over the present rows
    *loss = 0.0;
    *mult = w > 0.0 ? m : 0.0;
  }
}

// a column's coefficient: beta (float), or the (scale, beta) pair (float2)
template <bool SCALED> struct Coef { using T = float; };
template <> struct Coef<true> { using T = float2; };

// the float32 product of a slot: v * beta, or (v * scale) * beta
__device__ __forceinline__ float product(float v, float b) { return v * b; }
__device__ __forceinline__ float product(float v, float2 sb) {
  return (v * sb.x) * sb.y;
}

// S1's view of the coefficients: the global table and the CTA's shared
// copy of the hot columns' entries (mask = hot slots - 1; -1 without)
template <typename C>
struct CoefView {
  const C* coef;
  const int* hkey;
  const C* hval;
  int mask;

  __device__ __forceinline__ float operator()(int c, float v) const {
    C cf;
    if (mask >= 0 && hkey[c & mask] == c)
      cf = hval[c & mask];
    else
      cf = __ldg(coef + c);
    return product(v, cf);
  }
};

// S1's tile pitch for k slots: the slots of one tile, made odd, so that
// lane l reading row l hits its own bank
__host__ __device__ __forceinline__ int tile_pitch(int k) {
  return (k < kSlotTile ? k : kSlotTile) | 1;
}

// store a product at (row r, slot s) of a warp's tile (row pitch ``pitch``)
// and step to the next slot of a row of ``width`` slots
__device__ __forceinline__ void put(float* tile, int pitch, int& r, int& s,
                                    int width, float p) {
  tile[r * pitch + s] = p;
  if (++s == width) {
    s = 0;
    ++r;
  }
}

// S1. coef: beta (d,), or (d, 2) (scale, beta) pairs when SCALED.
// partials: (gridDim.x, 3) doubles, this CTA's loss, sum(mult), sum(w).
// hot: (hot_slots,) column ids or -1, or null with hot_slots 0. Dynamic
// shared memory: the warps' tiles (32 rows x tile_pitch(k) floats each),
// then the hot keys and their entries.
template <int LINK, bool SCALED>
__global__ void __launch_bounds__(kRowThreads)
    ell_rows_kernel(const int* __restrict__ idx, const float* __restrict__ val,
                    long long n, int k, const long long* __restrict__ tail_ptr,
                    const int* __restrict__ tail_col,
                    const float* __restrict__ tail_val,
                    const typename Coef<SCALED>::T* __restrict__ coef,
                    const float* __restrict__ b0p,
                    const float* __restrict__ y, const float* __restrict__ w,
                    float* __restrict__ mult, double* __restrict__ partials,
                    const int* __restrict__ hot, int hot_slots) {
  using C = typename Coef<SCALED>::T;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ double warp_part[kRowWarps][3];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int pitch = tile_pitch(k);
  const int tile_bytes = (kRowWarps * 32 * pitch * 4 + 15) & ~15;
  int* hkey = reinterpret_cast<int*>(smem + tile_bytes);
  C* hval = reinterpret_cast<C*>(smem + tile_bytes + hot_slots * 4);
  for (int t = threadIdx.x; t < hot_slots; t += kRowThreads) {
    const int c = hot[t];
    hkey[t] = c;
    hval[t] = c >= 0 ? __ldg(coef + c) : C{};
  }
  __syncthreads();
  const CoefView<C> cv{coef, hkey, hval, hot_slots - 1};
  float* tile = reinterpret_cast<float*>(smem) + warp * 32 * pitch;
  // the flat 16-byte path: a tile holds whole rows, and 32 rows of k
  // slots start 128 k bytes apart, so 16-byte aligned with the arrays
  const bool flat4 = k <= kSlotTile &&
      ((reinterpret_cast<uintptr_t>(idx) | reinterpret_cast<uintptr_t>(val))
       & 15) == 0;
  const double b0 = b0p != nullptr ? (double)*b0p : 0.0;
  double s_loss = 0.0, s_mult = 0.0, s_w = 0.0;
  const long long groups = (n + 31) / 32;
  for (long long g = (long long)blockIdx.x * kRowWarps + warp; g < groups;
       g += (long long)gridDim.x * kRowWarps) {
    const long long r0 = g * 32;
    const int rows = (int)(n - r0 < 32 ? n - r0 : 32);
    const int* gi = idx + r0 * k;  // 32-bit offsets from here on
    const float* gv = val + r0 * k;
    double acc = 0.0;  // lane's row r0 + lane, slots in order
    if (flat4 && rows == 32) {
      const int4* gi4 = reinterpret_cast<const int4*>(gi);
      const float4* gv4 = reinterpret_cast<const float4*>(gv);
      const int nvec = 8 * k;  // 32 k slots, four a load
#pragma unroll 2
      for (int q = lane; q < nvec; q += 32) {
        const int4 c4 = __ldcs(gi4 + q);
        const float4 v4 = __ldcs(gv4 + q);
        int r = (4 * q) / k;
        int s = 4 * q - r * k;
        put(tile, pitch, r, s, k, cv(c4.x, v4.x));
        put(tile, pitch, r, s, k, cv(c4.y, v4.y));
        put(tile, pitch, r, s, k, cv(c4.z, v4.z));
        put(tile, pitch, r, s, k, cv(c4.w, v4.w));
      }
      __syncwarp();
      for (int j = 0; j < k; ++j) acc += (double)tile[lane * pitch + j];
      __syncwarp();
    } else {
      // tiles of up to kSlotTile slots; element i of a tile of width wd is
      // row i / wd, slot kc + i % wd
      for (int kc = 0; kc < k; kc += kSlotTile) {
        const int wd = k - kc < kSlotTile ? k - kc : kSlotTile;
        const int count = rows * wd;
        const int dr = 32 / wd, ds = 32 - dr * wd;
        int r = lane / wd, s = lane - r * wd;
        for (int i = lane; i < count; i += 32) {
          const int off = r * k + kc + s;
          tile[r * pitch + s] = cv(__ldcs(gi + off), __ldcs(gv + off));
          r += dr;
          s += ds;
          if (s >= wd) {
            s -= wd;
            ++r;
          }
        }
        __syncwarp();
        if (lane < rows)
          for (int j = 0; j < wd; ++j) acc += (double)tile[lane * pitch + j];
        __syncwarp();
      }
    }
    if (lane < rows) {
      const long long r = r0 + lane;
      if (tail_ptr != nullptr) {
        const long long t1 = tail_ptr[r + 1];
        for (long long t = tail_ptr[r]; t < t1; ++t)
          acc += (double)cv(tail_col[t], tail_val[t]);
      }
      const double wi = (double)w[r];
      double loss, mu;
      row_link<LINK>(acc + b0, (double)y[r], wi, &loss, &mu);
      const float mf = (float)mu;
      mult[r] = mf;
      s_loss += loss;
      s_mult += (double)mf;
      s_w += wi;
    }
  }
  s_loss = warp_sum(s_loss);
  s_mult = warp_sum(s_mult);
  s_w = warp_sum(s_w);
  if (lane == 0) {
    warp_part[warp][0] = s_loss;
    warp_part[warp][1] = s_mult;
    warp_part[warp][2] = s_w;
  }
  __syncthreads();
  if (threadIdx.x < 3) {
    double s = 0.0;
    for (int i = 0; i < kRowWarps; ++i) s += warp_part[i][threadIdx.x];
    partials[(long long)blockIdx.x * 3 + threadIdx.x] = s;
  }
}

// S1's second pass: the CTAs' partials summed by one CTA, strided then a
// fixed tree; out: loss, sum(mult), sum(w) as doubles (a sum of n unit
// weights stays exact past float32's 2^24).
__global__ void __launch_bounds__(kThreads)
    ell_rows_finish(const double* __restrict__ partials, int blocks,
                    double* __restrict__ out) {
  __shared__ double red[kThreads];
  for (int q = 0; q < 3; ++q) {
    double s = 0.0;
    for (int b = threadIdx.x; b < blocks; b += kThreads)
      s += partials[(long long)b * 3 + q];
    red[threadIdx.x] = s;
    __syncthreads();
    for (int h = kThreads / 2; h > 0; h >>= 1) {
      if (threadIdx.x < h) red[threadIdx.x] += red[threadIdx.x + h];
      __syncthreads();
    }
    if (threadIdx.x == 0) out[q] = red[0];
    __syncthreads();
  }
}

// S2, first pass: one warp a piece, the CTA's warps on consecutive
// pieces. partials: (n_pieces, M) doubles at the pieces' slots, M = 1
// (gradient) or 3 (moments).
template <bool MOMENTS>
__global__ void __launch_bounds__(kThreads)
    ell_cols_piece_kernel(const long long* __restrict__ piece_ptr,
                          const int* __restrict__ piece_col,
                          const int* __restrict__ piece_slot,
                          long long n_pieces, const int* __restrict__ rows,
                          const float* __restrict__ vals,
                          const float* __restrict__ scale,
                          const float* __restrict__ r_vec,
                          double* __restrict__ partials) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long p = (long long)blockIdx.x * kWarps + warp;
  if (p >= n_pieces) return;  // the whole warp
  const long long first = piece_ptr[p];
  const int len = (int)(piece_ptr[p + 1] - first);
  const int* pr = rows + first;  // 32-bit offsets inside the piece
  const float* pv = vals + first;
  const int c = piece_col[p];
  const float s = scale != nullptr ? scale[c] : 1.f;
  double a0 = 0.0, a1 = 0.0, a2 = 0.0;
#pragma unroll 4
  for (int e = lane; e < len; e += 32) {
    const float rv = __ldg(r_vec + __ldcs(pr + e));
    float v = __ldcs(pv + e);
    if (scale != nullptr) v *= s;
    if (MOMENTS) {
      const float wk = rv * v;
      a0 += (double)wk;
      a1 += (double)(wk * v);
      a2 += v != 0.f ? (double)rv : 0.0;
    } else {
      a0 += (double)(rv * v);
    }
  }
  a0 = warp_sum(a0);
  if (MOMENTS) {
    a1 = warp_sum(a1);
    a2 = warp_sum(a2);
  }
  if (lane == 0) {
    const long long at = (long long)piece_slot[p] * (MOMENTS ? 3 : 1);
    partials[at] = a0;
    if (MOMENTS) {
      partials[at + 1] = a1;
      partials[at + 2] = a2;
    }
  }
}

// S2, second pass: one warp per column sums its slots, in block order;
// out: (M, d) float32. A column with no nonzero gets 0.
template <int M>
__global__ void __launch_bounds__(kThreads)
    ell_cols_reduce_kernel(const long long* __restrict__ slot_ptr, int d,
                           const double* __restrict__ partials,
                           float* __restrict__ out) {
  const long long c = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (c >= d) return;
  const int lane = threadIdx.x & 31;
  const long long p0 = slot_ptr[c], p1 = slot_ptr[c + 1];
#pragma unroll
  for (int q = 0; q < M; ++q) {
    double s = 0.0;
    for (long long p = p0 + lane; p < p1; p += 32) s += partials[p * M + q];
    s = warp_sum(s);
    if (lane == 0) out[(long long)q * d + c] = (float)s;
  }
}

using RowFn = const void*;

template <bool SCALED>
RowFn row_kernel(int link) {
  switch (link) {
    case kLogistic:
      return reinterpret_cast<RowFn>(&ell_rows_kernel<kLogistic, SCALED>);
    case kSquared:
      return reinterpret_cast<RowFn>(&ell_rows_kernel<kSquared, SCALED>);
    case kHinge:
      return reinterpret_cast<RowFn>(&ell_rows_kernel<kHinge, SCALED>);
    case kGram:
      return reinterpret_cast<RowFn>(&ell_rows_kernel<kGram, SCALED>);
    default:
      return nullptr;
  }
}

RowFn row_kernel_for(int link, int scaled) {
  return scaled ? row_kernel<true>(link) : row_kernel<false>(link);
}

}  // namespace

extern "C" {

// S1's CTA count for n rows (a function of n only, so that the order of
// every sum is fixed by the inputs): the wrapper sizes the partials as
// (blocks, 3) doubles.
int ell_row_blocks(long long n) {
  const long long groups = (n + 31) / 32;
  long long blocks = (groups + kRowWarps - 1) / kRowWarps;
  if (blocks < 1) blocks = 1;
  if (blocks > kMaxRowBlocks) blocks = kMaxRowBlocks;
  return (int)blocks;
}

// Nonzeros of one S2 piece, at most: the wrapper cuts each (row block,
// column) segment into pieces of this size when it builds the column copy.
int ell_piece_entries() { return kPiece; }

// S1's hot-column slots, at most (a power of two).
int ell_max_hot_slots() { return kMaxHot; }

// S1. link: 0 logistic, 1 squared, 2 hinge, 3 Gram. idx, val: (n, k);
// tail_ptr (n + 1), tail_col, tail_val: the row-sorted COO tail, or all
// null; coef: beta (d,), or with scaled the (d, 2) pairs (scale, beta);
// b0: one float or null; y, w, mult: (n,); partials: (blocks, 3) doubles;
// hot: (hot_slots,) column ids or -1 (hot_slots 0, or a power of two from
// 32 to ell_max_hot_slots()); out: loss, sum(mult), sum(w) as doubles.
int ell_rows_launch(int link, int scaled, const int* idx, const float* val,
                    long long n, int k, const long long* tail_ptr,
                    const int* tail_col, const float* tail_val,
                    const float* coef, const float* b0, const float* y,
                    const float* w, float* mult, double* partials, int blocks,
                    const int* hot, int hot_slots, double* out,
                    void* stream) {
  RowFn fn = row_kernel_for(link, scaled);
  const bool hot_ok = hot_slots == 0 ||
      (hot != nullptr && hot_slots >= 32 && hot_slots <= kMaxHot &&
       (hot_slots & (hot_slots - 1)) == 0);
  if (fn == nullptr || n < 0 || k < 1 || k > (1 << 20) || !hot_ok ||
      blocks != ell_row_blocks(n))
    return (int)cudaErrorInvalidValue;
  const int smem = ((kRowWarps * 32 * tile_pitch(k) * 4 + 15) & ~15) +
                   hot_slots * (scaled ? 12 : 8);
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  void* args[] = {&idx,  &val, &n, &k,    &tail_ptr, &tail_col,
                  &tail_val, &coef, &b0, &y, &w, &mult,
                  &partials, &hot, &hot_slots};
  err = cudaLaunchKernel(fn, dim3((unsigned)blocks), dim3(kRowThreads), args,
                         (size_t)smem, s);
  if (err == cudaSuccess) err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ell_rows_finish<<<1, kThreads, 0, s>>>(partials, blocks, out);
  return (int)cudaGetLastError();
}

// S2. moments: 0 the gradient (out (d,)), 1 the three moments (out (3, d)).
// piece_ptr: (n_pieces + 1) int64 entry offsets; piece_col, piece_slot:
// (n_pieces,) int32; slot_ptr: (d + 1) int64, column c's slots; rows,
// vals: the column copy; scale: (d,) or null; r: (n,) (mult, or w);
// partials: (n_pieces, 1 or 3) doubles.
int ell_cols_launch(int moments, const long long* piece_ptr,
                    const int* piece_col, const int* piece_slot,
                    long long n_pieces, const long long* slot_ptr, int d,
                    const int* rows, const float* vals, const float* scale,
                    const float* r, double* partials, float* out,
                    void* stream) {
  if (d < 1 || n_pieces < 0 || (moments != 0 && moments != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const long long piece_blocks = (n_pieces + kWarps - 1) / kWarps;
  const long long col_blocks = ((long long)d + kWarps - 1) / kWarps;
  if (piece_blocks > 0x7fffffffLL || col_blocks > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (piece_blocks > 0) {
    if (moments)
      ell_cols_piece_kernel<true><<<(unsigned)piece_blocks, kThreads, 0, s>>>(
          piece_ptr, piece_col, piece_slot, n_pieces, rows, vals, scale, r,
          partials);
    else
      ell_cols_piece_kernel<false>
          <<<(unsigned)piece_blocks, kThreads, 0, s>>>(
              piece_ptr, piece_col, piece_slot, n_pieces, rows, vals, scale,
              r, partials);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (moments)
    ell_cols_reduce_kernel<3><<<(unsigned)col_blocks, kThreads, 0, s>>>(
        slot_ptr, d, partials, out);
  else
    ell_cols_reduce_kernel<1><<<(unsigned)col_blocks, kThreads, 0, s>>>(
        slot_ptr, d, partials, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
