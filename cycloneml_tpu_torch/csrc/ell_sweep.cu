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
// time; lane l reads slot kc + l of each of the 32 rows (128 contiguous
// bytes a row), forms the float32 product v * beta[c] (v times scale[c]
// first where the dataset is standardized: the same float32 product the
// reference stores as its standardized values) and writes it into a
// 32 x 33 shared tile; lane l then sums row l's products in slot order in
// double. A row's COO tail (row-sorted, tail_ptr) is added after its ELL
// slots (beta, and the scale where given, come as one gather of a
// (scale, beta) pair: the two random reads of a slot cost one L2 sector,
// not two). Then the link, in double: logistic (loss w(softplus(m) - y m),
// mult w(sigmoid(m) - y)), squared (1/2 w err^2, w err), hinge (w max(0,
// 1 - s m), -s w where active, s = 2y - 1), or the Gram link of the
// Lanczos matvec (mult = m [w > 0], no loss). mult is written as float32;
// loss, sum(mult) and sum(w) are summed per lane in row order, per warp by
// a fixed shuffle tree, per CTA in warp order, and across CTAs by one CTA
// in a fixed tree (ell_rows_finish). The grid depends on n only.
//
// S2 (ell_cols_piece_kernel + ell_cols_reduce_kernel): the nonzeros in
// column order (col_ptr, row ids, values; a copy built once at ingest by a
// stable sort, rows in row order inside a column, the COO tail after the
// ELL entries). Each column's entries are cut into pieces of at most
// kPiece; one warp sums one piece (lanes strided, coalesced reads of rows
// and values, the gather r[row], the float32 product r * v summed in
// double per lane, then a fixed shuffle tree) into a double partial; one
// warp per column then sums the column's pieces, lanes strided and a fixed
// tree. A column that holds every row is 45.8M entries at the Criteo
// shape: cut into pieces it keeps every SM busy instead of serializing on
// one thread, warp or CTA. Modes: the gradient X^T mult (r = mult), and
// the three moments of sparse_summary (r = w: sum w v, sum (w v) v,
// sum w [v != 0]).
//
// Bound: bytes. S1 reads the ELL once (8 n k bytes) plus y, w and writes
// mult (12 n); its gathers of (scale, beta) hit L2 at d <= 2^20 (8 MB),
// but each costs an L2 sector, which at 1.79e9 slots is L2 traffic of
// its own. S2 reads the column copy once (8 bytes a nonzero) and gathers
// r[row]: 4 bytes a nonzero when neighbouring entries share sectors
// (dense columns, rows sorted), up to a 32-byte sector each when they do
// not (sparse columns, r larger than L2). At the Criteo shape (45.8M rows,
// 39 slots, 1.79e9 nonzeros) that is 14.3 GB a pass, 4.3 ms at an H100
// SXM's 3.35 TB/s (data sheet), and 57 GB more for S2's gathers at one
// sector each.
//
// Plain C interface (loaded with ctypes): every entry point returns a
// cudaError_t, 0 on success.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;                  // warps a CTA, both passes
constexpr int kThreads = 32 * kWarps;
constexpr int kPiece = 1024;               // nonzeros of one S2 piece, at most
constexpr int kMaxRowBlocks = 2048;        // S1's CTAs, at most
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

// the float32 product v * beta[c], v first times scale[c] when SCALED
// (coef then holds (scale, beta) pairs: one 8-byte gather serves both)
template <bool SCALED>
__device__ __forceinline__ float slot_product(const float* __restrict__ coef,
                                              int c, float v) {
  if (SCALED) {
    const float2 sb = __ldg(reinterpret_cast<const float2*>(coef) + c);
    return (v * sb.x) * sb.y;
  }
  return v * __ldg(coef + c);
}

// S1. coef: beta (d,), or (d, 2) (scale, beta) pairs when SCALED.
// partials: (gridDim.x, 3) doubles, this CTA's loss, sum(mult), sum(w).
template <int LINK, bool SCALED>
__global__ void __launch_bounds__(kThreads)
    ell_rows_kernel(const int* __restrict__ idx, const float* __restrict__ val,
                    long long n, int k, const long long* __restrict__ tail_ptr,
                    const int* __restrict__ tail_col,
                    const float* __restrict__ tail_val,
                    const float* __restrict__ coef,
                    const float* __restrict__ b0p,
                    const float* __restrict__ y, const float* __restrict__ w,
                    float* __restrict__ mult, double* __restrict__ partials) {
  __shared__ float tile[kWarps][32][33];
  __shared__ double warp_part[kWarps][3];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const double b0 = b0p != nullptr ? (double)*b0p : 0.0;
  double s_loss = 0.0, s_mult = 0.0, s_w = 0.0;
  const long long groups = (n + 31) / 32;
  for (long long g = (long long)blockIdx.x * kWarps + warp; g < groups;
       g += (long long)gridDim.x * kWarps) {
    const long long r0 = g * 32;
    const int rows = (int)(n - r0 < 32 ? n - r0 : 32);
    double acc = 0.0;  // lane's row r0 + lane, slots in order
    for (int kc = 0; kc < k; kc += 32) {
      const int slot = kc + lane;
      const bool on = slot < k;
      const long long base = r0 * (long long)k + slot;
#pragma unroll 8
      for (int r = 0; r < 32; ++r) {
        float p = 0.f;
        if (on && r < rows) {
          const long long e = base + (long long)r * k;
          p = slot_product<SCALED>(coef, __ldg(idx + e), __ldg(val + e));
        }
        tile[warp][r][lane] = p;
      }
      __syncwarp();
      const int width = k - kc < 32 ? k - kc : 32;
      if (lane < rows)
        for (int j = 0; j < width; ++j) acc += (double)tile[warp][lane][j];
      __syncwarp();
    }
    if (lane < rows) {
      const long long r = r0 + lane;
      if (tail_ptr != nullptr) {
        const long long t1 = tail_ptr[r + 1];
        for (long long t = tail_ptr[r]; t < t1; ++t)
          acc += (double)slot_product<SCALED>(coef, tail_col[t], tail_val[t]);
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
    for (int i = 0; i < kWarps; ++i) s += warp_part[i][threadIdx.x];
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

// S2, first pass: one warp per piece. partials: (n_pieces, M) doubles,
// M = 1 (gradient) or 3 (moments).
template <bool MOMENTS>
__global__ void __launch_bounds__(kThreads)
    ell_cols_piece_kernel(const long long* __restrict__ col_ptr,
                          const long long* __restrict__ piece_start,
                          const int* __restrict__ piece_col,
                          long long n_pieces, const int* __restrict__ rows,
                          const float* __restrict__ vals,
                          const float* __restrict__ scale,
                          const float* __restrict__ r_vec,
                          double* __restrict__ partials) {
  const long long p = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (p >= n_pieces) return;  // the whole warp
  const int lane = threadIdx.x & 31;
  const int c = piece_col[p];
  const long long first = col_ptr[c] + (p - piece_start[c]) * kPiece;
  const long long end = col_ptr[c + 1];
  const long long last = first + kPiece < end ? first + kPiece : end;
  const float s = scale != nullptr ? scale[c] : 1.f;
  double a0 = 0.0, a1 = 0.0, a2 = 0.0;
#pragma unroll 4
  for (long long e = first + lane; e < last; e += 32) {
    const float rv = __ldg(r_vec + __ldg(rows + e));
    float v = __ldg(vals + e);
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
    if (MOMENTS) {
      partials[p * 3] = a0;
      partials[p * 3 + 1] = a1;
      partials[p * 3 + 2] = a2;
    } else {
      partials[p] = a0;
    }
  }
}

// S2, second pass: one warp per column sums its pieces; out: (M, d)
// float32. A column with no nonzero gets 0.
template <int M>
__global__ void __launch_bounds__(kThreads)
    ell_cols_reduce_kernel(const long long* __restrict__ piece_start, int d,
                           const double* __restrict__ partials,
                           float* __restrict__ out) {
  const long long c = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (c >= d) return;
  const int lane = threadIdx.x & 31;
  const long long p0 = piece_start[c], p1 = piece_start[c + 1];
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
  long long blocks = (groups + kWarps - 1) / kWarps;
  if (blocks < 1) blocks = 1;
  if (blocks > kMaxRowBlocks) blocks = kMaxRowBlocks;
  return (int)blocks;
}

// Nonzeros of one S2 piece, at most: the wrapper cuts each column's
// entries into pieces of this size when it builds the column copy.
int ell_piece_entries() { return kPiece; }

// S1. link: 0 logistic, 1 squared, 2 hinge, 3 Gram. idx, val: (n, k);
// tail_ptr (n + 1), tail_col, tail_val: the row-sorted COO tail, or all
// null; coef: beta (d,), or with scaled the (d, 2) pairs (scale, beta);
// b0: one float or null; y, w, mult: (n,); partials: (blocks, 3) doubles;
// out: loss, sum(mult), sum(w) as doubles.
int ell_rows_launch(int link, int scaled, const int* idx, const float* val,
                    long long n, int k, const long long* tail_ptr,
                    const int* tail_col, const float* tail_val,
                    const float* coef, const float* b0, const float* y,
                    const float* w, float* mult, double* partials, int blocks,
                    double* out, void* stream) {
  RowFn fn = row_kernel_for(link, scaled);
  if (fn == nullptr || n < 0 || k < 1 || blocks != ell_row_blocks(n))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  void* args[] = {&idx, &val, &n, &k, &tail_ptr, &tail_col, &tail_val,
                  &coef, &b0,  &y, &w, &mult,     &partials};
  cudaError_t err = cudaLaunchKernel(fn, dim3((unsigned)blocks),
                                     dim3(kThreads), args, 0, s);
  if (err == cudaSuccess) err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ell_rows_finish<<<1, kThreads, 0, s>>>(partials, blocks, out);
  return (int)cudaGetLastError();
}

// S2. moments: 0 the gradient (out (d,)), 1 the three moments (out (3, d)).
// col_ptr, piece_start: (d + 1) int64; piece_col: (n_pieces,) int32;
// rows, vals: the column copy; scale: (d,) or null; r: (n,) (mult, or w);
// partials: (n_pieces, 1 or 3) doubles.
int ell_cols_launch(int moments, const long long* col_ptr,
                    const long long* piece_start, const int* piece_col,
                    long long n_pieces, int d, const int* rows,
                    const float* vals, const float* scale, const float* r,
                    double* partials, float* out, void* stream) {
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
          col_ptr, piece_start, piece_col, n_pieces, rows, vals, scale, r,
          partials);
    else
      ell_cols_piece_kernel<false>
          <<<(unsigned)piece_blocks, kThreads, 0, s>>>(
              col_ptr, piece_start, piece_col, n_pieces, rows, vals, scale,
              r, partials);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (moments)
    ell_cols_reduce_kernel<3><<<(unsigned)col_blocks, kThreads, 0, s>>>(
        piece_start, d, partials, out);
  else
    ell_cols_reduce_kernel<1><<<(unsigned)col_blocks, kThreads, 0, s>>>(
        piece_start, d, partials, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
