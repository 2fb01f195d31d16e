// KMeans center sums in a fixed order (sm_90a): per cluster c, the sums of
// w_r x_r and of w_r over the rows r assigned to c.
//
// Replaces the reference's jax.ops.segment_sum of the Lloyd step
// (cycloneml_tpu/ml/clustering/kmeans.py:122-124), not a Pallas kernel.
// The port summed with index_add_, whose CUDA float atomics add in an order
// that changes from run to run, so two fits of the same data could end
// with different centers; here every sum runs in one fixed order, and two
// launches on the same inputs are bitwise equal.
//
// The wrapper sorts the assignment stably (so rows of a cluster come in
// row order) and counts the rows per cluster, all with integer results;
// a cluster's rows are then cut into pieces of at most kPieceRows sorted
// positions (so one large cluster cannot serialize the pass):
// - center_piece_kernel: one CTA per (piece, block of 128 columns); thread
//   j walks the piece's rows in sorted order and sums the product
//   w_r * x_rj, taken at w's width (X upcast from its storage width), in
//   double; the column after the last one sums w_r. One double partial per
//   piece and column.
// - center_reduce_kernel: one CTA per (cluster, block of columns) sums the
//   cluster's pieces in piece order, in double.
// Bound: bytes. The pass reads X once (through the sorted order, a gather
// of whole rows) plus w and the order; the sums are n*d adds. At the
// KMeans configuration (n = 10M, d = 128, bf16) that is 2.56 GB of X,
// 0.76 ms at an H100 SXM's 3.35 TB/s (data sheet). Scratch: the pieces'
// partials, (n/kPieceRows + k) x (d + 1) doubles (6 MB there), beside the
// wrapper's sort (the order, n int64, and the sort's own buffers).
//
// Plain C interface (loaded with ctypes): every entry point returns a
// cudaError_t, 0 on success.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCols = 128;         // columns a CTA sums
constexpr int kPieceRows = 2048;   // sorted rows of one piece, at most

// an element of X at the accumulator width W (w's dtype)
template <typename W, typename T>
__device__ __forceinline__ W as_w(T v) {
  return (W)v;
}
template <>
__device__ __forceinline__ float as_w<float, __nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <>
__device__ __forceinline__ double as_w<double, __nv_bfloat16>(
    __nv_bfloat16 v) {
  return (double)__bfloat162float(v);
}

// piece_start: k+1 exclusive prefix sums of the pieces per cluster;
// offsets: k+1 exclusive prefix sums of the rows per cluster; order: the
// rows sorted by cluster. partials: (pieces, n_cols + 1) doubles.
template <typename T, typename W>
__global__ void __launch_bounds__(kCols)
    center_piece_kernel(const T* __restrict__ x, const W* __restrict__ w,
                        const int64_t* __restrict__ order,
                        const int64_t* __restrict__ offsets,
                        const int64_t* __restrict__ piece_start, int k,
                        long long ld, int n_cols,
                        double* __restrict__ partials) {
  const long long p = blockIdx.x;
  if (p >= piece_start[k]) return;
  // the cluster of piece p: the last c with piece_start[c] <= p
  int lo = 0, hi = k;
  while (hi - lo > 1) {
    const int mid = (lo + hi) / 2;
    if (piece_start[mid] <= p) lo = mid; else hi = mid;
  }
  const int c = lo;
  const long long first = offsets[c] + (p - piece_start[c]) * kPieceRows;
  long long last = first + kPieceRows;
  if (last > offsets[c + 1]) last = offsets[c + 1];
  const int col = blockIdx.y * kCols + threadIdx.x;
  if (col > n_cols) return;
  double s = 0.0;
  if (col < n_cols) {
    long long i = first;
    for (; i + 4 <= last; i += 4) {  // four rows' loads in flight
      long long r[4];
      W v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) r[u] = order[i + u];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        v[u] = as_w<W, T>(x[r[u] * ld + col]) * w[r[u]];
#pragma unroll
      for (int u = 0; u < 4; ++u) s += (double)v[u];
    }
    for (; i < last; ++i) {
      const long long r = order[i];
      s += (double)(as_w<W, T>(x[r * ld + col]) * w[r]);
    }
  } else {  // the weights' column
    for (long long i = first; i < last; ++i) s += (double)w[order[i]];
  }
  partials[p * (n_cols + 1) + col] = s;
}

// sums: (k, n_cols) and counts: (k,) doubles, each the cluster's pieces
// summed in piece order.
__global__ void __launch_bounds__(kCols)
    center_reduce_kernel(const double* __restrict__ partials,
                         const int64_t* __restrict__ piece_start, int k,
                         int n_cols, double* __restrict__ sums,
                         double* __restrict__ counts) {
  const int c = blockIdx.x;
  const int col = blockIdx.y * kCols + threadIdx.x;
  if (c >= k || col > n_cols) return;
  double s = 0.0;
  for (long long p = piece_start[c]; p < piece_start[c + 1]; ++p)
    s += partials[p * (n_cols + 1) + col];
  if (col < n_cols) sums[(long long)c * n_cols + col] = s;
  else counts[c] = s;
}

using PieceFn = const void*;

template <typename T>
PieceFn pick_w(int w_dtype) {
  if (w_dtype == 0)
    return reinterpret_cast<PieceFn>(&center_piece_kernel<T, float>);
  if (w_dtype == 3)
    return reinterpret_cast<PieceFn>(&center_piece_kernel<T, double>);
  return nullptr;
}

// dtype codes: 0 float32, 1 bfloat16, 3 float64
PieceFn piece_kernel_for(int x_dtype, int w_dtype) {
  if (x_dtype == 0) return pick_w<float>(w_dtype);
  if (x_dtype == 1) return pick_w<__nv_bfloat16>(w_dtype);
  if (x_dtype == 3) return pick_w<double>(w_dtype);
  return nullptr;
}

}  // namespace

extern "C" {

// Sorted rows one piece holds, at most: the wrapper sizes the partials as
// (ceil(n / rows) + k) x (n_cols + 1) doubles.
int center_sums_piece_rows() { return kPieceRows; }

// x: (n, ld) row-major (only its first n_cols columns are summed; n_cols
// = 0 sums the weights alone); w: (n,); order, offsets, piece_start as
// above, on the device; max_pieces: the partials' rows. Writes sums
// (k, n_cols) and counts (k,) as doubles.
int center_sums_launch(int x_dtype, int w_dtype, const void* x,
                       const void* w, const int64_t* order,
                       const int64_t* offsets, const int64_t* piece_start,
                       int k, long long ld, int n_cols, long long max_pieces,
                       double* partials, double* sums, double* counts,
                       void* stream) {
  PieceFn fn = piece_kernel_for(x_dtype, w_dtype);
  if (fn == nullptr || k < 1 || n_cols < 0 || ld < n_cols ||
      max_pieces < 0 || max_pieces > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const unsigned col_blocks = (unsigned)((n_cols + 1 + kCols - 1) / kCols);
  if (max_pieces > 0) {
    void* args[] = {const_cast<void**>(&x), const_cast<void**>(&w),
                    &order, &offsets, &piece_start, &k, &ld, &n_cols,
                    &partials};
    cudaError_t err = cudaLaunchKernel(
        fn, dim3((unsigned)max_pieces, col_blocks), dim3(kCols), args, 0, s);
    if (err == cudaSuccess) err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  center_reduce_kernel<<<dim3((unsigned)k, col_blocks), kCols, 0, s>>>(
      partials, piece_start, k, n_cols, sums, counts);
  return (int)cudaGetLastError();
}

}  // extern "C"
