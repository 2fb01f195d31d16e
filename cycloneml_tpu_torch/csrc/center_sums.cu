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
// The order. The rows of each cluster are taken in row order (a stable
// sort of the assignment), and a cluster's rows are cut into pieces of at
// most kPieceRows sorted positions, so that one large cluster cannot
// serialize the pass. Each piece sums, per column, the product w_r * x_rj
// taken at w's width (X upcast from its storage width) into a double, in
// the piece's row order, and the weights column sums w_r the same way; the
// pieces of a cluster are then summed in piece order, in double.
//
// Two instances build the stable order, by k:
// - counting (k <= kCountMaxK, every Lloyd step and k-means|| pass at
//   configuration 3): a stable counting sort written here, reading the
//   assignment as K3 writes it (int32), over blocks of kSortRows rows:
//   count_hist_kernel counts each block's rows per cluster in shared
//   memory (integer atomics: the counts do not depend on their order) into
//   a (cluster, block) table; count_scan_kernel scans it in (cluster,
//   block) order, one warp a cluster, and count_offsets_kernel scans the
//   clusters' totals into their row and piece offsets;
//   count_scatter_kernel places each block's rows in shared memory in
//   (cluster, row) order: a warp takes a run of kWarpRows rows, counts it
//   per cluster, then ranks each row among the lower lanes of its round
//   with the same cluster (peers_of: one ballot a bit of the cluster id,
//   then __popc) and after its earlier rounds (a per-warp, per-cluster
//   counter), the warps in warp order; the block's rows then go out to the
//   order a cluster at a time, in runs (a 4-byte store a row scattered
//   over the clusters took 0.15 ms of 0.34 at configuration 3 on an H100
//   SXM). The order is the stable one, int32.
// - sorted (k past kCountMaxK, where the scatter's per-warp counters no
//   longer fit shared memory): the wrapper's torch.sort of the assignment,
//   its indices cast to int32, and the offsets by bincount and cumsum.
// Both then run the same sums on their order, so they are bitwise equal:
// center_warp_kernel, one warp a piece: lane l holds columns 4l..4l+3 of a
// 128-column walk (bf16; 2 a chunk of f32, 1 of f64), so a row is one
// 8-byte load a lane, 256 bytes a warp, 16 rows' loads in flight (8 of
// f32, 4 of f64: 128 bytes a lane); w read once a row and shuffled to the
// lanes, its column summed by the same warp; at most 102 registers, so
// that 20 warps an SM keep 80 KB of X in flight while others convert and
// sum. center_reduce_kernel, one CTA per (cluster, block of columns), then
// sums the pieces in piece order.
//
// Bound: bytes. The pass reads X once (through the sorted order, a gather
// of whole rows) plus w and the assignment; the sums are n*d adds. At the
// KMeans configuration (n = 10M, d = 128, bf16, k = 1000) that is 2.56 GB
// of X, 0.788 ms at an H100 SXM's 3.35 TB/s (data sheet) with w, the
// assignment and the output. The float-to-double conversion of every
// product (16 a clock an SM by the CUDA guide's table) takes 0.35 ms
// alone. The counting instance reads the assignment three times (16 bytes
// a row with the order's write); the sorted instance's radix sort of n
// int64 keys and values costs about as much as the sums. Scratch: the
// order (n int32), the (cluster, block) table (k x ceil(n / kSortRows)
// int32, 2.4 MB there) and the pieces' partials, (n / kPieceRows + k) x
// (d + 1) doubles (6 MB there).
//
// Plain C interface (loaded with ctypes): every entry point returns a
// cudaError_t, 0 on success.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kCols = 128;         // columns a CTA of the reduce sums
constexpr int kPieceRows = 2048;   // sorted rows of one piece, at most
constexpr int kSortWarps = 8;      // warps of a counting-sort CTA
constexpr int kSortThreads = kSortWarps * 32;
constexpr int kSortRows = 1 << 14;  // rows of one block of the table
constexpr int kWarpRows = kSortRows / kSortWarps;  // rows of a warp's run
constexpr int kSortAhead = 16;     // rounds of 32 rows loaded at once
constexpr int kCountMaxK = 4096;   // the counting instance's largest k
                                   // (the scatter's shared memory: 224 KB)
constexpr int kPieceWarps = 4;     // pieces (warps) of a summing CTA
constexpr int kPieceCtas = 5;      // summing CTAs an SM holds (at most 102
                                   // registers a thread)
constexpr int kWalkCols = 128;     // columns a warp sums in one walk
constexpr int kLaneBytes = 8;      // bytes of X a lane copies a row a chunk
constexpr int kAheadBytes = 128;   // bytes of X in flight a lane
constexpr unsigned kFull = 0xffffffffu;

// the product at W's width, rounded before it is summed (never contracted
// into the double sum)
__device__ __forceinline__ float mul_w(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_w(double a, double b) {
  return __dmul_rn(a, b);
}

// the cluster of piece p: the last c with piece_start[c] <= p
__device__ __forceinline__ int piece_cluster(
    const int64_t* __restrict__ piece_start, int k, long long p) {
  int lo = 0, hi = k;
  while (hi - lo > 1) {
    const int mid = (lo + hi) / 2;
    if (piece_start[mid] <= p) lo = mid; else hi = mid;
  }
  return lo;
}

// -- the counting instance: a stable counting sort -------------------------
//
// best: (n,) int32 clusters; a row outside [0, k) is neither counted nor
// placed. table: (k, nb) int32, nb = ceil(n / kSortRows) blocks. BITS:
// the bits of k - 1 (cluster_bits), a template argument so that the
// ballots of peers_of unroll.

// rounds [j, j + kSortAhead) of the 32-row rounds starting at `first`:
// lane l's row of round u is first + 32 u + l, -1 past `end`
__device__ __forceinline__ void load_rounds(const int* __restrict__ best,
                                            long long first, long long end,
                                            int lane, int (&c)[kSortAhead]) {
#pragma unroll
  for (int u = 0; u < kSortAhead; ++u) {
    const long long r = first + 32 * u + lane;
    c[u] = r < end ? __ldg(best + r) : -1;
  }
}

// the lanes whose cluster equals this lane's, among the lanes where `ok`
// holds: one ballot a bit of the cluster ids. __match_any_sync does the
// same, but at a cost that grows with the distinct values of a warp (32
// here at k = 1,000).
template <int BITS>
__device__ __forceinline__ unsigned peers_of(int c, bool ok) {
  unsigned peers = __ballot_sync(kFull, ok);
#pragma unroll
  for (int b = 0; b < BITS; ++b) {
    const bool one = (c >> b) & 1;
    const unsigned ones = __ballot_sync(kFull, one);
    peers &= one ? ones : ~ones;
  }
  return peers;
}

int cluster_bits(int k) {
  int bits = 0;
  while ((1 << bits) < k) ++bits;
  return bits;
}

// the rows of a block: [b kSortRows, min(n, (b + 1) kSortRows)); warp w's
// run is its w-th kWarpRows of them
__device__ __forceinline__ void warp_run(long long n, int warp,
                                         long long& first, long long& stop) {
  long long end = (long long)(blockIdx.x + 1) * kSortRows;
  if (end > n) end = n;
  first = (long long)blockIdx.x * kSortRows + (long long)warp * kWarpRows;
  stop = first + kWarpRows < end ? first + kWarpRows : end;
}

// each cluster's rows in [first, stop) counted into counts[] (integer
// shared-memory atomics: the counts do not depend on their order)
__device__ __forceinline__ void count_run(const int* __restrict__ best,
                                          long long first, long long stop,
                                          int k, int lane, int* counts) {
  for (long long j = first; j < stop; j += 32 * kSortAhead) {
    int c[kSortAhead];
    load_rounds(best, j, stop, lane, c);
#pragma unroll
    for (int u = 0; u < kSortAhead; ++u)
      if (c[u] >= 0 && c[u] < k) atomicAdd(&counts[c[u]], 1);
  }
}

__global__ void __launch_bounds__(kSortThreads)
    count_hist_kernel(const int* __restrict__ best, long long n, int k,
                      int nb, int* __restrict__ table) {
  extern __shared__ int hist[];
  for (int c = threadIdx.x; c < k; c += kSortThreads) hist[c] = 0;
  __syncthreads();
  long long first, stop;
  warp_run(n, threadIdx.x >> 5, first, stop);
  count_run(best, first, stop, k, threadIdx.x & 31, hist);
  __syncthreads();
  for (int c = threadIdx.x; c < k; c += kSortThreads)
    table[(long long)c * nb + blockIdx.x] = hist[c];
}

// one warp a cluster: its row of the table becomes the exclusive prefix
// sums over its blocks (lane l scans a segment of them), and rows[c] the
// cluster's rows
__global__ void __launch_bounds__(kSortThreads)
    count_scan_kernel(int* __restrict__ table, int k, int nb,
                      int* __restrict__ rows) {
  const int c = blockIdx.x * kSortWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (c >= k) return;
  int* t = table + (long long)c * nb;
  const int seg = (nb + 31) / 32;
  const int lo = lane * seg < nb ? lane * seg : nb;
  const int hi = lo + seg < nb ? lo + seg : nb;
  int s = 0;
  for (int j = lo; j < hi; ++j) s += t[j];
  int incl = s;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += y;
  }
  int run = incl - s;
  for (int j = lo; j < hi; ++j) {
    const int v = t[j];
    t[j] = run;
    run += v;
  }
  if (lane == 31) rows[c] = incl;
}

// one CTA of 1024 threads: the exclusive prefix sums over the clusters of
// their rows (offsets) and their pieces (piece_start), k + 1 each
constexpr int kOffsetThreads = 1024;
constexpr int kScans = 2;

__device__ __forceinline__ void cluster_terms(int rows,
                                              long long (&t)[kScans]) {
  t[0] = rows;
  t[1] = (rows + kPieceRows - 1) / kPieceRows;
}

__global__ void __launch_bounds__(kOffsetThreads)
    count_offsets_kernel(const int* __restrict__ rows, int k,
                         int64_t* __restrict__ offsets,
                         int64_t* __restrict__ piece_start) {
  __shared__ long long warp_tot[kScans][32];
  int64_t* out[kScans] = {offsets, piece_start};
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int per = (k + kOffsetThreads - 1) / kOffsetThreads;
  const int lo = threadIdx.x * per < k ? threadIdx.x * per : k;
  const int hi = lo + per < k ? lo + per : k;
  long long own[kScans] = {0, 0}, incl[kScans], t[kScans];
  for (int c = lo; c < hi; ++c) {
    cluster_terms(rows[c], t);
#pragma unroll
    for (int q = 0; q < kScans; ++q) own[q] += t[q];
  }
#pragma unroll
  for (int q = 0; q < kScans; ++q) {
    incl[q] = own[q];  // inclusive scans, lane order
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const long long y = __shfl_up_sync(kFull, incl[q], o);
      if (lane >= o) incl[q] += y;
    }
    if (lane == 31) warp_tot[q][warp] = incl[q];
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int q = 0; q < kScans; ++q) {
      long long v = warp_tot[q][lane];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const long long y = __shfl_up_sync(kFull, v, o);
        if (lane >= o) v += y;
      }
      warp_tot[q][lane] = v;  // inclusive over warps
    }
  }
  __syncthreads();
  long long run[kScans];
#pragma unroll
  for (int q = 0; q < kScans; ++q)
    run[q] = incl[q] - own[q] + (warp > 0 ? warp_tot[q][warp - 1] : 0);
  for (int c = lo; c < hi; ++c) {
    cluster_terms(rows[c], t);
#pragma unroll
    for (int q = 0; q < kScans; ++q) {
      out[q][c] = run[q];
      run[q] += t[q];
    }
  }
  if (threadIdx.x == 0)
#pragma unroll
    for (int q = 0; q < kScans; ++q) out[q][k] = warp_tot[q][31];
}

// the scatter's shared memory: cur[kSortWarps][k] (each warp's next
// block-local position per cluster), loc[k + 1] (each cluster's first
// block-local position), goff[k] (its first position in the order) and
// the block's rows in their local order
int scatter_smem(int k) {
  return (int)sizeof(int) * (kSortWarps * k + (k + 1) + k + kSortRows);
}

// every row's position in the stable order: order[position] = row. The
// block's rows are placed in shared memory first, then copied out a
// cluster at a time, so that the order is written in runs.
template <int BITS>
__global__ void __launch_bounds__(kSortThreads)
    count_scatter_kernel(const int* __restrict__ best, long long n, int k,
                         int nb, const int* __restrict__ table,
                         const int64_t* __restrict__ offsets,
                         int* __restrict__ order) {
  extern __shared__ int smem[];
  int* cur = smem;                      // [kSortWarps][k]
  int* loc = cur + kSortWarps * k;      // [k + 1]
  int* goff = loc + k + 1;              // [k]
  int* local = goff + k;                // [kSortRows]
  __shared__ int warp_sum[kSortWarps];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const unsigned lower = (1u << lane) - 1u;
  for (int i = threadIdx.x; i < kSortWarps * k; i += kSortThreads) cur[i] = 0;
  __syncthreads();
  int* mine = cur + warp * k;
  long long first, stop;
  warp_run(n, warp, first, stop);
  count_run(best, first, stop, k, lane, mine);
  __syncthreads();
  // block-local positions in (cluster, warp, row) order: thread t takes
  // clusters [t per, (t + 1) per), the threads in order
  const int per = (k + kSortThreads - 1) / kSortThreads;
  const int lo = threadIdx.x * per < k ? threadIdx.x * per : k;
  const int hi = lo + per < k ? lo + per : k;
  int tot = 0;
  for (int c = lo; c < hi; ++c)
    for (int v = 0; v < kSortWarps; ++v) tot += cur[v * k + c];
  int incl = tot;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) warp_sum[warp] = incl;
  __syncthreads();
  int run = incl - tot;
  for (int v = 0; v < warp; ++v) run += warp_sum[v];
  for (int c = lo; c < hi; ++c) {
    loc[c] = run;
    goff[c] = (int)offsets[c] + table[(long long)c * nb + blockIdx.x];
    for (int v = 0; v < kSortWarps; ++v) {
      const int t = cur[v * k + c];
      cur[v * k + c] = run;
      run += t;
    }
  }
  if (threadIdx.x == kSortThreads - 1) loc[k] = run;  // the rows placed
  __syncthreads();
  // each row after the lower lanes of its round and the earlier rounds
  for (long long j = first; j < stop; j += 32 * kSortAhead) {
    int c[kSortAhead];
    load_rounds(best, j, stop, lane, c);
#pragma unroll
    for (int u = 0; u < kSortAhead; ++u) {
      const bool ok = c[u] >= 0 && c[u] < k;
      const unsigned peers = peers_of<BITS>(c[u], ok);
      if (ok)
        local[mine[c[u]] + __popc(peers & lower)] = (int)(j + 32 * u + lane);
      __syncwarp();
      if (ok && lane == __ffs(peers) - 1) mine[c[u]] += __popc(peers);
      __syncwarp();
    }
  }
  __syncthreads();
  // cluster c's rows of this block: local[loc[c], loc[c + 1]) to
  // order[goff[c], ...), one warp a cluster
  for (int c = warp; c < k; c += kSortWarps) {
    const int a = loc[c], len = loc[c + 1] - a, g = goff[c];
    for (int i = lane; i < len; i += 32) order[g + i] = local[a + i];
  }
}

// -- the sums: one warp a piece ------------------------------------------

// 8 bytes of X as a lane loads them: V elements of T, at W's width
template <typename T> struct Lane;
template <> struct Lane<__nv_bfloat16> {
  using Bits = unsigned short;
  __device__ static float at(unsigned long long q, int v) {
    return __uint_as_float(((unsigned)(q >> (16 * v)) & 0xffffu) << 16);
  }
};
template <> struct Lane<float> {
  using Bits = unsigned int;
  __device__ static float at(unsigned long long q, int v) {
    return __uint_as_float((unsigned)(q >> (32 * v)));
  }
};
template <> struct Lane<double> {
  using Bits = unsigned long long;
  __device__ static double at(unsigned long long q, int) {
    return __longlong_as_double((long long)q);
  }
};

// order: (offsets[k],) int32 rows sorted by cluster; VEC: X's base and row
// stride are 8-byte aligned, so a lane's V columns are one 8-byte load.
template <typename T, typename W, bool VEC>
__global__ void __launch_bounds__(kPieceWarps * 32, kPieceCtas)
    center_warp_kernel(const T* __restrict__ x, const W* __restrict__ w,
                       const int* __restrict__ order,
                       const int64_t* __restrict__ offsets,
                       const int64_t* __restrict__ piece_start, int k,
                       long long ld, int n_cols,
                       double* __restrict__ partials) {
  constexpr int V = kLaneBytes / (int)sizeof(T);  // columns a lane a chunk
  constexpr int CH = kWalkCols / (32 * V);        // chunks of a walk
  constexpr int U = kAheadBytes / (kLaneBytes * CH);  // rows in flight
  static_assert(32 % U == 0, "a batch of 32 rows is whole groups");
  using Bits = typename Lane<T>::Bits;
  const int lane = threadIdx.x & 31;
  const long long p = (long long)blockIdx.x * kPieceWarps
                      + (threadIdx.x >> 5);
  if (p >= piece_start[k]) return;
  const int c = piece_cluster(piece_start, k, p);
  const long long first = offsets[c] + (p - piece_start[c]) * kPieceRows;
  long long last = first + kPieceRows;
  if (last > offsets[c + 1]) last = offsets[c + 1];
  double* out = partials + p * (n_cols + 1);
  const int walks = n_cols > 0 ? (n_cols + kWalkCols - 1) / kWalkCols : 1;
  for (int walk = 0; walk < walks; ++walk) {
    const int c0 = walk * kWalkCols + lane * V;  // the lane's first column
    double acc[CH][V];
#pragma unroll
    for (int h = 0; h < CH; ++h)
#pragma unroll
      for (int v = 0; v < V; ++v) acc[h][v] = 0.0;
    double sw = 0.0;
    // batches of 32 sorted rows: lane l holds row i0 + l and its weight;
    // the next batch's weights and the one after's rows load ahead
    int r_cur = first + lane < last ? order[first + lane] : 0;
    int r_nxt = first + 32 + lane < last ? order[first + 32 + lane] : 0;
    W w_cur = first + lane < last ? w[r_cur] : W(0);
    for (long long i0 = first; i0 < last; i0 += 32) {
      const W w_nxt = i0 + 32 + lane < last ? w[r_nxt] : W(0);
      const int r_far = i0 + 64 + lane < last ? order[i0 + 64 + lane] : 0;
      const int m = last - i0 < 32 ? (int)(last - i0) : 32;
      for (int j0 = 0; j0 < m; j0 += U) {
        unsigned long long q[U][CH];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const long long r = __shfl_sync(kFull, r_cur, j0 + u);
          const T* row = x + r * ld;
#pragma unroll
          for (int h = 0; h < CH; ++h) {
            const int col = c0 + h * 32 * V;
            q[u][h] = 0ull;
            if (j0 + u >= m) continue;
            if (VEC && col + V <= n_cols) {
              q[u][h] = __ldg(reinterpret_cast<const unsigned long long*>(
                  row + col));
            } else {
#pragma unroll
              for (int v = 0; v < V; ++v)
                if (col + v < n_cols)
                  q[u][h] |= (unsigned long long)__ldg(
                                 reinterpret_cast<const Bits*>(row + col + v))
                             << (8 * sizeof(T) * v);
            }
          }
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (j0 + u >= m) break;
          const W wr = __shfl_sync(kFull, w_cur, j0 + u);
#pragma unroll
          for (int h = 0; h < CH; ++h)
#pragma unroll
            for (int v = 0; v < V; ++v)
              acc[h][v] += (double)mul_w((W)Lane<T>::at(q[u][h], v), wr);
          sw += (double)wr;
        }
      }
      r_cur = r_nxt;
      w_cur = w_nxt;
      r_nxt = r_far;
    }
#pragma unroll
    for (int h = 0; h < CH; ++h)
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const int col = c0 + h * 32 * V + v;
        if (col < n_cols) out[col] = acc[h][v];
      }
    if (walk == 0 && lane == 0) out[n_cols] = sw;
  }
}

// -- the reduce --------------------------------------------------------------

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

using KernelFn = const void*;

template <typename T, bool VEC>
KernelFn pick_warp_w(int w_dtype) {
  if (w_dtype == 0)
    return reinterpret_cast<KernelFn>(&center_warp_kernel<T, float, VEC>);
  if (w_dtype == 3)
    return reinterpret_cast<KernelFn>(&center_warp_kernel<T, double, VEC>);
  return nullptr;
}

template <typename T>
KernelFn pick_warp(int w_dtype, bool vec) {
  return vec ? pick_warp_w<T, true>(w_dtype) : pick_warp_w<T, false>(w_dtype);
}

KernelFn warp_kernel_for(int x_dtype, int w_dtype, bool vec) {
  if (x_dtype == 0) return pick_warp<float>(w_dtype, vec);
  if (x_dtype == 1) return pick_warp<__nv_bfloat16>(w_dtype, vec);
  if (x_dtype == 3) return pick_warp<double>(w_dtype, vec);
  return nullptr;
}

int elem_bytes(int x_dtype) {
  return x_dtype == 1 ? 2 : x_dtype == 3 ? 8 : 4;
}

cudaError_t launch_reduce(const double* partials, const int64_t* piece_start,
                          int k, int n_cols, double* sums, double* counts,
                          cudaStream_t s) {
  const unsigned col_blocks = (unsigned)((n_cols + 1 + kCols - 1) / kCols);
  center_reduce_kernel<<<dim3((unsigned)k, col_blocks), kCols, 0, s>>>(
      partials, piece_start, k, n_cols, sums, counts);
  return cudaGetLastError();
}

template <int BITS>
cudaError_t scatter_at(const int* best, long long n, int k, int nb,
                       const int* table, const int64_t* offsets, int* order,
                       cudaStream_t s) {
  const int bytes = scatter_smem(k);
  cudaError_t err = cudaFuncSetAttribute(
      count_scatter_kernel<BITS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return err;
  count_scatter_kernel<BITS><<<nb, kSortThreads, bytes, s>>>(
      best, n, k, nb, table, offsets, order);
  return cudaGetLastError();
}

// the scatter at the bits of k - 1 (0 to 12: k <= kCountMaxK)
#define CENTER_BITS(F)                                                   \
  F(0) F(1) F(2) F(3) F(4) F(5) F(6) F(7) F(8) F(9) F(10) F(11) F(12)

cudaError_t launch_scatter(int bits, const int* best, long long n, int k,
                           int nb, const int* table, const int64_t* offsets,
                           int* order, cudaStream_t s) {
  switch (bits) {
#define CENTER_SCATTER(B) \
  case B: return scatter_at<B>(best, n, k, nb, table, offsets, order, s);
    CENTER_BITS(CENTER_SCATTER)
#undef CENTER_SCATTER
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Stages of a launch (bits of `stages`; a stage reads what the earlier
// ones wrote into the scratch, so one alone can be timed on a filled
// scratch): 1 the histogram, 2 the scans, 4 the scatter (the counting
// sort, k <= kCountMaxK), 8 the pieces' sums, 16 the reduce. The sorted
// instance takes 8 and 16 on the order and offsets the wrapper wrote.
enum { kHist = 1, kScan = 2, kScatter = 4, kPieces = 8, kReduce = 16 };

// Both instances. best: (n,) int32 on the device (read by the sort's
// stages only); table: k x ceil(n / kSortRows) int32; rows: k int32
// (both the sort's only, else null); order: (n,) int32 rows sorted by
// cluster; offsets and piece_start: k + 1 int64 prefix sums of the rows
// and the pieces per cluster; x: (n, ld) row-major (only its first n_cols
// columns are summed; n_cols = 0 sums the weights alone); w: (n,);
// max_pieces: the partials' rows, ceil(n / kPieceRows) + k (the wrapper
// mirrors kPieceRows, kSortRows and kCountMaxK). Writes sums (k, n_cols)
// and counts (k,) as doubles. x and w may be null when `stages` leaves
// out the sums (the order alone).
int center_sums_launch(int x_dtype, int w_dtype, const void* x,
                       const void* w, const int* best, long long n, int k,
                       long long ld, int n_cols, long long max_pieces,
                       int* table, int* rows, int* order, int64_t* offsets,
                       int64_t* piece_start, double* partials, double* sums,
                       double* counts, int stages, void* stream) {
  if (k < 1 || n < 0 || n > INT_MAX || n_cols < 0 || ld < n_cols ||
      max_pieces < 0 || max_pieces > 0x7fffffffLL ||
      ((stages & (kHist | kScan | kScatter)) && k > kCountMaxK))
    return (int)cudaErrorInvalidValue;
  const bool vec = (reinterpret_cast<uintptr_t>(x) % kLaneBytes == 0) &&
                   (ld * elem_bytes(x_dtype)) % kLaneBytes == 0;
  KernelFn fn = warp_kernel_for(x_dtype, w_dtype, vec);
  if ((stages & kPieces) && fn == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int nb = (int)((n + kSortRows - 1) / kSortRows);
  cudaError_t err = cudaSuccess;
  if ((stages & kHist) && nb > 0) {
    count_hist_kernel<<<nb, kSortThreads, k * sizeof(int), s>>>(best, n, k,
                                                                 nb, table);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  if (stages & kScan) {
    count_scan_kernel<<<(k + kSortWarps - 1) / kSortWarps, kSortThreads, 0,
                        s>>>(table, k, nb, rows);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    count_offsets_kernel<<<1, kOffsetThreads, 0, s>>>(rows, k, offsets,
                                                       piece_start);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  if ((stages & kScatter) && nb > 0) {
    err = launch_scatter(cluster_bits(k), best, n, k, nb, table, offsets,
                         order, s);
    if (err != cudaSuccess) return (int)err;
  }
  if ((stages & kPieces) && max_pieces > 0) {
    void* args[] = {const_cast<void**>(&x), const_cast<void**>(&w),
                    &order, &offsets, &piece_start, &k, &ld, &n_cols,
                    &partials};
    const unsigned ctas =
        (unsigned)((max_pieces + kPieceWarps - 1) / kPieceWarps);
    err = cudaLaunchKernel(fn, dim3(ctas), dim3(kPieceWarps * 32), args, 0,
                           s);
    if (err == cudaSuccess) err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (stages & kReduce)
    return (int)launch_reduce(partials, piece_start, k, n_cols, sums, counts,
                              s);
  return (int)cudaSuccess;
}

}  // extern "C"
