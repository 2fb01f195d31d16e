// Segment reductions of message rows, in a fixed order.
//
// Replaces no Pallas kernel. It stands for the reference's scatters of rows
// into dense rows by a destination index:
//
// - GraphX's message merge, `jax.ops.segment_{sum,min,max}` at
//   cycloneml_tpu/graph/graph.py:143 (Pregel and the graph library run on
//   it: PageRank's sums, connected components' int32 label minima,
//   shortest paths' minima, label propagation's n-wide one-hot sums,
//   SVD++'s factor sums);
// - Word2Vec's updates, `.at[idx].add` at
//   cycloneml_tpu/ml/feature/word2vec.py:125-127 (negative sampling) and
//   :190-191 (hierarchical softmax), here the accumulate form below.
//
// On the card a scatter-add (index_add_, or float atomics of any kind)
// adds a destination's rows in the order the threads happen to run, so two
// runs would differ in the last bits and two fits would part. Here the
// rows come sorted stably by destination (ops/kernels.py segment_order: a
// stable sort, the offsets by a search of the sorted keys, integer set-up)
// and every output is reduced in an order fixed by the data alone.
//
// The reduction: out[v, c] = merge over rows r in
// [offsets[v], offsets[v + 1]) of msgs[rows[r], c] (msgs[r, c] without
// `rows`), for merge M = sum, min or max; a segment with no rows holds the
// merge's identity (0; +inf or -inf for floats; INT_MAX or INT_MIN for
// int32), the reference's merge_identity (graph/graph.py:212-222). The
// accumulate form (sum only) adds each non-empty segment's sum into out
// and leaves the rows of empty segments untouched: Word2Vec adds its
// updates into W in place. One warp a task, a task one (piece of a
// segment, tile of kp columns), kp = the least power of two >= k, at most
// 32; the warp's lanes are G = 32 / kp groups of kp columns:
//
// - lane l takes column tile x kp + l % kp and the piece's rows g, g + G,
//   g + 2G, ... (g = l / kp): the i-th of them goes into the lane's
//   accumulator i mod 4 (four independent chains keep four loads in
//   flight), and the four are combined as (a0 + a1) + (a2 + a3);
// - the G groups are combined by a fixed xor-shuffle tree (offsets kp,
//   2 kp, ..., 16); every lane ends with the same bits (each level adds
//   equal pairs in either order, and float addition commutes), and lane
//   g = 0 writes.
//
// So k >= 32 puts the lanes on columns and walks the rows one at a time;
// k = 1 (PageRank, degrees) puts 32 strided rows in flight a step. A task
// is a piece of a segment: at most piece_rows (512) of its rows, the
// pieces cut in row order (ops/kernels.py segment_pieces, a table built
// once a graph order), so that a hub's rows are walked by many warps at
// once (an R-MAT vertex's in-edges; Word2Vec's most frequent words, and
// the Huffman tree's node 0, which takes every padded path slot). A
// segment of one piece is written by its task (segment_pieces_kernel); a
// segment of several has each piece's merge kept in a scratch row, and
// segment_merge_kernel merges them in piece order, a lane a column. The
// order depends on the offsets, k and nothing else: two launches on the
// same inputs give the same bits.
//
// Sums: float32 rows are summed in double and rounded once to float;
// float64 rows in double; int32 rows in 64-bit integers, then wrapped to
// int32 (two's complement, as int32 addition in any order). A float32
// output stays within one float rounding (2^-24 relative) of its exact sum
// plus (m - 1) 2^-53 of the sum of its m values' magnitudes (the pieces'
// sums and their merge are all double); the accumulate form adds out's own
// value in the same double, so one rounding a launch. Min and max are
// exact in any order.
//
// What bounds it on the card: bytes. The rows are read once, the offsets
// once (twice at a tile boundary, from L2), the output written once (the
// accumulate form reads it once more): PageRank on 68,993,773 edges reads
// 276 MB of float messages and writes 17 MB of ranks, ~0.09 ms at 3.35
// TB/s. This design is a simple one and is latency-bound where segments
// are short and k is small: a warp's task is three dependent reads (its
// piece's segment, the segment's offsets, then its rows) before its store;
// a hub costs at most a piece's walk and one merge.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kWarps = 8;    // warps a CTA
constexpr int kUnroll = 4;   // accumulator chains a lane
constexpr unsigned kFull = 0xffffffffu;

enum Merge { kSum = 0, kMin = 1, kMax = 2 };
enum Dtype { kF32 = 0, kF64 = 1, kI32 = 2 };

template <typename T, int M> struct Acc { using type = T; };
template <> struct Acc<float, kSum> { using type = double; };
template <> struct Acc<int, kSum> { using type = long long; };

template <typename A, int M> __device__ __forceinline__ A identity();
template <> __device__ __forceinline__ double identity<double, kSum>() { return 0.0; }
template <> __device__ __forceinline__ long long identity<long long, kSum>() { return 0; }
template <> __device__ __forceinline__ float identity<float, kMin>() { return __int_as_float(0x7f800000); }
template <> __device__ __forceinline__ float identity<float, kMax>() { return __int_as_float((int)0xff800000u); }
template <> __device__ __forceinline__ double identity<double, kMin>() { return __longlong_as_double(0x7ff0000000000000LL); }
template <> __device__ __forceinline__ double identity<double, kMax>() { return __longlong_as_double((long long)0xfff0000000000000ULL); }
template <> __device__ __forceinline__ int identity<int, kMin>() { return INT_MAX; }
template <> __device__ __forceinline__ int identity<int, kMax>() { return INT_MIN; }

template <int M, typename A>
__device__ __forceinline__ A combine(A a, A b) {
  if (M == kSum) return a + b;
  if (M == kMin) return b < a ? b : a;
  return b > a ? b : a;
}

template <typename T, int M>
__global__ void __launch_bounds__(kWarps * 32)
segment_pieces_kernel(const T* __restrict__ msgs, long long ld, int k,
                      const long long* __restrict__ offsets,
                      const long long* __restrict__ rows,
                      const int* __restrict__ piece_seg,
                      const long long* __restrict__ piece_start,
                      long long n_seg, long long n_pieces, int piece_rows,
                      int kp, int tiles,
                      int accumulate, T* __restrict__ out, long long ld_out,
                      typename Acc<T, M>::type* __restrict__ partial) {
  using A = typename Acc<T, M>::type;
  const int lane = threadIdx.x & 31;
  const int G = 32 / kp;
  const int g = lane / kp;
  const long long n_tasks = n_pieces * tiles;
  const long long stride = (long long)gridDim.x * kWarps;
  for (long long t = (long long)blockIdx.x * kWarps + threadIdx.x / 32;
       t < n_tasks; t += stride) {
    const long long p = t / tiles;
    const int c = (int)(t - p * tiles) * kp + lane % kp;
    const long long v = piece_seg[p];
    if (v >= n_seg) continue;  // past the real pieces: the whole warp
    const long long p0 = piece_start[v];
    const bool single = piece_start[v + 1] - p0 == 1;
    const long long lo = offsets[v] + (p - p0) * piece_rows;
    const long long end = offsets[v + 1];
    const long long hi = lo + piece_rows < end ? lo + piece_rows : end;
    if (accumulate && lo == hi) continue;  // the same piece, whole warp
    A acc[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) acc[u] = identity<A, M>();
    if (c < k) {
      long long r = lo + g;
      for (; r + (kUnroll - 1) * (long long)G < hi; r += kUnroll * G) {
        T x[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const long long row = r + (long long)u * G;
          x[u] = msgs[(rows ? rows[row] : row) * ld + c];
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          acc[u] = combine<M, A>(acc[u], (A)x[u]);
      }
      // the last rows, fewer than four: row i still into chain i mod 4
#pragma unroll
      for (int u = 0; u < kUnroll - 1; ++u) {
        const long long row = r + (long long)u * G;
        if (row < hi)
          acc[u] = combine<M, A>(
              acc[u], (A)msgs[(rows ? rows[row] : row) * ld + c]);
      }
    }
    A part = combine<M, A>(combine<M, A>(acc[0], acc[1]),
                           combine<M, A>(acc[2], acc[3]));
    for (int off = kp; off < 32; off <<= 1)
      part = combine<M, A>(part, __shfl_xor_sync(kFull, part, off));
    if (g == 0 && c < k) {
      if (!single) {
        partial[p * k + c] = part;
      } else {
        T* o = out + v * ld_out + c;
        if (M == kSum && accumulate)
          *o = (T)((A)*o + part);
        else
          *o = (T)part;
      }
    }
  }
}

// The segments of several pieces: each output the merge of its pieces'
// partials in piece order, a lane a column.
template <typename T, int M>
__global__ void __launch_bounds__(kWarps * 32)
segment_merge_kernel(const int* __restrict__ multi, long long n_multi,
                     const long long* __restrict__ piece_start, int k,
                     int accumulate,
                     const typename Acc<T, M>::type* __restrict__ partial,
                     T* __restrict__ out, long long ld_out) {
  using A = typename Acc<T, M>::type;
  const int lane = threadIdx.x & 31;
  const int tiles = (k + 31) / 32;
  const long long n_tasks = n_multi * tiles;
  const long long stride = (long long)gridDim.x * kWarps;
  for (long long t = (long long)blockIdx.x * kWarps + threadIdx.x / 32;
       t < n_tasks; t += stride) {
    const long long j = t / tiles;
    const int c = (int)(t - j * tiles) * 32 + lane;
    const long long v = multi[j];
    if (c >= k || v < 0) continue;  // v < 0: past the real list
    const long long p1 = piece_start[v + 1];
    long long p = piece_start[v];
    A acc = partial[p * k + c];
    for (++p; p < p1; ++p) acc = combine<M, A>(acc, partial[p * k + c]);
    T* o = out + v * ld_out + c;
    if (M == kSum && accumulate)
      *o = (T)((A)*o + acc);
    else
      *o = (T)acc;
  }
}

struct Launch {
  const void* msgs;
  long long ld;
  int k;
  const long long* offsets;
  const long long* rows;
  const int* piece_seg;
  const long long* piece_start;
  long long n_seg;
  long long n_pieces;
  int piece_rows;
  const int* multi;
  long long n_multi;
  void* partial;
  int accumulate;
  void* out;
  long long ld_out;
  cudaStream_t stream;
};

unsigned grid_of(long long tasks) {
  long long blocks = (tasks + kWarps - 1) / kWarps;
  return (unsigned)(blocks > 0x7fffffffLL ? 0x7fffffffLL : blocks);
}

template <typename T, int M>
cudaError_t launch(const Launch& a) {
  using A = typename Acc<T, M>::type;
  int kp = 1;
  while (kp < a.k && kp < 32) kp <<= 1;
  const int tiles = (a.k + kp - 1) / kp;
  segment_pieces_kernel<T, M><<<grid_of(a.n_pieces * tiles), kWarps * 32,
                                0, a.stream>>>(
      static_cast<const T*>(a.msgs), a.ld, a.k, a.offsets, a.rows,
      a.piece_seg, a.piece_start, a.n_seg, a.n_pieces, a.piece_rows, kp,
      tiles,
      a.accumulate, static_cast<T*>(a.out), a.ld_out,
      static_cast<A*>(a.partial));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a.n_multi == 0) return err;
  segment_merge_kernel<T, M><<<grid_of(a.n_multi * ((a.k + 31) / 32)),
                               kWarps * 32, 0, a.stream>>>(
      a.multi, a.n_multi, a.piece_start, a.k, a.accumulate,
      static_cast<const A*>(a.partial), static_cast<T*>(a.out), a.ld_out);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_merge(int merge, const Launch& a) {
  switch (merge) {
    case kSum: return launch<T, kSum>(a);
    case kMin: return launch<T, kMin>(a);
    case kMax: return launch<T, kMax>(a);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// msgs: (m, ld) row-major, its first k columns reduced (dtype 0 float32, 1
// float64, 2 int32); offsets: (n_seg + 1) int64, nondecreasing, segment v's
// rows at positions offsets[v] .. offsets[v + 1] - 1; rows: null (position
// r is row r of msgs) or (m,) int64 row ids; the pieces (segment_pieces):
// piece_seg (n_pieces,) int32, each piece's segment, in segment order
// (n_pieces a bound: n_seg past the real pieces); piece_start (n_seg + 1,)
// int64, each segment's first piece (at least one a segment); piece_rows,
// a piece's rows at most; multi (n_multi,) int32, the segments of several
// pieces (-1 past the real list); partial: n_pieces x k accumulators
// (double for float sums, int64 for int32 sums, else the rows' type; null
// when n_multi is 0); out: (n_seg, ld_out) of the rows' dtype. merge 0
// sum, 1 min, 2 max; accumulate (sum only) adds into out where a segment
// has rows. Returns the launches' cudaError_t.
int segment_reduce_launch(int dtype, int merge, int accumulate,
                          const void* msgs, long long ld, int k,
                          const long long* offsets, const long long* rows,
                          long long n_seg, const int* piece_seg,
                          const long long* piece_start, long long n_pieces,
                          int piece_rows, const int* multi, long long n_multi,
                          void* partial, void* out, long long ld_out,
                          void* stream) {
  if (k < 0 || ld < k || ld_out < k || n_seg < 0 || merge < kSum ||
      merge > kMax || (accumulate && merge != kSum) || piece_rows < 1 ||
      n_pieces < n_seg || n_multi < 0 || (n_multi && !partial))
    return (int)cudaErrorInvalidValue;
  if (k == 0 || n_seg == 0) return (int)cudaSuccess;
  const Launch a{msgs, ld, k, offsets, rows, piece_seg, piece_start,
                 n_seg, n_pieces, piece_rows, multi, n_multi, partial,
                 accumulate, out, ld_out, static_cast<cudaStream_t>(stream)};
  switch (dtype) {
    case kF32: return (int)launch_merge<float>(merge, a);
    case kF64: return (int)launch_merge<double>(merge, a);
    case kI32: return (int)launch_merge<int>(merge, a);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
