// The level histogram of the decision-tree engine, summed in a fixed order.
//
// Replaces no Pallas kernel. It stands for the reference's level histogram
// (cycloneml_tpu/ml/tree/impl.py:437-455), a scatter-add of every row's
// stat channels into a (node, feature, bin) table per tree
// (`tbl.at[idx.reshape(-1)].add(...)` at :451), vmapped over the trees of
// a forest. On the card a scatter-add (index_add_, or float atomics of any
// kind) adds each cell's rows in the order the threads happen to run, so
// two fits of the same data would grow different forests. Here every cell
// is the sum of its rows in an order fixed by the data alone:
//
// - the wrapper (ops/kernels.py tree_hist) sorts the real rows of each
//   tree stably by node (the center sums' counting sort, or torch.sort
//   past its keys): a (tree, node) key's rows lie together, in row order,
//   and rows at position -1 (settled, or out of the tree's sample) are
//   left out;
// - tree_hist_piece_kernel: one CTA of 8 warps a piece, at most
//   `piece_rows` consecutive sorted rows of one key. The piece's rows are
//   staged 512 at a time: their row ids, the bins of 8 features (one a
//   warp) and 4 channels, in shared memory. Lane l of the warp owning
//   feature f owns bins l, l + 32, ... (NS slots a pass) and adds, row
//   after row in sorted order, the channels of every row whose bin is its
//   own: in float over blocks of kFlushRows rows, each block's sum added
//   into a double; then writes its cells of the piece's partial table (d,
//   B, C), rounded once to float. Wider B takes passes of NS slots, more
//   channels passes of 4;
// - tree_hist_reduce_kernel: each output cell is the sum of its key's
//   pieces' partials in piece order, in double, rounded once to float (0
//   for a key with no rows).
//
// A cell stays within (kFlushRows + 1) float roundings of its exact sum,
// relative to the sum of its values' magnitudes (7.6e-6 at most; a float
// block's rounding plus one a piece and one a cell): a piece of
// bf16-valued features can put thousands of rows in one bin, and float
// sums of them in any order drift past 1e-5 on GBT's residual channels.
//
// What bounds it on the card: the bytes of `bins` (n x d int32, gathered
// once a tree in this design, so a forest level reads T copies), the
// channels (n x T x C float32) and the order, against instructions: each
// (row, feature) costs a warp a shared-memory read, a compare and a
// 16-byte shared read with 4 float adds. A piece's rows are staged
// once a (feature block, channel block, slot group), so for B <= 32 and C
// <= 4 each bin is read once a tree. Reading bins once for all trees of a
// forest, narrower bins and TMA staging are later work.
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;                  // features a feature block
constexpr int kThreads = kWarps * 32;
constexpr int kSubRows = 512;              // sorted rows staged at a time
constexpr int kChunk = 4;                  // channels a pass
constexpr int kFlushRows = 128;            // rows summed in float at a time

template <int NS>
__global__ void __launch_bounds__(kThreads)
tree_hist_piece_kernel(const int* __restrict__ bins,
                       const float* __restrict__ chans,
                       const int* __restrict__ order,
                       const int* __restrict__ piece_key,
                       const long long* __restrict__ piece_first,
                       const int* __restrict__ piece_len, long long n_rows,
                       int d, int n_bins, int C, int T, int t0, int a_pad,
                       float* __restrict__ partial) {
  __shared__ int rows_s[kSubRows];
  __shared__ int bins_s[kSubRows * kWarps];
  __shared__ float4 ch_s[kSubRows];
  float* chf = reinterpret_cast<float*>(ch_s);

  const long long p = blockIdx.x;
  const int key = piece_key[p];
  const int tl = key / a_pad;              // the tree within the launch
  const int t = t0 + tl;                   // ... and within the forest
  const long long first = piece_first[p];
  const int len = piece_len[p];
  const long long row_base = (long long)tl * n_rows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long dbc = (long long)d * n_bins * C;
  float* out = partial + p * dbc;
  const int n_fg = (d + kWarps - 1) / kWarps;
  const int n_cc = (C + kChunk - 1) / kChunk;
  const int n_slots = (n_bins + 31) / 32;

  for (int cc = 0; cc < n_cc; ++cc) {
    for (int fg = 0; fg < n_fg; ++fg) {
      const int f = fg * kWarps + warp;
      for (int sg = 0; sg < n_slots; sg += NS) {
        const int bin0 = sg * 32 + lane;   // slot s of this lane: bin0 + 32 s
        double acc[NS][kChunk];
#pragma unroll
        for (int s = 0; s < NS; ++s)
#pragma unroll
          for (int c = 0; c < kChunk; ++c) acc[s][c] = 0.0;
        for (int sub = 0; sub < len; sub += kSubRows) {
          const int m = min(kSubRows, len - sub);
          __syncthreads();                 // the last sub-chunk is read
          for (int i = threadIdx.x; i < m; i += kThreads)
            rows_s[i] = (int)(order[first + sub + i] - row_base);
          __syncthreads();
          for (int e = threadIdx.x; e < m * kWarps; e += kThreads) {
            const int i = e / kWarps, ff = fg * kWarps + e % kWarps;
            bins_s[e] = ff < d ? bins[(long long)rows_s[i] * d + ff] : -1;
          }
          for (int e = threadIdx.x; e < m * kChunk; e += kThreads) {
            const int i = e / kChunk, cg = cc * kChunk + e % kChunk;
            chf[e] = cg < C ? chans[((long long)rows_s[i] * T + t) * C + cg]
                            : 0.f;
          }
          __syncthreads();
          if (f < d) {
            for (int i0 = 0; i0 < m; i0 += kFlushRows) {
              float part[NS][kChunk];
#pragma unroll
              for (int s = 0; s < NS; ++s)
#pragma unroll
                for (int c = 0; c < kChunk; ++c) part[s][c] = 0.f;
              const int i1 = min(m, i0 + kFlushRows);
#pragma unroll 4
              for (int i = i0; i < i1; ++i) {  // sorted row order
                const int v = bins_s[i * kWarps + warp] - bin0;
                const float4 ch = ch_s[i];
#pragma unroll
                for (int s = 0; s < NS; ++s) {
                  if (v == 32 * s) {
                    part[s][0] += ch.x;
                    part[s][1] += ch.y;
                    part[s][2] += ch.z;
                    part[s][3] += ch.w;
                  }
                }
              }
#pragma unroll
              for (int s = 0; s < NS; ++s)
#pragma unroll
                for (int c = 0; c < kChunk; ++c) acc[s][c] += part[s][c];
            }
          }
        }
        if (f < d) {
#pragma unroll
          for (int s = 0; s < NS; ++s) {
            const int b = bin0 + 32 * s;
            if (b < n_bins) {
#pragma unroll
              for (int c = 0; c < kChunk; ++c) {
                const int cg = cc * kChunk + c;
                if (cg < C)
                  out[((long long)f * n_bins + b) * C + cg] = (float)acc[s][c];
              }
            }
          }
        }
      }
    }
  }
}

__global__ void tree_hist_reduce_kernel(const float* __restrict__ partial,
                                        const long long* __restrict__ key_piece,
                                        long long n_keys, long long dbc,
                                        float* __restrict__ out) {
  const long long total = n_keys * dbc;
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       e < total; e += (long long)gridDim.x * blockDim.x) {
    const long long key = e / dbc, r = e - key * dbc;
    double s = 0.0;
    for (long long q = key_piece[key]; q < key_piece[key + 1]; ++q)
      s += partial[q * dbc + r];           // pieces in piece order
    out[e] = (float)s;
  }
}

}  // namespace

// One level's histogram for trees t0 .. t0 + n_keys / a_pad - 1 of a
// forest of T: out[key][f][b][c] (key = tree within the launch x a_pad +
// node) over the rows of `order` (flat indices tree x n_rows + row), cut
// into n_pieces pieces (piece p: key piece_key[p], sorted positions
// piece_first[p] .. + piece_len[p]); key k's pieces are key_piece[k] ..
// key_piece[k + 1] - 1. `partial` holds n_pieces x d x n_bins x C floats.
extern "C" int tree_hist_launch(const int* bins, const float* chans,
                                const int* order, const int* piece_key,
                                const long long* piece_first,
                                const int* piece_len, long long n_pieces,
                                const long long* key_piece, long long n_keys,
                                long long n_rows, int d, int n_bins, int C,
                                int T, int t0, int a_pad, float* partial,
                                float* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_pieces > 0) {
    const int slots = (n_bins + 31) / 32;
    const dim3 grid(static_cast<unsigned>(n_pieces));
#define TREE_HIST_ARGS                                                    \
  bins, chans, order, piece_key, piece_first, piece_len, n_rows, d,      \
      n_bins, C, T, t0, a_pad, partial
    if (slots <= 1)
      tree_hist_piece_kernel<1><<<grid, kThreads, 0, s>>>(TREE_HIST_ARGS);
    else if (slots <= 2)
      tree_hist_piece_kernel<2><<<grid, kThreads, 0, s>>>(TREE_HIST_ARGS);
    else if (slots <= 4)
      tree_hist_piece_kernel<4><<<grid, kThreads, 0, s>>>(TREE_HIST_ARGS);
    else
      tree_hist_piece_kernel<8><<<grid, kThreads, 0, s>>>(TREE_HIST_ARGS);
#undef TREE_HIST_ARGS
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const long long dbc = (long long)d * n_bins * C;
  const long long total = n_keys * dbc;
  if (total > 0) {
    const long long want = (total + 255) / 256;
    const int blocks = static_cast<int>(want < 132 * 32 ? want : 132 * 32);
    tree_hist_reduce_kernel<<<blocks, 256, 0, s>>>(partial, key_piece,
                                                   n_keys, dbc, out);
  }
  return static_cast<int>(cudaGetLastError());
}
