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
// - tree_keys_kernel: the sort's keys, tree x a_pad + node of the (row,
//   tree) pairs in row-major order (no transpose), -1 for a row at
//   position -1 (settled, or out of the tree's sample);
// - the wrapper (ops/kernels.py tree_hist) sorts them stably (the center
//   sums' counting sort, or torch.sort past its keys): a (tree, node)
//   key's rows lie together in row order, `order` holding row x trees +
//   tree;
// - tree_segments_kernel, tree_scan_kernel, tree_table_kernel: the piece
//   table on the card (no host read). Past a level's first (one node a
//   tree) the rows are cut into windows of piece_rows x a_pad rows; each
//   key's sorted rows in each window (a binary search of the window's
//   bounds) into pieces of at most piece_rows, the pieces numbered window
//   by window, so that the CTAs in flight together read the rows of a few
//   windows, every tree's and node's of them, and the nodes' rows a
//   sector holds are read from memory about once. The grid is sized by a
//   bound on the pieces, and a CTA past the real count exits;
// - tree_rows_kernel (the lane-a-row instance): one CTA a (piece, feature
//   block), the block as many features as the shared memory holds (all 28
//   of HIGGS at maxBins 32 and 3 channels). The piece's rows are staged
//   256 at a time, each row's bins of the block and its C channels
//   gathered once by cp.async into a ring of two sub-chunks (the next one
//   in flight while the current one is summed, one barrier a sub-chunk),
//   each row's id read three sub-chunks before its copies are issued.
//   Warp w owns the features 2w
//   and 2w + 1; lane s = 16 h + l takes sorted rows l, l + 16, ... of
//   feature 2w + h and adds each row's channels into its own copy of the
//   feature's table: the pair's tables are laid out [bin][channel][32
//   slots], slot s lane s's, so lane s always hits bank s (no conflicts,
//   no atomics) and a feature's 16 copies take 64 bytes a cell. Every
//   block of 16 x kFlushRows sorted rows (a piece's rows 0-2047, 2048-
//   4095, ...) each lane's float partial of a cell holds at most
//   kFlushRows values; at the block's end the warp adds each cell's 16
//   lane partials of each feature into a double it keeps in shared memory
//   (lane s the cells s, s + 32, ...), four slots at a time in the order
//   of groups (cell + g) mod 8 for g = 0 .. 7, which keeps those 16-byte
//   reads conflict-free, and zeroes them. At the piece's end each cell's
//   double is rounded once to float into the piece's partial table (d, B,
//   C). Instances by the bins' width and C (3 and 4 exactly, else up to
//   16);
// - tree_bins_kernel (the lane-a-bin instance, the first design, for the
//   widths whose copies do not fit: C > 16, or B x C x 136 bytes of one
//   feature past the shared memory): one CTA of 8 warps a piece, a warp a
//   feature, lane l owning bins l, l + 32, ... (NS slots a pass), adding
//   row after row in sorted order the channels of every row whose bin is
//   its own, in float over blocks of kFlushRows rows, each block into a
//   double;
// - tree_hist_reduce_kernel: each output cell is the sum of its key's
//   pieces' partials in window order, and in a window in piece order, in
//   double, rounded once to float (0 for a key with no rows).
//
// A cell stays within (kFlushRows + 1) float roundings of its exact sum,
// relative to the sum of its values' magnitudes (7.7e-6 at most; a float
// partial's roundings plus one a piece and one a cell; the double sums add
// ~2^-53 each): a piece of bf16-valued features can put thousands of rows
// in one bin, and float sums of them in any order drift past 1e-5 on GBT's
// residual channels. The instance (tree_hist_plan) depends on B, C, d and
// the bins' width alone, so refits are bitwise equal; unit-weight counts
// and class sums are exact in either.
//
// What bounds it on the card: the bytes are the bins (one byte each for
// maxBins <= 256; int32 past it), the channels and the order, read once a
// (row, tree): 0.48 GB at HIGGS's shape a tree. This design is bound by
// neither but by shared memory: a (row, feature) costs its lane a byte
// read of its bin and, a channel, one read and one write of its table
// cell (~3C + 3 lane instructions, where the lane-a-bin design spent ~8
// warp instructions); a row C reads of its channels a half warp; a flush
// reads and zeroes a feature's 16 x B x C floats every 2,048 rows. At a
// level 0 (rows in order) the sums take the longer, at deep levels the
// gathers of rows scattered over the dataset (`tree_phases.py
// --variants` times each without the other).
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr int kSub = 256;                  // sorted rows staged at a time
constexpr int kFlushRows = 128;            // rows in a lane's float partial
constexpr int kBlockRows = 16 * kFlushRows;  // sorted rows of a flush block
constexpr int kMaxBlockFeat = 32;          // features a CTA, at most
constexpr int kMaxChan = 16;               // channels the lane-a-row takes
constexpr int kStages = 2;                 // sub-chunks in the ring
constexpr int kIdAhead = 2;                // sub-chunks of row ids ahead
constexpr int kBinWarps = 8;               // lane a bin: features a block
constexpr int kBinThreads = kBinWarps * 32;
constexpr int kBinSub = 512;               // lane a bin: rows staged
constexpr int kChunk = 4;                  // lane a bin: channels a pass

static_assert(kBlockRows % kSub == 0, "a flush block is whole sub-chunks");

// The sort's keys of one launch: keys[i x tg + j] = j x a_pad + pos[i x
// T + t0 + j] for the launch's trees j < tg (row-major, no transpose),
// -1 for a row out of tree j (pos < 0).
__global__ void tree_keys_kernel(const int* __restrict__ pos, int T, int t0,
                                 long long n, int tg, int a_pad,
                                 int* __restrict__ keys) {
  const int total = (int)(n * tg);         // < 2^31: the order's int32
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += gridDim.x * blockDim.x) {
    const int i = e / tg, j = e - i * tg;
    const int v = pos[(long long)i * T + t0 + j];
    keys[e] = v >= 0 ? j * a_pad + v : -1;
  }
}

// The pieces of one launch, in window-major order. Window w holds the
// rows w x W .. (w + 1) x W - 1 (W = piece_rows x a_pad; one window: all
// rows); segment i = w x
// n_keys + k is key k's sorted rows in window w (their `order` values
// row x tg + tree lie in [w W tg, (w + 1) W tg)), cut into pieces of at
// most piece_rows. seg holds 4 S + 1 int64 (S = n_windows x n_keys): each
// segment's first and end sorted positions and its pieces, then its
// first piece (piece_start, S + 1 of them).
__global__ void tree_segments_kernel(const int* __restrict__ order,
                                     const long long* __restrict__ offsets,
                                     long long n_keys, long long n_windows,
                                     long long window, int tg,
                                     long long piece_rows,
                                     long long* __restrict__ seg) {
  const long long S = n_windows * n_keys;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < S; i += (long long)gridDim.x * blockDim.x) {
    const long long w = i / n_keys, k = i - w * n_keys;
    long long bound[2] = {offsets[k], offsets[k + 1]};  // one window: all
    for (int e = 0; e < 2 && n_windows > 1; ++e) {
      const long long v = (w + e) * window * tg;  // the first value >= v
      long long lo = offsets[k], hi = offsets[k + 1];
      while (lo < hi) {
        const long long mid = (lo + hi) / 2;
        if (order[mid] < v)
          lo = mid + 1;
        else
          hi = mid;
      }
      bound[e] = lo;
    }
    seg[i] = bound[0];
    seg[S + i] = bound[1];
    seg[2 * S + i] = (bound[1] - bound[0] + piece_rows - 1) / piece_rows;
  }
}

// piece_start = the exclusive scan of the segments' pieces, S + 1 of them
// (one CTA of 1024 threads, each a run of segments, the runs' sums
// scanned in order).
__global__ void __launch_bounds__(1024)
tree_scan_kernel(long long S, long long* __restrict__ seg) {
  __shared__ long long run_sum[1024];
  const long long* cnt = seg + 2 * S;
  long long* start = seg + 3 * S;
  const long long per = (S + 1023) / 1024;
  const long long lo = threadIdx.x * per, hi = min(S, lo + per);
  long long s = 0;
  for (long long i = lo; i < hi; ++i) s += cnt[i];
  run_sum[threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    long long acc = 0;
    for (int j = 0; j < 1024; ++j) {
      const long long v = run_sum[j];
      run_sum[j] = acc;
      acc += v;
    }
    start[S] = acc;
  }
  __syncthreads();
  s = run_sum[threadIdx.x];
  for (long long i = lo; i < hi; ++i) {
    start[i] = s;
    s += cnt[i];
  }
}

// The piece table: table[p], table[P + p], table[2P + p] (P = max_pieces)
// are piece p's key, first sorted position and length (0 past the real
// pieces, whose key is n_keys).
__global__ void tree_table_kernel(const long long* __restrict__ seg,
                                  long long n_keys, long long n_windows,
                                  long long piece_rows, long long max_pieces,
                                  long long* __restrict__ table) {
  const long long S = n_windows * n_keys;
  const long long* start = seg + 3 * S;
  const long long n = start[S];
  for (long long p = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       p < max_pieces; p += (long long)gridDim.x * blockDim.x) {
    long long key = n_keys, first = 0, len = 0;
    if (p < n) {  // the last segment whose first piece is at most p
      long long lo = 0, hi = S - 1;
      while (lo < hi) {
        const long long mid = (lo + hi + 1) / 2;
        if (start[mid] <= p)
          lo = mid;
        else
          hi = mid - 1;
      }
      key = lo % n_keys;
      first = seg[lo] + (p - start[lo]) * piece_rows;
      len = min(seg[S + lo] - first, piece_rows);
    }
    table[p] = key;
    table[max_pieces + p] = first;
    table[2 * max_pieces + p] = len;
  }
}

// piece p's key, first sorted position and length; false past the real
// pieces (the grid is sized by a bound)
__device__ __forceinline__ bool piece_of(long long p,
                                         const long long* table,
                                         long long max_pieces, int* key,
                                         long long* first, int* len) {
  *len = (int)table[2 * max_pieces + p];
  *key = (int)table[p];
  *first = table[max_pieces + p];
  return *len > 0;
}

// A (piece, feature block): features f0 .. f0 + fb - 1. Shared memory:
// the tables, one [B][C][32] float region a pair of features (2p, 2p +
// 1): slot s of a cell is lane s's copy, of feature 2p for s < 16, of
// 2p + 1 past it; the doubles [fb][B][C]; then a ring of kStages
// sub-chunks of kSub rows' bins (sbw words a row: the words holding the
// block's features) and channels (cs floats a row; sbw and cs odd, so the
// rows a warp reads fall in distinct banks). Warp w owns the pair w;
// lane s of half h (s = 16 h + l) takes rows l, l + 16, ... of feature 2w
// + h. `order` holds row x tg + tree (tg trees in the launch).
template <typename BinT, int CM, bool kExact>
__global__ void __launch_bounds__(512)
tree_rows_kernel(const BinT* __restrict__ bins, long long ld,
                 const float* __restrict__ chans, long long ch_row,
                 long long ch_tree, const int* __restrict__ order,
                 const long long* __restrict__ table, long long max_pieces,
                 int d, int n_bins, int C, int t0, int tg, int a_pad,
                 int fb, int sbw, int cs, float* __restrict__ partial) {
  extern __shared__ __align__(16) unsigned char smem[];
  int key, len;
  long long first;
  // a piece's feature blocks are neighbours in the grid, so the rows the
  // first gathers are still in L2 for the next
  const int n_fb = (d + fb - 1) / fb;
  const long long p = blockIdx.x / n_fb;
  if (!piece_of(p, table, max_pieces, &key, &first, &len)) return;
  const int f0 = (int)(blockIdx.x % n_fb) * fb;
  const int nf = min(fb, d - f0);          // this block's features
  const int bc = n_bins * C;
  const int tl = key / a_pad;              // the tree within the launch
  const int t = t0 + tl;                   // ... and within the forest
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int half = lane >> 4, hl = lane & 15;
  const int n_pairs = (fb + 1) / 2;

  float* tbl = reinterpret_cast<float*>(smem);
  double* acc = reinterpret_cast<double*>(tbl + (size_t)n_pairs * bc * 32);
  uint32_t* sb = reinterpret_cast<uint32_t*>(acc + (size_t)fb * bc);
  float* sc = reinterpret_cast<float*>(sb + kStages * kSub * sbw);
  for (int e = threadIdx.x; e < n_pairs * bc * 32; e += blockDim.x)
    tbl[e] = 0.f;
  for (int e = threadIdx.x; e < fb * bc; e += blockDim.x) acc[e] = 0.0;

  // the words of a row that hold the block's features: for one-byte bins
  // from the word of feature f0 (rows start on 4-byte boundaries), the
  // block's first bin at byte f0 % 4 of the staged row
  constexpr bool kByte = sizeof(BinT) == 1;
  const int head = kByte ? (f0 & 3) : 0;
  const int nw = kByte ? (head + nf + 3) / 4 : nf;
  const long long wofs = kByte ? (f0 & ~3) : f0;  // elements to that word

  const int n_sub = (len + kSub - 1) / kSub;
  const int tr = threadIdx.x;              // the row a thread stages
  auto row_id = [&](int sub) -> int {
    const int i = sub * kSub + tr;
    return (tr < kSub && sub < n_sub && i < len)
               ? (order[first + i] - tl) / tg
               : -1;
  };
  auto stage = [&](int sub, int row) {
    if (row < 0) return;
    const int slot = sub % kStages;
    const BinT* src = bins + row * ld + wofs;
    const uint32_t db = hopper::smem_u32(sb + (slot * kSub + tr) * sbw);
    for (int j = 0; j < nw; ++j)
      hopper::cp_async4(db + 4 * j, reinterpret_cast<const uint32_t*>(src) + j,
                        4);
    const float* cr = chans + row * ch_row + t * ch_tree;
    const uint32_t dc = hopper::smem_u32(sc + (slot * kSub + tr) * cs);
    for (int c = 0; c < C; ++c) hopper::cp_async4(dc + 4 * c, cr + c, 4);
  };

  // the ring: sub-chunks 0 .. kStages - 2 issued first, then sub-chunk
  // k + kStages - 1 while k is summed (one barrier a sub-chunk); rq[j]
  // holds sub-chunk k + j's row id, read kIdAhead + 1 sub-chunks before
  // its copies are issued
  constexpr int kIds = kIdAhead + kStages;
  int rq[kIds];                            // all read before any copy
#pragma unroll
  for (int j = 0; j < kIds; ++j) rq[j] = row_id(j);
#pragma unroll
  for (int k = 0; k + 1 < kStages; ++k) {
    stage(k, rq[k]);
    hopper::cp_async_commit();
  }
  const int nc = kExact ? CM : C;          // channels (a constant if exact)
  const int fa = 2 * warp;                 // the warp's pair: fa, fa + 1
  const int f = fa + half;                 // this lane's feature
  const bool own = f < nf;
  float* const tab = tbl + (size_t)warp * bc * 32 + lane;  // its copy
  for (int k = 0; k < n_sub; ++k) {
    hopper::cp_async_wait<kStages - 2>();
    __syncthreads();                       // sub-chunk k staged, k - 1 read
    stage(k + kStages - 1, rq[kStages - 1]);  // into k - 1's slot
    hopper::cp_async_commit();
#pragma unroll
    for (int j = 0; j + 1 < kIds; ++j) rq[j] = rq[j + 1];
    rq[kIds - 1] = row_id(k + kIds);       // in flight while k is summed
    const int slot = k % kStages;
    const int m = min(kSub, len - k * kSub);
    if (fa < nf) {
      // half h, lane l: rows l, l + 16, ... of the sub-chunk, a row's bin
      // and channels read before the last row's writes; a whole sub-chunk
      // takes the unrolled loop
      const unsigned char* bp = reinterpret_cast<const unsigned char*>(
          sb + slot * kSub * sbw) + hl * sbw * 4 + head + f;
      const int* bw = reinterpret_cast<const int*>(sb + slot * kSub * sbw) +
                      hl * sbw + f;
      const float* cp = sc + slot * kSub * cs + hl * cs;
      auto sum_rows = [&](auto whole) {
        constexpr bool kWhole = decltype(whole)::value;
        constexpr int kUnroll = kWhole ? kSub / 16 : 1;
        const int steps = kWhole ? kSub / 16 : (m + 15) / 16;
        int b;
        float ch[CM];
        auto load = [&](int s) {
          b = kByte ? (int)bp[s * 16 * sbw * 4] : bw[s * 16 * sbw];
#pragma unroll
          for (int c = 0; c < CM; ++c)
            ch[c] = c < nc ? cp[s * 16 * cs + c] : 0.f;
        };
        load(0);
#pragma unroll kUnroll
        for (int s = 0; s < steps; ++s) {
          const bool ok = (kWhole || s * 16 + hl < m) && own &&
                          (unsigned)b < (unsigned)n_bins;
          float* cell = tab + (ok ? b : 0) * (nc * 32);
          float v[CM], x[CM];
#pragma unroll
          for (int c = 0; c < CM; ++c) {
            x[c] = ch[c];
            if (ok && c < nc) v[c] = cell[c * 32];
          }
          if (s + 1 < steps) load(s + 1);  // the next row's, ahead
#pragma unroll
          for (int c = 0; c < CM; ++c)
            if (ok && c < nc) cell[c * 32] = v[c] + x[c];
        }
      };
      if (m == kSub)
        sum_rows(std::true_type());
      else
        sum_rows(std::false_type());
      if ((k + 1) % (kBlockRows / kSub) == 0 || k + 1 == n_sub) {
        // the block's end: each cell's 16 lane partials of each feature
        // into its double and zeroed, four slots at a time: groups q = (g
        // + e) mod 8 for g = 0 .. 7 (slots 4q .. 4q + 3 in order; groups 0-3
        // the first feature's, 4-7 the second's), so that the 16-byte
        // reads of a warp's 32 cells fall in distinct banks
        __syncwarp();                      // every lane's adds are seen
        double* acc_a = acc + (size_t)fa * bc;
        double* acc_b = acc_a + bc;
        const bool has_b = fa + 1 < nf;
        const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int e = lane; e < bc; e += 32) {
          float4* lp = reinterpret_cast<float4*>(
              tbl + ((size_t)warp * bc + e) * 32);
          double sa = acc_a[e], sb2 = has_b ? acc_b[e] : 0.0;
#pragma unroll
          for (int g = 0; g < 8; ++g) {
            const int q = (g + lane) & 7;
            const float4 v = lp[q];
            lp[q] = zero;
            double t = q < 4 ? sa : sb2;
            t += (double)v.x;
            t += (double)v.y;
            t += (double)v.z;
            t += (double)v.w;
            if (q < 4)
              sa = t;
            else
              sb2 = t;
          }
          acc_a[e] = sa;
          if (has_b) acc_b[e] = sb2;
        }
      }
    }
  }
  for (int h = 0; h < 2; ++h) {
    const int g = fa + h;
    if (g >= nf) break;
    float* out = partial + p * (long long)d * bc + (long long)(f0 + g) * bc;
    for (int e = lane; e < bc; e += 32) out[e] = (float)acc[g * bc + e];
  }
}

// The first design (lane a bin), kept for the widths the lane-a-row
// instance cannot hold.
template <typename BinT, int NS>
__global__ void __launch_bounds__(kBinThreads)
tree_bins_kernel(const BinT* __restrict__ bins, long long ld,
                 const float* __restrict__ chans, long long ch_row,
                 long long ch_tree, const int* __restrict__ order,
                 const long long* __restrict__ table, long long max_pieces,
                 int d, int n_bins, int C, int t0, int tg, int a_pad,
                 float* __restrict__ partial) {
  __shared__ int rows_s[kBinSub];
  __shared__ int bins_s[kBinSub * kBinWarps];
  __shared__ float4 ch_s[kBinSub];
  float* chf = reinterpret_cast<float*>(ch_s);

  int key, len;
  long long first;
  const long long p = blockIdx.x;
  if (!piece_of(p, table, max_pieces, &key, &first, &len)) return;
  const int tl = key / a_pad;
  const int t = t0 + tl;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long dbc = (long long)d * n_bins * C;
  float* out = partial + p * dbc;
  const int n_fg = (d + kBinWarps - 1) / kBinWarps;
  const int n_cc = (C + kChunk - 1) / kChunk;
  const int n_slots = (n_bins + 31) / 32;

  for (int cc = 0; cc < n_cc; ++cc) {
    for (int fg = 0; fg < n_fg; ++fg) {
      const int f = fg * kBinWarps + warp;
      for (int sg = 0; sg < n_slots; sg += NS) {
        const int bin0 = sg * 32 + lane;   // slot s of this lane: bin0 + 32 s
        double acc[NS][kChunk];
#pragma unroll
        for (int s = 0; s < NS; ++s)
#pragma unroll
          for (int c = 0; c < kChunk; ++c) acc[s][c] = 0.0;
        for (int sub = 0; sub < len; sub += kBinSub) {
          const int m = min(kBinSub, len - sub);
          __syncthreads();                 // the last sub-chunk is read
          for (int i = threadIdx.x; i < m; i += kBinThreads)
            rows_s[i] = (order[first + sub + i] - tl) / tg;
          __syncthreads();
          for (int e = threadIdx.x; e < m * kBinWarps; e += kBinThreads) {
            const int i = e / kBinWarps, ff = fg * kBinWarps + e % kBinWarps;
            bins_s[e] = ff < d ? (int)bins[rows_s[i] * ld + ff] : -1;
          }
          for (int e = threadIdx.x; e < m * kChunk; e += kBinThreads) {
            const int i = e / kChunk, cg = cc * kChunk + e % kChunk;
            chf[e] = cg < C ? chans[rows_s[i] * ch_row + t * ch_tree + cg]
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
                const int v = bins_s[i * kBinWarps + warp] - bin0;
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
                                        const long long* __restrict__ seg,
                                        long long n_keys, long long n_windows,
                                        long long dbc,
                                        float* __restrict__ out) {
  const long long S = n_windows * n_keys;
  const long long* start = seg + 3 * S;
  const long long total = n_keys * dbc;
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       e < total; e += (long long)gridDim.x * blockDim.x) {
    const long long key = e / dbc, r = e - key * dbc;
    double s = 0.0;
    for (long long w = 0; w < n_windows; ++w) {  // pieces in window order
      const long long i = w * n_keys + key;
      for (long long q = start[i]; q < start[i + 1]; ++q)
        s += partial[q * dbc + r];
    }
    out[e] = (float)s;
  }
}

// the plan of a launch (tree_hist_plan's fields)
struct Plan {
  int rows;      // 1: the lane-a-row instance, 0: the lane-a-bin one
  int fb;        // features a CTA (lane a row; 8 for lane a bin)
  int n_fb;      // feature blocks (the grid's y)
  int threads;
  int smem;      // dynamic shared memory in bytes (lane a row)
  int sbw, cs;   // staged words a row of bins, floats a row of channels
  int variant;   // channels held (lane a row: 4 or 16) or NS (lane a bin)
};

constexpr int kMaxDevices = 64;

int max_smem(int* out) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  static int cached[kMaxDevices] = {0};
  if (dev < kMaxDevices && cached[dev]) {
    *out = cached[dev];
    return 0;
  }
  int v = 0;
  e = cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < kMaxDevices) cached[dev] = v;
  *out = v;
  return 0;
}

long long rows_smem(int fb, long long bc, int sbw, int cs) {
  return (long long)(fb + 1) / 2 * bc * 32 * 4 + (long long)fb * bc * 8 +
         (long long)kStages * kSub * (sbw + cs) * 4;
}

// The rule: the lane-a-row instance where C <= 16 and one feature's lane
// copies and doubles (B x C x 136 bytes) fit the shared memory with the
// staging ring; its CTA takes as many features as fit (at most 32), the
// features split evenly over the blocks. Otherwise the lane-a-bin one.
int make_plan(int n_bins, int C, int d, int bin_bytes, Plan* pl) {
  int limit = 0;
  const int e = max_smem(&limit);
  if (e) return e;
  const long long bc = (long long)n_bins * C;
  const int cs = C | 1;
  auto words = [&](int fb) {
    const int w = bin_bytes == 1 ? (3 + fb + 3) / 4 : fb;
    return w | 1;
  };
  int fb = 0;
  if (C <= kMaxChan) {
    for (int f = min(d, kMaxBlockFeat); f >= 1; --f)
      if (rows_smem(f, bc, words(f), cs) <= limit) {
        fb = f;
        break;
      }
  }
  if (fb > 0) {
    const int n_fb = (d + fb - 1) / fb;
    fb = (d + n_fb - 1) / n_fb;
    const int warps = (fb + 1) / 2;
    pl->rows = 1;
    pl->fb = fb;
    pl->n_fb = n_fb;
    pl->threads = 32 * max(warps, kSub / 32);
    pl->sbw = words(fb);
    pl->cs = cs;
    pl->smem = static_cast<int>(rows_smem(fb, bc, pl->sbw, cs));
    pl->variant = C == 3 || C == 4 ? C : kMaxChan;
  } else {
    const int slots = (n_bins + 31) / 32;
    pl->rows = 0;
    pl->fb = kBinWarps;
    pl->n_fb = 1;
    pl->threads = kBinThreads;
    pl->smem = 0;
    pl->sbw = pl->cs = 0;
    pl->variant = slots <= 1 ? 1 : slots <= 2 ? 2 : slots <= 4 ? 4 : 8;
  }
  return 0;
}

template <typename K>
int set_smem(K kernel, int bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

// one launch of the plan's piece kernel; with ctas_per_sm, its occupancy
// instead
template <typename BinT>
int launch_pieces(const Plan& pl, const BinT* bins, long long ld,
                  const float* chans, long long ch_row, long long ch_tree,
                  const int* order, const long long* table,
                  long long max_pieces, int d, int n_bins, int C, int t0,
                  int tg, int a_pad, float* partial, cudaStream_t s,
                  int* ctas_per_sm) {
#define TREE_PIECE_ARGS                                                   \
  bins, ld, chans, ch_row, ch_tree, order, table, max_pieces, d, n_bins, C, \
      t0, tg, a_pad
  if (pl.rows) {
    auto kernel = pl.variant == 3   ? tree_rows_kernel<BinT, 3, true>
                  : pl.variant == 4 ? tree_rows_kernel<BinT, 4, true>
                                    : tree_rows_kernel<BinT, kMaxChan, false>;
    int e = set_smem(kernel, pl.smem);
    if (e) return e;
    if (ctas_per_sm)
      return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          ctas_per_sm, kernel, pl.threads, pl.smem));
    const unsigned grid = static_cast<unsigned>(max_pieces * pl.n_fb);
    kernel<<<grid, pl.threads, pl.smem, s>>>(TREE_PIECE_ARGS, pl.fb, pl.sbw,
                                             pl.cs, partial);
  } else {
    auto kernel = pl.variant == 1   ? tree_bins_kernel<BinT, 1>
                  : pl.variant == 2 ? tree_bins_kernel<BinT, 2>
                  : pl.variant == 4 ? tree_bins_kernel<BinT, 4>
                                    : tree_bins_kernel<BinT, 8>;
    if (ctas_per_sm)
      return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          ctas_per_sm, kernel, pl.threads, 0));
    kernel<<<static_cast<unsigned>(max_pieces), kBinThreads, 0, s>>>(
        TREE_PIECE_ARGS, partial);
  }
#undef TREE_PIECE_ARGS
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The instance a launch takes for n_bins bins, C channels and d features
// with bins of bin_bytes (1 or 4): plan[0] 1 for the lane-a-row instance,
// 0 for the lane-a-bin one; [1] features a CTA; [2] feature blocks; [3]
// threads a CTA; [4] dynamic shared memory in bytes; [5] CTAs resident on
// one SM; [6] channels held (lane a row) or bins a lane a pass (lane a
// bin).
extern "C" int tree_hist_plan(int n_bins, int C, int d, int bin_bytes,
                              int* plan) {
  if (bin_bytes != 1 && bin_bytes != 4) return cudaErrorInvalidValue;
  Plan pl;
  int e = make_plan(n_bins, C, d, bin_bytes, &pl);
  if (e) return e;
  int ctas = 0;
  e = bin_bytes == 1
          ? launch_pieces<unsigned char>(pl, nullptr, 0, nullptr, 0, 0,
                                         nullptr, nullptr, 0, d, n_bins, C, 0,
                                         1, 1, nullptr, nullptr, &ctas)
          : launch_pieces<int>(pl, nullptr, 0, nullptr, 0, 0, nullptr,
                               nullptr, 0, d, n_bins, C, 0, 1, 1, nullptr,
                               nullptr, &ctas);
  if (e) return e;
  const int out[7] = {pl.rows, pl.fb,   pl.n_fb,     pl.threads,
                      pl.smem, ctas,    pl.variant};
  for (int i = 0; i < 7; ++i) plan[i] = out[i];
  return 0;
}

// The keys tree_order sorts for trees t0 .. t0 + tg - 1 of pos (n, T)
// int32: keys (n x tg) int32, row-major.
extern "C" int tree_keys_launch(const int* pos, int T, int t0, long long n,
                                int tg, int a_pad, int* keys, void* stream) {
  const long long total = n * tg;
  if (total > 0) {
    const long long want = (total + 255) / 256;
    const int blocks = static_cast<int>(want < 132 * 16 ? want : 132 * 16);
    tree_keys_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
        pos, T, t0, n, tg, a_pad, keys);
  }
  return static_cast<int>(cudaGetLastError());
}

// One level's histogram for trees t0 .. t0 + tg - 1 of a forest (tg =
// n_keys / a_pad; the channels of row i and tree t at chans + i x ch_row
// + t x ch_tree, C floats): out[key][f][b][c] (key = tree within the
// launch x a_pad + node) over the rows of `order` (row x tg + tree within
// the launch), sorted stably by key, key k's at offsets[k] .. offsets[k +
// 1] - 1; the pieces (of at most piece_rows sorted rows) of each key in
// each of n_windows windows of piece_rows x a_pad rows, at most
// max_pieces in all. `bins` (rows, d) of bin_bytes (1: uint8, rows of ld
// bytes with ld a multiple of 4 and a 4-byte aligned base; 4: int32, rows
// of ld elements). Scratch: `seg` 4 x n_windows x n_keys + 1 int64,
// `table` 3 x max_pieces int64, `partial` max_pieces x d x n_bins x C
// floats. `stages`: bit 1 the segments and the piece table, bit 2 the
// pieces, bit 4 the reduce (7 for a level).
extern "C" int tree_hist_launch(const void* bins, int bin_bytes, long long ld,
                                const float* chans, long long ch_row,
                                long long ch_tree, const int* order,
                                const long long* offsets, long long n_keys,
                                long long piece_rows, long long n_windows,
                                long long max_pieces, int d, int n_bins,
                                int C, int t0, int a_pad, long long* seg,
                                long long* table, float* partial, float* out,
                                int stages, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bin_bytes != 1 && bin_bytes != 4) return cudaErrorInvalidValue;
  const int tg = static_cast<int>(n_keys / a_pad);
  const long long S = n_windows * n_keys;
  if ((stages & 1) && S > 0) {
    const long long want = (S + 255) / 256;
    int blocks = static_cast<int>(want < 132 * 8 ? want : 132 * 8);
    tree_segments_kernel<<<blocks, 256, 0, s>>>(order, offsets, n_keys,
                                                n_windows,
                                                piece_rows * a_pad, tg,
                                                piece_rows, seg);
    tree_scan_kernel<<<1, 1024, 0, s>>>(S, seg);
    const long long want_p = (max_pieces + 255) / 256;
    blocks = static_cast<int>(want_p < 132 * 8 ? want_p : 132 * 8);
    if (max_pieces > 0)
      tree_table_kernel<<<blocks, 256, 0, s>>>(seg, n_keys, n_windows,
                                               piece_rows, max_pieces, table);
  }
  if ((stages & 2) && max_pieces > 0) {
    Plan pl;
    int e = make_plan(n_bins, C, d, bin_bytes, &pl);
    if (e) return e;
    e = bin_bytes == 1
            ? launch_pieces(pl, static_cast<const unsigned char*>(bins), ld,
                            chans, ch_row, ch_tree, order, table, max_pieces,
                            d, n_bins, C, t0, tg, a_pad, partial, s, nullptr)
            : launch_pieces(pl, static_cast<const int*>(bins), ld, chans,
                            ch_row, ch_tree, order, table, max_pieces, d,
                            n_bins, C, t0, tg, a_pad, partial, s, nullptr);
    if (e) return e;
  }
  const long long dbc = (long long)d * n_bins * C;
  const long long total = n_keys * dbc;
  if ((stages & 4) && total > 0) {
    const long long want = (total + 255) / 256;
    const int blocks = static_cast<int>(want < 132 * 32 ? want : 132 * 32);
    tree_hist_reduce_kernel<<<blocks, 256, 0, s>>>(partial, seg, n_keys,
                                                   n_windows, dbc, out);
  }
  return static_cast<int>(cudaGetLastError());
}
