// GLM row sweep for Hopper (sm_90a): one pass over X computing a GLM
// loss, its gradient, sum(mult) and sum(w), for two links.
//
// Replaces cycloneml_tpu/ops/kernels.py:_run_glm, the Pallas kernel behind
// fused_binary_logistic_scaled (kind="logistic", K1) and
// fused_least_squares_scaled (kind="squared", K2). Per row r:
//   margin = x_r . beta + off
//   logistic: mult = w_r (sigmoid(margin) - y_r)
//             loss += w_r (softplus(margin) - y_r margin)
//   squared:  err = margin - ys y_r; mult = w_r err
//             loss += 0.5 w_r err^2
//   grad  += mult x_r
//   aux   += [mult, w_r]
// The wrapper folds standardization around it (beta = inv_std o coef,
// off = b0 - mu_hat . coef for the logistic link, off = y_mean_hat -
// mu_hat . coef and ys = 1/sigma_y for the squared one), so X is read raw
// at its storage width, float32, bfloat16 or float8_e4m3fn codes. The fp8
// rung's per-column scale (the reference's x_scale, kernels.py:309) is
// folded by the wrapper into the (d,) vectors: x . (beta o s) and
// sum(mult x) o s, so it costs no work per element here.
//
// Bound: bytes. One sweep must read X once (n*d bytes in e4m3, 2*n*d in
// bf16, 4*n*d in f32) plus y and w. At n=2M, d=1280 (LogisticRegression)
// that is 0.77, 1.53 or 3.06 ms at 3.35 TB/s; at n=400k, d=2000 (K2 at
// the LinearRegression configuration) 0.24 or 0.48 ms in e4m3 or bf16.
// The arithmetic is a few operations an element: little beside the bytes,
// but not nothing (below).
//
// Design. One warp owns one row at a time (grid-stride over rows); lane l
// holds the slots l, l + 32, ... of a row, a slot being one 16-byte copy
// (4 f32 or 8 bf16) or one 8-byte copy (8 e4m3 codes), so a lane holds the
// same E = 8 * ceil(d / 256) elements in every dtype and d <= 32 * 64.
//
// - The ring. Each warp owns S stages of one row in dynamic shared memory.
//   Each lane copies its own slots of the warp's next rows into them with
//   cp.async (16 bytes .cg, or 8 bytes .ca for e4m3; hopper.cuh), lanes 0
//   and 1 the row's y and w (4 bytes each), one commit group per row.
//   Before a block of R rows the lane waits with cp.async.wait_group<S-R>
//   and reads back only the X bytes it copied itself, so X needs no
//   barrier (y and w need one __syncwarp). S * sizeof(T) = 8 in every
//   dtype, S = 2, 4, 8 rows for f32, bf16, e4m3 and R = S/2: while a warp
//   computes one block the next is in flight, and a warp's ring is
//   8 * 32E bytes, 80 KB a CTA of 8 warps at d = 1280 and 128 KB at
//   d = 2000: 40 to 128 KB in flight on an SM. Rows past n and columns
//   past d are zero-filled copies that read nothing (w = 0 makes a dead
//   row inert).
// - The block order, the reference's. _run_glm sums a row tile in plain
//   f32 (jnp.sum(mult * xv, axis=0), kernels.py:329) and compensates only
//   across tiles (:330-343), which its comment says keeps the device
//   L-BFGS's Wolfe search at 10 evaluations instead of 46. Here a tile is
//   a warp's block of R rows: the R margins reduce with interleaved xor
//   shuffles (every lane ends with the bitwise-same margins); lane j
//   evaluates row j's link and the multipliers go to every lane by
//   shuffles; each element's block sum sum_r mult_r x_r[e] is taken in
//   plain f32 (fmaf over r, X re-read from the ring and unpacked again)
//   and added to the lane's Kahan pair in one step; the loss, sum(mult)
//   and sum(w) are summed the same way, in row order. The gradient costs
//   1 + 4/R operations an element-row where a Kahan step a row took 5;
//   f32 (R = 1) keeps the per-row order. Each CTA then folds its warps,
//   in warp order, in double, and writes one partial row [grad(d), loss,
//   sum(mult), sum(w)] of doubles; a second kernel sums those rows column
//   by column in CTA order, in double, and rounds once to f32. No
//   atomics: two launches on the same inputs are bitwise equal. sum(w) is
//   exact for n < 2^24 unit weights.
// - The register budget. No copy of a row is kept in registers: a lane
//   holds its Kahan sums, one slot of each of the block's rows while it
//   sums them, and the R margins and multipliers. The margins walk the
//   slots in a loop that is not unrolled (unrolled, ptxas hoisted every
//   slot's loads and spilled at E = 64), and each slot's block sums are
//   unrolled, since they index the sums. Up to E = 40 the Kahan pairs are
//   registers (190-204 of them at E = 40); past it the compensations live
//   in shared memory (E floats a thread, 64 KB a CTA at E = 64), read and
//   written once a block, 16 bytes at a time, and the sums stay in
//   registers (158-167 at E = 64). Every instance has 0 bytes of spill
//   (chip_smoke.py prints ptxas's lines; a gpu test holds it) and runs one
//   CTA of 8 warps an SM: held to 128 registers for two CTAs, the E = 40
//   instances spilled ~1 KB and ran 30-50% slower.
// - Unaligned rows. A slot is copied by cp.async when the row start is
//   slot-aligned (d * sizeof(T) % slot == 0 and an aligned base, vec_ok);
//   otherwise each lane loads its slots element by element, one slot at a
//   time, and stores them into its own ring slots, and the ring runs as
//   before (the copy waits for its loads: slower, and only off the main
//   paths).
//
// What holds each instance back (glm_phases.py: one build per phase taken
// out, timed at the fits' shapes; the numbers are in PERF.md): the f32
// and bf16 instances of K1 run within a tenth of their bytes bound. e4m3
// is bound by its instructions, not its bytes: taking the copies out
// saves nothing, taking out the margins or the gradient, each of which
// converts every code again, saves a fifth of K1's time each. K2 (400k x
// 2000, 379 rows a warp) loses its last fifth (bf16) to no single phase.
//
// The wide instance (2048 < d <= 12288), one read of X. A lane cannot hold
// a row of E > 64 elements with its sums, so past 2048 columns a row's
// slots are spread over a whole CTA: 16 warps, one CTA an SM (persistent,
// tiles blockIdx.x, + gridDim.x, ...), thread t holding slots t, t + 512,
// ... of every row (E = 8 elements a row up to d = 4096, 16 up to 8192,
// 24 up to 12288), with its E Kahan pairs and coefficients in registers.
// - Staging. A tile is G consecutive rows (4 bf16 and e4m3, 2 or 1 f32;
//   a multiple of R), a ring of S tiles (6 to 8, about 128 KB in flight an
//   SM). Each thread copies its own slots of a tile's rows by cp.async
//   into its own ring slots (16 or 8 bytes, zero-filled past n and d), so
//   no barrier stands between a copy and its reads; lane 0 of warp i
//   copies row i's y and w. X is read from device memory once.
// - Margins. Each thread's partial dot products of the tile's G rows, then
//   a warp's G sums by xor shuffles that halve the values a lane keeps at
//   each level (G - 1 + 5 - log2 G shuffles), then the 16 warps' partials
//   summed in warp order by lane 0 of warp i, which evaluates row i's link
//   (link_eval, as the narrow instance) and publishes its multiplier,
//   loss and weight.
// - Gradient, from the same ring slots: each element's block of R rows in
//   plain f32 (fmaf over the rows) and one Kahan step, the reference's
//   tile order as in the narrow instance; thread 0 sums the loss,
//   sum(mult) and sum(w) in the same blocks, in row order. No block past
//   the last row.
// - One barrier a tile: iteration j evaluates tile j's links, takes tile j
//   + 1's partial margins, syncs, then sums tile j's gradient and refills
//   its stage with tile j + S (the partial margins and multipliers are
//   double-buffered by tile parity).
// - Each column is one thread's, so the CTA writes its partial row of
//   (d + 3) doubles without a fold; glm_reduce_kernel sums the rows in CTA
//   order. Two launches are bitwise equal. No multiplier scratch: scratch
//   does not grow with n. Registers: 78-128 a thread, 0 spills. E = 24
//   is the widest: a 512-thread CTA leaves a thread 128 registers, and at
//   E = 32 its coefficients and Kahan pairs alone take 96 of them (ptxas
//   spills there in every dtype; E = 24 takes 120-128 with none).
// - What holds it back (glm_phases.py --wide; PERF.md section 6): bf16 and
//   f32 run at about 90% of the bytes bound, and no single phase taken out
//   saves time (the copies neither: the tile's chain of barrier, link and
//   arithmetic is as long as its bytes); e4m3 is bound by converting every
//   code twice (margins and gradient), as the narrow instance is.
//
// The two-pass instance (d > 12288). Past 12288 columns a thread's slots
// of a row no longer fit its registers, so the sweep runs as two passes
// over X:
// - the margin pass (glm_wide_margin_kernel): a warp takes G = 4
//   consecutive rows at a time, its lanes walking their slots of the four
//   rows with the four margins' chains interleaved (the narrow instance's
//   products and xor shuffles, beta read from a copy zero-padded to 8
//   columns), lane j evaluates row j's link and writes its multiplier to
//   an (n,) f32 scratch; loss, sum(mult) and sum(w) go in blocks of R rows
//   in plain f32 and Kahan across blocks, then the warps fold in warp
//   order in double into the CTA's partial row (its last three columns);
// - the gradient pass (glm_wide_grad_kernel): a grid of (column block,
//   row slab); thread t owns one slot (4 f32 or 8 bf16/e4m3 columns) of
//   the block and walks the slab's rows in order, G rows' slots in flight,
//   each block of R rows summed in plain f32 (fmaf over the rows) and added
//   to its Kahan pair, the same block order as the narrow instance; slab s
//   writes its sums in double into columns 0..d-1 of partial row s;
// - the reduction sums the partial rows in order in double, as above.
//   Two launches are bitwise equal; rows past n and columns past d read
//   nothing; unaligned rows load element by element.
// It reads X twice and keeps n floats of multipliers in scratch, plus
// partial rows of (d + 3) doubles, up to four per SM. Its registers hold
// no row, so it takes any d (glm_sweep_two_pass_launch takes it at any d
// past 2048, for a comparison in one run).

// Plain C interface (loaded with ctypes): every entry point returns a
// cudaError_t, 0 on success.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "hopper.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxE = 64;        // elements of a row one lane holds, at most
constexpr int kMaxDevices = 64;  // devices whose attributes are remembered

enum Link { kLogistic = 0, kSquared = 1 };

// One slot: V elements in W 32-bit words, copied as one piece.
template <typename T>
struct Slot;
template <>
struct Slot<float> {
  static constexpr int V = 4, W = 4;
};
template <>
struct Slot<__nv_bfloat16> {
  static constexpr int V = 8, W = 4;
};
template <>
struct Slot<__nv_fp8_e4m3> {
  static constexpr int V = 8, W = 2;  // the same 8 elements as a bf16 slot
};

// The shape of one instance: S ring stages of one row for each warp,
// taken R rows (a block) at a time; S * sizeof(T) = 8 in every dtype.
template <typename T, int E>
struct Plan {
  static constexpr int S = 8 / (int)sizeof(T);  // 2 f32, 4 bf16, 8 e4m3
  static constexpr int R = S / 2;               // 1, 2, 4
  static constexpr int kWidth = 32 * E;         // padded row width
  static constexpr int kRowBytes = kWidth * (int)sizeof(T);
  static constexpr int kRingBytes = kWarps * S * kRowBytes;
  // past E = 40 the Kahan pairs' compensations live in shared memory (E
  // floats a thread): 2E registers of pairs leave too few for the rest
  // at 255
  static constexpr bool kCompShared = E > 40;
  static constexpr int kCompBytes = kCompShared ? E * 4 * kThreads : 0;
  // beta, the X stages, the y and w stages, the compensations
  static constexpr int kSmem =
      kWidth * 4 + kRingBytes + kWarps * S * 8 + kCompBytes;
  static_assert(kRingBytes >= (kWidth + 3) * 8,
                "the fold's doubles must fit in the drained ring");
};

// A lane's slot, W words, from its ring stage.
template <int W>
__device__ __forceinline__ void ld_slot(const uint8_t* p, uint32_t (&u)[W]) {
  if constexpr (W == 4) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    u[0] = v.x;
    u[1] = v.y;
    u[2] = v.z;
    u[3] = v.w;
  } else {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    u[0] = v.x;
    u[1] = v.y;
  }
}

// Elements 2h and 2h + 1 of a slot as f32 (a bf16 is the top half of an
// f32; e4m3 pairs go through the hardware conversion to an f16 pair,
// exact, then to f32).
template <typename T, int W>
__device__ __forceinline__ float2 pair(const uint32_t (&u)[W], int h);

template <>
__device__ __forceinline__ float2 pair<float, 4>(const uint32_t (&u)[4],
                                                 int h) {
  return make_float2(__uint_as_float(u[2 * h]), __uint_as_float(u[2 * h + 1]));
}

template <>
__device__ __forceinline__ float2 pair<__nv_bfloat16, 4>(
    const uint32_t (&u)[4], int h) {
  return make_float2(__uint_as_float(u[h] << 16),
                     __uint_as_float(u[h] & 0xffff0000u));
}

template <>
__device__ __forceinline__ float2 pair<__nv_fp8_e4m3, 2>(
    const uint32_t (&u)[2], int h) {
  const __nv_fp8x2_storage_t two =
      (__nv_fp8x2_storage_t)((u[h >> 1] >> (16 * (h & 1))) & 0xffffu);
  return __half22float2(__half2(__nv_cvt_fp8x2_to_halfraw2(two, __NV_E4M3)));
}

// The slot of a row starting at column col, element by element, zero past
// d: the copy of a row that is not slot-aligned.
template <typename T, int W>
__device__ __forceinline__ void load_elems(const T* __restrict__ row, int col,
                                           int d, uint32_t (&u)[W]);

template <>
__device__ __forceinline__ void load_elems<float, 4>(
    const float* __restrict__ row, int col, int d, uint32_t (&u)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
    u[i] = (col + i < d) ? __float_as_uint(row[col + i]) : 0u;
}

template <>
__device__ __forceinline__ void load_elems<__nv_bfloat16, 4>(
    const __nv_bfloat16* __restrict__ row, int col, int d, uint32_t (&u)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t lo = (col + 2 * i < d)
        ? (uint32_t)__bfloat16_as_ushort(row[col + 2 * i]) : 0u;
    const uint32_t hi = (col + 2 * i + 1 < d)
        ? (uint32_t)__bfloat16_as_ushort(row[col + 2 * i + 1]) : 0u;
    u[i] = lo | (hi << 16);
  }
}

template <>
__device__ __forceinline__ void load_elems<__nv_fp8_e4m3, 2>(
    const __nv_fp8_e4m3* __restrict__ row, int col, int d, uint32_t (&u)[2]) {
  const uint8_t* p = reinterpret_cast<const uint8_t*>(row);
  u[0] = u[1] = 0u;
#pragma unroll
  for (int i = 0; i < 8; ++i)
    if (col + i < d) u[i >> 2] |= (uint32_t)p[col + i] << (8 * (i & 3));
}

// Kahan step: s + c_lost is the running sum; the true sum is s - c.
__device__ __forceinline__ void kahan_add(float& s, float& c, float v) {
  const float y = v - c;
  const float t = s + y;
  c = (t - s) - y;
  s = t;
}

template <int LINK>
__device__ __forceinline__ void link_eval(float m, float y, float w, float ys,
                                          float& mult, float& loss) {
  if (LINK == kLogistic) {
    const float e = expf(-fabsf(m));               // in (0, 1]
    const float sig = (m >= 0.0f) ? 1.0f / (1.0f + e) : e / (1.0f + e);
    const float softplus = fmaxf(m, 0.0f) + log1pf(e);
    mult = w * (sig - y);
    loss = w * (softplus - y * m);
  } else {  // squared: the least-squares residual
    const float err = m - ys * y;
    mult = w * err;
    loss = 0.5f * w * err * err;
  }
}

// scalars = [off, ys]; partials: gridDim.x rows of (d + 3) doubles; dynamic
// shared memory: Plan<T, E>::kSmem bytes.
template <typename T, int E, int LINK>
__global__ void __launch_bounds__(kThreads, 1)
    glm_sweep_kernel(const T* __restrict__ x, const float* __restrict__ y,
                     const float* __restrict__ w,
                     const float* __restrict__ beta,
                     const float* __restrict__ scalars, long long n, int d,
                     int vec_ok, double* __restrict__ partials) {
  using P = Plan<T, E>;
  constexpr int V = Slot<T>::V, W = Slot<T>::W;
  constexpr int kSlotBytes = 4 * W;
  constexpr int kSlots = E / V;  // slots per lane
  constexpr int S = P::S, R = P::R;
  constexpr int kWidth = P::kWidth, kRowBytes = P::kRowBytes;
  extern __shared__ __align__(16) uint8_t smem[];
  float* s_beta = reinterpret_cast<float*>(smem);
  uint8_t* s_x = smem + kWidth * sizeof(float);
  float* s_yw = reinterpret_cast<float*>(s_x + P::kRingBytes);
  // this thread's compensations e..e+3 at my_comp[(e / 4) * kThreads]
  float4* const my_comp =
      reinterpret_cast<float4*>(s_yw + kWarps * S * 2) + threadIdx.x;
  double* s_red = reinterpret_cast<double*>(s_x);  // once the ring drained

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int j = threadIdx.x; j < kWidth; j += kThreads)
    s_beta[j] = (j < d) ? beta[j] : 0.0f;
  const float off = scalars[0];
  const float ys = scalars[1];
  __syncthreads();

  // this lane's slot k of stage s is at my_x + s * kRowBytes + k * 32 *
  // kSlotBytes; the warp's y and w of stage s at my_yw[2s], my_yw[2s + 1]
  uint8_t* const my_x = s_x + warp * S * kRowBytes + lane * kSlotBytes;
  float* const my_yw = s_yw + warp * S * 2;
  const uint32_t my_x_sh = hopper::smem_u32(my_x);
  const uint32_t my_yw_sh = hopper::smem_u32(my_yw);
  const long long n_warps = (long long)gridDim.x * kWarps;
  const long long first = (long long)blockIdx.x * kWarps + warp;
  const float* const yw_src = (lane == 0) ? y : w;  // lanes 0 and 1

  // row r (zeros past n) into stage s, one commit group. A zero-filled
  // copy reads nothing from its source address.
  auto stage_row = [&](long long r, int s) {
    const bool live = r < n;
    const long long rr = live ? r : 0LL;
    const uint32_t dst = my_x_sh + s * kRowBytes;
    if (vec_ok) {
      const T* src = x + rr * d + lane * V;
#pragma unroll
      for (int k = 0; k < kSlots; ++k) {
        const int bytes =
            (live && (k * 32 + lane) * V < d) ? kSlotBytes : 0;
        if constexpr (kSlotBytes == 16)
          hopper::cp_async16(dst + k * 32 * kSlotBytes, src + k * 32 * V,
                             bytes);
        else
          hopper::cp_async8(dst + k * 32 * kSlotBytes, src + k * 32 * V,
                            bytes);
      }
    } else {  // one slot at a time: its loads are the only ones live
      const T* row = x + rr * d;
#pragma unroll 1
      for (int k = 0; k < kSlots; ++k) {
        uint32_t u[W];
        load_elems<T, W>(row, (k * 32 + lane) * V, live ? d : 0, u);
        uint8_t* const at = my_x + s * kRowBytes + k * 32 * kSlotBytes;
        if constexpr (W == 4)
          *reinterpret_cast<uint4*>(at) = make_uint4(u[0], u[1], u[2], u[3]);
        else
          *reinterpret_cast<uint2*>(at) = make_uint2(u[0], u[1]);
      }
    }
    if (lane < 2)
      hopper::cp_async4(my_yw_sh + (2 * s + lane) * 4, yw_src + rr,
                        live ? 4 : 0);
    hopper::cp_async_commit();
  };

  float acc[E], comp[P::kCompShared ? 1 : E];
#pragma unroll
  for (int e = 0; e < E; ++e) acc[e] = 0.0f;
  if constexpr (P::kCompShared) {
#pragma unroll
    for (int q = 0; q < E / 4; ++q)
      my_comp[q * kThreads] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  } else {
#pragma unroll
    for (int e = 0; e < E; ++e) comp[e] = 0.0f;
  }
  float loss_s = 0.0f, loss_c = 0.0f;
  float mult_s = 0.0f, mult_c = 0.0f;
  float w_s = 0.0f, w_c = 0.0f;

  // row i of this warp is first + i * n_warps and goes to stage i % S
  if (first < n) {
#pragma unroll
    for (int s = 0; s < S; ++s) stage_row(first + s * n_warps, s);
  }
  int s0 = 0;  // the stage of the block's first row
  for (long long r = first; r < n; r += R * n_warps) {
    hopper::cp_async_wait<S - R>();  // this lane's copies of the block
    __syncwarp();                    // and lanes 0 and 1's y and w
    const uint8_t* const blk = my_x + s0 * kRowBytes;

    // the block's R margins, R chains interleaved
    float m[R];
#pragma unroll
    for (int j = 0; j < R; ++j) m[j] = 0.0f;
#pragma unroll 1
    for (int k = 0; k < kSlots; ++k) {
      const float* bk = s_beta + (k * 32 + lane) * V;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        uint32_t u[W];
        ld_slot<W>(blk + j * kRowBytes + k * 32 * kSlotBytes, u);
#pragma unroll
        for (int h = 0; h < V / 2; ++h) {
          const float2 xv = pair<T, W>(u, h);
          m[j] = fmaf(xv.x, bk[2 * h], m[j]);
          m[j] = fmaf(xv.y, bk[2 * h + 1], m[j]);
        }
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
      for (int j = 0; j < R; ++j)
        m[j] += __shfl_xor_sync(0xffffffffu, m[j], o);
    }

    // row j's link on lane j (lanes past R repeat one), its multiplier to
    // every lane; the block's loss, sum(mult) and sum(w) in plain f32, in
    // row order
    const int jl = lane & (R - 1);
    float mj = m[0];
#pragma unroll
    for (int j = 1; j < R; ++j)
      if (jl == j) mj = m[j];
    const float yl = my_yw[2 * (s0 + jl)], wl = my_yw[2 * (s0 + jl) + 1];
    float mult_l, loss_l;
    link_eval<LINK>(mj + off, yl, wl, ys, mult_l, loss_l);
    float mult[R];
    float loss_b = 0.0f, mult_b = 0.0f, w_b = 0.0f;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      mult[j] = __shfl_sync(0xffffffffu, mult_l, j);
      loss_b += __shfl_sync(0xffffffffu, loss_l, j);
      mult_b += mult[j];
      w_b += __shfl_sync(0xffffffffu, wl, j);
    }
    kahan_add(loss_s, loss_c, loss_b);
    kahan_add(mult_s, mult_c, mult_b);
    kahan_add(w_s, w_c, w_b);

    // the gradient: each element's block sum in plain f32, one Kahan step
#pragma unroll
    for (int k = 0; k < kSlots; ++k) {
      uint32_t u[R][W];
#pragma unroll
      for (int j = 0; j < R; ++j)
        ld_slot<W>(blk + j * kRowBytes + k * 32 * kSlotBytes, u[j]);
      float b[V];
#pragma unroll
      for (int h = 0; h < V / 2; ++h) {
        b[2 * h] = b[2 * h + 1] = 0.0f;
#pragma unroll
        for (int j = 0; j < R; ++j) {
          const float2 xv = pair<T, W>(u[j], h);
          b[2 * h] = fmaf(mult[j], xv.x, b[2 * h]);
          b[2 * h + 1] = fmaf(mult[j], xv.y, b[2 * h + 1]);
        }
      }
      float* const a = acc + k * V;
      if constexpr (P::kCompShared) {
#pragma unroll
        for (int q = 0; q < V / 4; ++q) {
          float4 c = my_comp[(k * V / 4 + q) * kThreads];
          kahan_add(a[4 * q], c.x, b[4 * q]);
          kahan_add(a[4 * q + 1], c.y, b[4 * q + 1]);
          kahan_add(a[4 * q + 2], c.z, b[4 * q + 2]);
          kahan_add(a[4 * q + 3], c.w, b[4 * q + 3]);
          my_comp[(k * V / 4 + q) * kThreads] = c;
        }
      } else {
#pragma unroll
        for (int i = 0; i < V; ++i) kahan_add(a[i], comp[k * V + i], b[i]);
      }
    }

    __syncwarp();  // every lane has read the block's y and w
#pragma unroll
    for (int j = 0; j < R; ++j) stage_row(r + (S + j) * n_warps, s0 + j);
    s0 = (s0 + R) % S;
  }
  hopper::cp_async_wait<0>();  // the zero-filled copies past n
  __syncthreads();             // every warp is done with its ring

  // fold the warps into one CTA partial, in warp order, in double
  for (int wi = 0; wi < kWarps; ++wi) {
    if (warp == wi) {
#pragma unroll
      for (int k = 0; k < kSlots; ++k) {
#pragma unroll
        for (int i = 0; i < V; ++i) {
          const int e = k * V + i;
          float c;
          if constexpr (P::kCompShared)
            c = reinterpret_cast<const float*>(my_comp + (e / 4) * kThreads)
                [e % 4];
          else
            c = comp[e];
          const int j = (k * 32 + lane) * V + i;
          const double v = (double)acc[e] - (double)c;
          s_red[j] = (wi == 0) ? v : s_red[j] + v;
        }
      }
      if (lane == 0) {
        const double t[3] = {(double)loss_s - (double)loss_c,
                             (double)mult_s - (double)mult_c,
                             (double)w_s - (double)w_c};
#pragma unroll
        for (int i = 0; i < 3; ++i)
          s_red[kWidth + i] = (wi == 0) ? t[i] : s_red[kWidth + i] + t[i];
      }
    }
    __syncthreads();
  }
  double* out = partials + (long long)blockIdx.x * (d + 3);
  for (int j = threadIdx.x; j < d; j += kThreads) out[j] = s_red[j];
  if (threadIdx.x < 3) out[d + threadIdx.x] = s_red[kWidth + threadIdx.x];
}

// out[j] = sum over CTAs c, in order, of partials[c][j]; rounded to f32.
// The loads run ahead of the (ordered) adds.
__global__ void glm_reduce_kernel(const double* __restrict__ partials,
                                  int n_parts, int width,
                                  float* __restrict__ out) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= width) return;
  double s = 0.0;
#pragma unroll 8
  for (int c = 0; c < n_parts; ++c) s += partials[(long long)c * width + j];
  out[j] = (float)s;
}

// -- the wide instance: one read of X (2048 < d <= 12288) --------------------

constexpr int kNarrowMaxD = 32 * kMaxE;  // the narrow instances' widest d
constexpr int kWideMaxD = 12288;         // the one-read instance's widest d
constexpr int kOneWarps = 16;            // a CTA of the one-read instance
constexpr int kOneThreads = 32 * kOneWarps;
constexpr int kOneRing = 192 * 1024;     // bytes of its ring, at most

// The shape of a one-read instance: thread t holds slots t, t + 512, ... of
// every row (E elements, kSlots slots); a tile is G consecutive rows (G a
// multiple of R, at most 4), a ring of S tiles, G the largest that leaves
// at least four stages.
template <typename T, int E>
struct OnePlan {
  static constexpr int V = Slot<T>::V, W = Slot<T>::W;
  static constexpr int kSlotBytes = 4 * W;
  static constexpr int kSlots = E / V;
  static constexpr int R = Plan<T, 8>::R;
  static constexpr int kRowBytes = kOneThreads * kSlots * kSlotBytes;
  static constexpr int stages(int g) { return kOneRing / (g * kRowBytes); }
  static constexpr int G = (R <= 4 && stages(4) >= 4)   ? 4
                           : (R <= 2 && stages(2) >= 4) ? 2
                                                        : R;
  static constexpr int S = stages(G) > 8 ? 8 : stages(G);
  static constexpr int kStageBytes = G * kRowBytes;
  // the ring, each row's y and w, the warps' partial margins (two tiles),
  // each row's multiplier, loss and weight (two tiles)
  static constexpr int kSmem = S * kStageBytes + S * G * 8 +
                               2 * kOneWarps * G * 4 + 2 * 3 * G * 4;
  static_assert(G % R == 0 && S >= 3, "a tile holds whole blocks");
  static_assert(E % V == 0, "whole slots");
};

// Sums over a warp's lanes of G values a lane (rows 0..G-1), G a power of
// two: each level of xor shuffles halves the values a lane keeps (the
// lanes with bit o set keep the upper half), then the lanes of a row
// finish by a butterfly, so row i's sum ends, with the same bits, in lanes
// [i * 32 / G, (i + 1) * 32 / G). G - 1 + 5 - log2(G) shuffles.
template <int G>
__device__ __forceinline__ float warp_rows(const float (&m)[G], int lane) {
  float v[G];
#pragma unroll
  for (int i = 0; i < G; ++i) v[i] = m[i];
#pragma unroll
  for (int h = G / 2, o = 16; h >= 1; h >>= 1, o >>= 1) {
    const bool up = (lane & o) != 0;
#pragma unroll
    for (int i = 0; i < h; ++i) {
      const float keep = up ? v[h + i] : v[i];
      const float send = up ? v[i] : v[h + i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, o);
    }
  }
#pragma unroll
  for (int o = 16 / G; o > 0; o >>= 1)
    v[0] += __shfl_xor_sync(0xffffffffu, v[0], o);
  return v[0];
}

// The one-read wide sweep. Arguments as glm_sweep_kernel's (beta: (d,)
// f32); partials: gridDim.x rows of (d + 3) doubles. A CTA takes tiles
// blockIdx.x, + gridDim.x, ... of G rows; every thread copies its own
// slots of a tile's rows into its own ring slots (cp.async, no barrier
// between a copy and its reads) and keeps them there from the margins to
// the gradient. Iteration j: the link of tile j (row i by lane 0 of warp
// i), the partial margins of tile j + 1, one barrier, the gradient of
// tile j, then tile j + S into the freed stage.
template <typename T, int E, int LINK>
__global__ void __launch_bounds__(kOneThreads, 1)
    glm_sweep_wide_kernel(const T* __restrict__ x,
                          const float* __restrict__ y,
                          const float* __restrict__ w,
                          const float* __restrict__ beta,
                          const float* __restrict__ scalars, long long n,
                          int d, int vec_ok, double* __restrict__ partials) {
  using P = OnePlan<T, E>;
  constexpr int V = P::V, W = P::W, SB = P::kSlotBytes, KS = P::kSlots;
  constexpr int G = P::G, S = P::S, R = P::R;
  constexpr int kRowBytes = P::kRowBytes, kStageBytes = P::kStageBytes;
  constexpr int kSlotStep = kOneThreads * SB;  // bytes between a thread's slots
  extern __shared__ __align__(16) uint8_t smem[];
  float* s_yw = reinterpret_cast<float*>(smem + S * kStageBytes);
  float* s_pm = s_yw + S * G * 2;          // [2][warps][G]
  float* s_lk = s_pm + 2 * kOneWarps * G;  // [2][3][G]: mult, loss, w

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float off = scalars[0];
  const float ys = scalars[1];
  const long long grid = gridDim.x;
  const long long n_tiles = (n + G - 1) / G;
  const long long n_mine = (blockIdx.x < n_tiles)
                               ? (n_tiles - 1 - blockIdx.x) / grid + 1
                               : 0;  // this CTA's tiles

  // this thread's coefficients: slot k holds columns (k * 512 + tid) V + e
  float bet[E];
#pragma unroll
  for (int k = 0; k < KS; ++k)
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const int col = (k * kOneThreads + tid) * V + e;
      bet[k * V + e] = (col < d) ? beta[col] : 0.0f;
    }

  uint8_t* const my_x = smem + tid * SB;
  const uint32_t my_x_sh = hopper::smem_u32(my_x);
  const uint32_t yw_sh = hopper::smem_u32(s_yw);
  const bool yw_copier = lane == 0 && warp < G;  // row `warp`'s y and w

  // this thread's share of the j-th tile into stage j % S, one group (an
  // empty group past the end keeps the count). Rows past n and columns
  // past d are zero-filled copies that read nothing.
  auto issue = [&](long long j) {
    if (j < n_mine) {
      const int s = (int)(j % S);
      const long long r0 = (blockIdx.x + j * grid) * G;
#pragma unroll
      for (int i = 0; i < G; ++i) {
        const long long r = r0 + i;
        const bool live = r < n;
        const long long rr = live ? r : 0LL;
        const int at = (s * G + i) * kRowBytes;
        if (vec_ok) {
          const T* src = x + rr * d + tid * V;
#pragma unroll
          for (int k = 0; k < KS; ++k) {
            const int bytes =
                (live && (k * kOneThreads + tid) * V < d) ? SB : 0;
            if constexpr (SB == 16)
              hopper::cp_async16(my_x_sh + at + k * kSlotStep,
                                 src + k * kOneThreads * V, bytes);
            else
              hopper::cp_async8(my_x_sh + at + k * kSlotStep,
                                src + k * kOneThreads * V, bytes);
          }
        } else {  // element by element, one slot at a time
          const T* row = x + rr * d;
#pragma unroll 1
          for (int k = 0; k < KS; ++k) {
            uint32_t u[W];
            load_elems<T, W>(row, (k * kOneThreads + tid) * V,
                             live ? d : 0, u);
            uint8_t* const p = my_x + at + k * kSlotStep;
            if constexpr (W == 4)
              *reinterpret_cast<uint4*>(p) = make_uint4(u[0], u[1], u[2], u[3]);
            else
              *reinterpret_cast<uint2*>(p) = make_uint2(u[0], u[1]);
          }
        }
      }
      if (yw_copier) {
        const long long r = r0 + warp;
        const bool live = r < n;
        const uint32_t at = yw_sh + (s * G + warp) * 8;
        hopper::cp_async4(at, y + (live ? r : 0LL), live ? 4 : 0);
        hopper::cp_async4(at + 4, w + (live ? r : 0LL), live ? 4 : 0);
      }
    }
    hopper::cp_async_commit();
  };

  // the warp's partial margins of the j-th tile into s_pm[j & 1]: this
  // thread's products in slot order, then warp_rows
  auto margins = [&](long long j) {
    const uint8_t* const base = my_x + (int)(j % S) * kStageBytes;
    float m[G];
#pragma unroll
    for (int i = 0; i < G; ++i) m[i] = 0.0f;
#pragma unroll
    for (int k = 0; k < KS; ++k) {
#pragma unroll
      for (int i = 0; i < G; ++i) {
        uint32_t u[W];
        ld_slot<W>(base + i * kRowBytes + k * kSlotStep, u);
#pragma unroll
        for (int h = 0; h < V / 2; ++h) {
          const float2 xv = pair<T, W>(u, h);
          m[i] = fmaf(xv.x, bet[k * V + 2 * h], m[i]);
          m[i] = fmaf(xv.y, bet[k * V + 2 * h + 1], m[i]);
        }
      }
    }
    const float ms = warp_rows<G>(m, lane);
    if ((lane & (32 / G - 1)) == 0)
      s_pm[((int)(j & 1) * kOneWarps + warp) * G + lane / (32 / G)] = ms;
  };

  // row `warp` of the j-th tile: its margin (the warps' partials in warp
  // order), multiplier and loss, by lane 0
  auto link = [&](long long j) {
    if (yw_copier) {
      const float* pm = s_pm + (int)(j & 1) * kOneWarps * G + warp;
      float m = 0.0f;
#pragma unroll
      for (int wi = 0; wi < kOneWarps; ++wi) m += pm[wi * G];
      const float* yw = s_yw + ((int)(j % S) * G + warp) * 2;
      float mult, loss;
      link_eval<LINK>(m + off, yw[0], yw[1], ys, mult, loss);
      float* lk = s_lk + (int)(j & 1) * 3 * G;
      lk[warp] = mult;
      lk[G + warp] = loss;
      lk[2 * G + warp] = yw[1];
    }
  };

  float acc[E], comp[E];
#pragma unroll
  for (int e = 0; e < E; ++e) acc[e] = comp[e] = 0.0f;
  float loss_s = 0.0f, loss_c = 0.0f;
  float mult_s = 0.0f, mult_c = 0.0f;
  float w_s = 0.0f, w_c = 0.0f;

  // the j-th tile's gradient, from the ring: each element's block of R
  // rows in plain f32 (fmaf over the rows), one Kahan step; thread 0 the
  // loss, sum(mult) and sum(w) the same way, in row order. No block past
  // the last row.
  auto gradient = [&](long long j) {
    const uint8_t* const base = my_x + (int)(j % S) * kStageBytes;
    const float* lk = s_lk + (int)(j & 1) * 3 * G;
    const long long r0 = (blockIdx.x + j * grid) * G;
    float mult[G];
#pragma unroll
    for (int i = 0; i < G; ++i) mult[i] = lk[i];
#pragma unroll
    for (int k = 0; k < KS; ++k) {
#pragma unroll
      for (int b0 = 0; b0 < G; b0 += R) {
        if (r0 + b0 < n) {
          uint32_t u[R][W];
#pragma unroll
          for (int i = 0; i < R; ++i)
            ld_slot<W>(base + (b0 + i) * kRowBytes + k * kSlotStep, u[i]);
          float b[V];
#pragma unroll
          for (int h = 0; h < V / 2; ++h) {
            b[2 * h] = b[2 * h + 1] = 0.0f;
#pragma unroll
            for (int i = 0; i < R; ++i) {
              const float2 xv = pair<T, W>(u[i], h);
              b[2 * h] = fmaf(mult[b0 + i], xv.x, b[2 * h]);
              b[2 * h + 1] = fmaf(mult[b0 + i], xv.y, b[2 * h + 1]);
            }
          }
#pragma unroll
          for (int e = 0; e < V; ++e)
            kahan_add(acc[k * V + e], comp[k * V + e], b[e]);
        }
      }
    }
    if (tid == 0) {
#pragma unroll
      for (int b0 = 0; b0 < G; b0 += R) {
        if (r0 + b0 < n) {
          float loss_b = 0.0f, mult_b = 0.0f, w_b = 0.0f;
#pragma unroll
          for (int i = b0; i < b0 + R; ++i) {
            mult_b += lk[i];
            loss_b += lk[G + i];
            w_b += lk[2 * G + i];
          }
          kahan_add(loss_s, loss_c, loss_b);
          kahan_add(mult_s, mult_c, mult_b);
          kahan_add(w_s, w_c, w_b);
        }
      }
    }
  };

  // groups committed before iteration j >= 0: S + j (tiles up to S + j - 1);
  // iteration -1 takes tile 0's margins alone
#pragma unroll 1
  for (int s = 0; s < S; ++s) issue(s);
#pragma unroll 1
  for (long long j = -1; j < n_mine; ++j) {
    if (j >= 0) link(j);
    if (j + 1 < n_mine) {
      hopper::cp_async_wait<S - 2>();  // tile j + 1
      margins(j + 1);
    }
    __syncthreads();  // tile j's multipliers, tile j + 1's partial margins
    if (j >= 0) {
      gradient(j);
      issue(j + S);  // this thread is done with stage j % S
    }
  }
  hopper::cp_async_wait<0>();  // the empty groups

  // each column is one thread's: no fold across threads
  double* out = partials + (long long)blockIdx.x * (d + 3);
#pragma unroll
  for (int k = 0; k < KS; ++k)
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const int col = (k * kOneThreads + tid) * V + e;
      if (col < d)
        out[col] = (double)acc[k * V + e] - (double)comp[k * V + e];
    }
  if (tid == 0) {
    out[d] = (double)loss_s - (double)loss_c;
    out[d + 1] = (double)mult_s - (double)mult_c;
    out[d + 2] = (double)w_s - (double)w_c;
  }
}

// -- the two-pass instance (d > 12288) --------------------------------------

constexpr int kWideGroup = 4;  // rows in flight: a warp's (margins) or a
                               // thread's (gradient)
constexpr int kWidePartsPerSm = 4;  // partial rows (CTAs, slabs) per SM,
                                    // at most

// A slot of row r from column slot k * V: one copy when vec_ok, else
// element by element; zeros for a dead row.
template <typename T>
__device__ __forceinline__ void wide_slot(const T* __restrict__ x,
                                          long long r, int k, int d,
                                          bool live, int vec_ok,
                                          uint32_t (&u)[Slot<T>::W]) {
  constexpr int V = Slot<T>::V, W = Slot<T>::W;
  const T* row = x + r * d;
  if (!live) {
#pragma unroll
    for (int i = 0; i < W; ++i) u[i] = 0u;
  } else if (vec_ok) {
    if constexpr (W == 4) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(row + k * V));
      u[0] = v.x;
      u[1] = v.y;
      u[2] = v.z;
      u[3] = v.w;
    } else {
      const uint2 v = __ldg(reinterpret_cast<const uint2*>(row + k * V));
      u[0] = v.x;
      u[1] = v.y;
    }
  } else {
    load_elems<T, W>(row, k * V, d, u);
  }
}

// The margin pass. beta: (d rounded up to 8,) f32, zero past d; scalars =
// [off, ys]; mult: (n,) f32 out; partials: gridDim.x rows of (d + 3)
// doubles, of which this pass writes the last three.
template <typename T, int LINK>
__global__ void __launch_bounds__(kThreads)
    glm_wide_margin_kernel(const T* __restrict__ x,
                           const float* __restrict__ y,
                           const float* __restrict__ w,
                           const float* __restrict__ beta,
                           const float* __restrict__ scalars, long long n,
                           int d, int vec_ok, float* __restrict__ mult_out,
                           double* __restrict__ partials) {
  constexpr int V = Slot<T>::V, W = Slot<T>::W, G = kWideGroup;
  constexpr int R = Plan<T, 8>::R;
  static_assert(G % R == 0, "a group holds whole blocks");
  __shared__ double s_red[kWarps][3];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float off = scalars[0];
  const float ys = scalars[1];
  const int n_slots = (d + V - 1) / V;
  const long long n_warps = (long long)gridDim.x * kWarps;
  float loss_s = 0.0f, loss_c = 0.0f;
  float mult_s = 0.0f, mult_c = 0.0f;
  float w_s = 0.0f, w_c = 0.0f;

  for (long long q = (long long)blockIdx.x * kWarps + warp; q * G < n;
       q += n_warps) {
    const long long r0 = q * G;
    float m[G];
#pragma unroll
    for (int j = 0; j < G; ++j) m[j] = 0.0f;
#pragma unroll 2
    for (int k = lane; k < n_slots; k += 32) {
      float b[V];
#pragma unroll
      for (int i = 0; i < V / 4; ++i) {
        const float4 v = __ldg(reinterpret_cast<const float4*>(beta + k * V)
                               + i);
        b[4 * i] = v.x;
        b[4 * i + 1] = v.y;
        b[4 * i + 2] = v.z;
        b[4 * i + 3] = v.w;
      }
      uint32_t u[G][W];
#pragma unroll
      for (int j = 0; j < G; ++j)
        wide_slot<T>(x, r0 + j, k, d, r0 + j < n, vec_ok, u[j]);
#pragma unroll
      for (int j = 0; j < G; ++j) {
#pragma unroll
        for (int h = 0; h < V / 2; ++h) {
          const float2 xv = pair<T, W>(u[j], h);
          m[j] = fmaf(xv.x, b[2 * h], m[j]);
          m[j] = fmaf(xv.y, b[2 * h + 1], m[j]);
        }
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
      for (int j = 0; j < G; ++j)
        m[j] += __shfl_xor_sync(0xffffffffu, m[j], o);
    }
    // row j's link on lane j (lanes past G repeat one; rows past n have
    // y = w = 0: multiplier and loss 0)
    const int jl = lane & (G - 1);
    float mj = m[0];
#pragma unroll
    for (int j = 1; j < G; ++j)
      if (jl == j) mj = m[j];
    const long long rl = r0 + jl;
    const bool live = rl < n;
    const float yl = live ? __ldg(y + rl) : 0.0f;
    const float wl = live ? __ldg(w + rl) : 0.0f;
    float mult_l, loss_l;
    link_eval<LINK>(mj + off, yl, wl, ys, mult_l, loss_l);
    if (lane < G && live) mult_out[rl] = mult_l;
    // blocks of R rows in plain f32, in row order, Kahan across blocks
#pragma unroll
    for (int b0 = 0; b0 < G; b0 += R) {
      float loss_b = 0.0f, mult_b = 0.0f, w_b = 0.0f;
#pragma unroll
      for (int j = b0; j < b0 + R; ++j) {
        loss_b += __shfl_sync(0xffffffffu, loss_l, j);
        mult_b += __shfl_sync(0xffffffffu, mult_l, j);
        w_b += __shfl_sync(0xffffffffu, wl, j);
      }
      if (r0 + b0 < n) {  // no block past the last row
        kahan_add(loss_s, loss_c, loss_b);
        kahan_add(mult_s, mult_c, mult_b);
        kahan_add(w_s, w_c, w_b);
      }
    }
  }
  if (lane == 0) {
    s_red[warp][0] = (double)loss_s - (double)loss_c;
    s_red[warp][1] = (double)mult_s - (double)mult_c;
    s_red[warp][2] = (double)w_s - (double)w_c;
  }
  __syncthreads();
  if (threadIdx.x < 3) {
    double t = 0.0;
    for (int wi = 0; wi < kWarps; ++wi) t += s_red[wi][threadIdx.x];
    partials[(long long)blockIdx.x * (d + 3) + d + threadIdx.x] = t;
  }
}

// The gradient pass: CTA (block, slab) sums mult_r x_r over the slab's
// rows [slab * slab_rows, + slab_rows) for the block's columns, one slot a
// thread, into columns of partial row `slab` (d + 3 doubles a row).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    glm_wide_grad_kernel(const T* __restrict__ x,
                         const float* __restrict__ mult, long long n, int d,
                         int vec_ok, long long slab_rows,
                         double* __restrict__ partials) {
  constexpr int V = Slot<T>::V, W = Slot<T>::W, G = kWideGroup;
  constexpr int R = Plan<T, 8>::R;
  const int k = blockIdx.x * kThreads + threadIdx.x;  // this thread's slot
  const bool active = k * V < d;
  const long long lo = (long long)blockIdx.y * slab_rows;
  const long long hi = (lo + slab_rows < n) ? lo + slab_rows : n;
  float acc[V], comp[V];
#pragma unroll
  for (int i = 0; i < V; ++i) acc[i] = comp[i] = 0.0f;
  for (long long r0 = lo; r0 < hi; r0 += G) {
    uint32_t u[G][W];
    float mv[G];
#pragma unroll
    for (int j = 0; j < G; ++j) {
      const bool live = r0 + j < hi;
      wide_slot<T>(x, r0 + j, k, d, live && active, vec_ok, u[j]);
      mv[j] = live ? __ldg(mult + r0 + j) : 0.0f;
    }
#pragma unroll
    for (int b0 = 0; b0 < G; b0 += R) {
      float bs[V];
#pragma unroll
      for (int h = 0; h < V / 2; ++h) {
        bs[2 * h] = bs[2 * h + 1] = 0.0f;
#pragma unroll
        for (int j = b0; j < b0 + R; ++j) {
          const float2 xv = pair<T, W>(u[j], h);
          bs[2 * h] = fmaf(mv[j], xv.x, bs[2 * h]);
          bs[2 * h + 1] = fmaf(mv[j], xv.y, bs[2 * h + 1]);
        }
      }
      if (r0 + b0 < hi) {  // no block past the slab
#pragma unroll
        for (int i = 0; i < V; ++i) kahan_add(acc[i], comp[i], bs[i]);
      }
    }
  }
  if (!active) return;
  double* out = partials + (long long)blockIdx.y * (d + 3);
#pragma unroll
  for (int i = 0; i < V; ++i)
    if (k * V + i < d) out[k * V + i] = (double)acc[i] - (double)comp[i];
}

// The two-pass instance's two kernels for (dtype, link).
struct Wide {
  const void* margin;
  const void* grad;
  int block;  // R
  int cols;   // columns of a gradient CTA
};

template <typename T>
Wide make_wide(int link) {
  return {link == kLogistic
              ? reinterpret_cast<const void*>(
                    &glm_wide_margin_kernel<T, kLogistic>)
              : reinterpret_cast<const void*>(
                    &glm_wide_margin_kernel<T, kSquared>),
          reinterpret_cast<const void*>(&glm_wide_grad_kernel<T>),
          Plan<T, 8>::R, kThreads * Slot<T>::V};
}

// the two-pass instance for (dtype, link) at any d > 2048 (the sweep
// routes to it past 12288; glm_sweep_two_pass_launch takes it at any wide
// d, for a comparison in one run)
Wide wide_for(int dtype, int link, int d) {
  const Wide none = {nullptr, nullptr, 0, 0};
  if (d <= kNarrowMaxD || (link != kLogistic && link != kSquared))
    return none;
  if (dtype == 0) return make_wide<float>(link);
  if (dtype == 1) return make_wide<__nv_bfloat16>(link);
  if (dtype == 2) return make_wide<__nv_fp8_e4m3>(link);
  return none;
}

// One instance of one read of X (narrow or wide) and what its launch
// needs.
struct Instance {
  const void* fn;  // a glm_sweep_kernel or glm_sweep_wide_kernel instance
  int smem;        // dynamic shared memory, bytes
  int stages;      // S
  int block;       // R
  int bit;         // its bit in ready[][] below
  int threads;     // a CTA's
  int group;       // rows of a tile (the wide instance's G; 4 kWarps narrow)
};

// per device, the instances whose shared-memory limit has been raised (66
// bits: 48 narrow, 18 wide)
std::atomic<uint64_t> ready[kMaxDevices][2];

// E rounded up to a multiple of 8 covers every slot width (4 f32, 8 bf16,
// 8 e4m3): a narrow lane's elements, or a wide thread's.
int elems_per_lane(int d) { return ((d + 255) / 256) * 8; }
int elems_per_thread(int d) {
  return ((d + 8 * kOneThreads - 1) / (8 * kOneThreads)) * 8;
}

template <typename T, int E, int LINK>
Instance make_instance(int dtype) {
  using P = Plan<T, E>;
  return {reinterpret_cast<const void*>(&glm_sweep_kernel<T, E, LINK>),
          P::kSmem, P::S, P::R, dtype * 16 + LINK * 8 + E / 8 - 1, kThreads,
          4 * kWarps};
}

// bits 48.. of ready[][]: dtype * 6 + LINK * 3 + E / 8 - 1
template <typename T, int E, int LINK>
Instance make_one(int dtype) {
  using P = OnePlan<T, E>;
  return {reinterpret_cast<const void*>(
              &glm_sweep_wide_kernel<T, E, LINK>),
          P::kSmem, P::S, P::R, 48 + dtype * 6 + LINK * 3 + E / 8 - 1,
          kOneThreads, P::G};
}

template <typename T, int LINK>
Instance pick_kernel(int dtype, int e) {
#define CYCLONE_GLM_CASE(E) \
  case E:                   \
    return make_instance<T, E, LINK>(dtype);
  switch (e) {
    CYCLONE_GLM_CASE(8)
    CYCLONE_GLM_CASE(16)
    CYCLONE_GLM_CASE(24)
    CYCLONE_GLM_CASE(32)
    CYCLONE_GLM_CASE(40)
    CYCLONE_GLM_CASE(48)
    CYCLONE_GLM_CASE(56)
    CYCLONE_GLM_CASE(64)
    default:
      return {nullptr, 0, 0, 0, 0, 0, 0};
  }
#undef CYCLONE_GLM_CASE
}

template <typename T, int LINK>
Instance pick_one(int dtype, int e) {
  if (e == 8) return make_one<T, 8, LINK>(dtype);
  if (e == 16) return make_one<T, 16, LINK>(dtype);
  if (e == 24) return make_one<T, 24, LINK>(dtype);
  return {nullptr, 0, 0, 0, 0, 0, 0};
}

template <typename T>
Instance pick_link(int dtype, int link, int d) {
  if (d > kNarrowMaxD) {
    const int e = elems_per_thread(d);
    if (link == kLogistic) return pick_one<T, kLogistic>(dtype, e);
    if (link == kSquared) return pick_one<T, kSquared>(dtype, e);
  } else {
    const int e = elems_per_lane(d);
    if (link == kLogistic) return pick_kernel<T, kLogistic>(dtype, e);
    if (link == kSquared) return pick_kernel<T, kSquared>(dtype, e);
  }
  return {nullptr, 0, 0, 0, 0, 0, 0};
}

// the instance of one read for (dtype, link, d <= 12288): narrow up to 2048
// columns, the wide one past them
Instance kernel_for(int dtype, int link, int d) {
  const Instance none = {nullptr, 0, 0, 0, 0, 0, 0};
  if (d < 1 || d > kWideMaxD) return none;
  if (dtype == 0) return pick_link<float>(dtype, link, d);
  if (dtype == 1) return pick_link<__nv_bfloat16>(dtype, link, d);
  if (dtype == 2) return pick_link<__nv_fp8_e4m3>(dtype, link, d);
  return none;
}

// Raises the instance's dynamic shared-memory limit on the current device,
// once per device.
cudaError_t prepare(const Instance& k) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint64_t bit = 1ull << (k.bit & 63);
  std::atomic<uint64_t>* word =
      dev < kMaxDevices ? &ready[dev][k.bit >> 6] : nullptr;
  if (word != nullptr && (word->load() & bit)) return cudaSuccess;
  err = cudaFuncSetAttribute(k.fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             k.smem);
  if (err == cudaSuccess && word != nullptr) word->fetch_or(bit);
  return err;
}

// CTAs of the instance resident on one SM of the current device, and the
// device's SMs.
cudaError_t residency(const Instance& k, int* per_sm, int* sms) {
  int dev = 0;
  cudaError_t err = prepare(k);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, k.fn,
                                                        k.threads, k.smem);
  return err;
}

// The two-pass instance's partial rows for n rows: as many margin CTAs as
// are resident at once, at most four per SM (the gradient's row slabs
// alike), at most one per 256 rows, at least one.
int two_pass_parts(const Wide& wide, long long n, int* n_parts) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, wide.margin,
                                                        kThreads, 0);
  if (err != cudaSuccess) return (int)err;
  // one wave of the margin pass (its CTAs walk equal shares of the rows):
  // a fourth CTA an SM that cannot be resident runs as a second, partial
  // wave (measured: 3 resident of 4 asked)
  if (per_sm < 1) per_sm = 1;
  if (per_sm > kWidePartsPerSm) per_sm = kWidePartsPerSm;
  long long parts = (long long)sms * per_sm;
  const long long by_rows = (n + 255) / 256;
  if (by_rows < parts) parts = by_rows;
  if (parts < 1) parts = 1;
  *n_parts = (int)parts;
  return 0;
}

}  // namespace

extern "C" {

// Largest d the narrow instances take; past it the wide ones run.
int glm_sweep_max_d() { return kNarrowMaxD; }

// Largest d the one-read wide instance takes; past it the two-pass one
// runs.
int glm_sweep_wide_max_d() { return kWideMaxD; }

// Partial rows a sweep of n rows uses on the current device. Instances of
// one read: one per CTA, as many as are resident at once, at most one per
// tile (the wide instance's G rows; a narrow CTA's 32 rows), at least one.
// Past d = 12288 the two-pass instance's (glm_sweep_two_pass_parts).
// dtype: 0 = float32 X, 1 = bfloat16 X, 2 = float8_e4m3fn codes;
// link: 0 = logistic, 1 = squared.
int glm_sweep_num_parts(int dtype, int link, int d, long long n,
                        int* n_parts) {
  if (d > kWideMaxD) {
    const Wide wide = wide_for(dtype, link, d);
    if (wide.margin == nullptr) return (int)cudaErrorInvalidValue;
    return two_pass_parts(wide, n, n_parts);
  }
  const Instance k = kernel_for(dtype, link, d);
  if (k.fn == nullptr) return (int)cudaErrorInvalidValue;
  int per_sm = 0, sms = 0;
  const cudaError_t err = residency(k, &per_sm, &sms);
  if (err != cudaSuccess) return (int)err;
  long long parts = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const long long by_rows = (n + k.group - 1) / k.group;
  if (by_rows < parts) parts = by_rows;
  if (parts < 1) parts = 1;
  *n_parts = (int)parts;
  return 0;
}

// The two-pass instance's partial rows at any d > 2048.
int glm_sweep_two_pass_parts(int dtype, int link, int d, long long n,
                             int* n_parts) {
  const Wide wide = wide_for(dtype, link, d);
  if (wide.margin == nullptr) return (int)cudaErrorInvalidValue;
  return two_pass_parts(wide, n, n_parts);
}

// The instance of one read a sweep of (dtype, link, d <= 12288) launches,
// as six ints: its ring stages S, its block rows R, its dynamic shared
// memory in bytes, its CTAs resident on one SM of the current device, the
// rows of a tile (the wide instance's G) and a CTA's threads.
int glm_sweep_plan(int dtype, int link, int d, int* plan) {
  const Instance k = kernel_for(dtype, link, d);
  if (k.fn == nullptr) return (int)cudaErrorInvalidValue;
  int per_sm = 0, sms = 0;
  const cudaError_t err = residency(k, &per_sm, &sms);
  if (err != cudaSuccess) return (int)err;
  plan[0] = k.stages;
  plan[1] = k.block;
  plan[2] = k.smem;
  plan[3] = per_sm;
  plan[4] = k.group;
  plan[5] = k.threads;
  return 0;
}

// The two-pass instance of (dtype, link, d > 2048), as five ints: its
// block rows R, its rows in flight G, a gradient CTA's columns, and the
// CTAs of its margin and gradient kernels resident on one SM.
int glm_sweep_two_pass_plan(int dtype, int link, int d, int* plan) {
  const Wide k = wide_for(dtype, link, d);
  if (k.margin == nullptr) return (int)cudaErrorInvalidValue;
  int margin = 0, grad = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &margin, k.margin, kThreads, 0);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&grad, k.grad,
                                                        kThreads, 0);
  if (err != cudaSuccess) return (int)err;
  plan[0] = k.block;
  plan[1] = kWideGroup;
  plan[2] = k.cols;
  plan[3] = margin;
  plan[4] = grad;
  return 0;
}

// One sweep of the two-pass instance (any d > 2048; the sweep's route past
// 12288). x, y, w, scalars, partials (n_parts * (d + 3) doubles, n_parts
// from glm_sweep_two_pass_parts) and out as for glm_sweep_launch; beta:
// (d rounded up to 8,) f32, zero past d; mult: n floats of scratch.
int glm_sweep_two_pass_launch(int dtype, int link, const void* x,
                              const float* y, const float* w,
                              const float* beta, const float* scalars,
                              long long n, int d, double* partials,
                              int n_parts, float* mult, float* out,
                              void* stream) {
  const Wide k = wide_for(dtype, link, d);
  if (k.margin == nullptr || n_parts < 1 || n < 0)
    return (int)cudaErrorInvalidValue;
  const size_t item = (dtype == 0) ? sizeof(float)
                      : (dtype == 1) ? sizeof(__nv_bfloat16)
                                     : sizeof(__nv_fp8_e4m3);
  const size_t slot = (dtype == 2) ? 8 : 16;
  int vec_ok = ((reinterpret_cast<uintptr_t>(x) % slot) == 0) &&
               (((size_t)d * item) % slot == 0);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  void* margs[] = {const_cast<void**>(&x), &y, &w, &beta, &scalars, &n, &d,
                   &vec_ok, &mult, &partials};
  cudaError_t err = cudaLaunchKernel(k.margin, dim3(n_parts), dim3(kThreads),
                                     margs, 0, s);
  if (err == cudaSuccess) err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  long long slab_rows = (n + n_parts - 1) / n_parts;
  if (slab_rows < 1) slab_rows = 1;
  const int blocks = (d + k.cols - 1) / k.cols;
  void* gargs[] = {const_cast<void**>(&x), &mult, &n, &d, &vec_ok,
                   &slab_rows, &partials};
  err = cudaLaunchKernel(k.grad, dim3(blocks, n_parts), dim3(kThreads),
                         gargs, 0, s);
  if (err == cudaSuccess) err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int width = d + 3;
  glm_reduce_kernel<<<(width + 255) / 256, 256, 0, s>>>(partials, n_parts,
                                                        width, out);
  return (int)cudaGetLastError();
}

// One sweep of one read of X (d <= 12288: the narrow instance, or the wide
// one past 2048 columns). x: (n, d) row-major at storage width; y, w: (n,)
// f32; beta: (d,) f32; scalars: [off, ys] f32 on the device (ys is read by
// the squared link only); partials: n_parts * (d + 3) doubles of scratch;
// out: d + 3 floats, written as [grad(d), loss, sum(mult), sum(w)].
int glm_sweep_launch(int dtype, int link, const void* x, const float* y,
                     const float* w, const float* beta, const float* scalars,
                     long long n, int d, double* partials, int n_parts,
                     float* out, void* stream) {
  const Instance k = kernel_for(dtype, link, d);
  if (k.fn == nullptr || n_parts < 1 || n < 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = prepare(k);
  if (err != cudaSuccess) return (int)err;
  // bytes per element and per slot of the instance kernel_for chose
  const size_t item = (dtype == 0) ? sizeof(float)
                      : (dtype == 1) ? sizeof(__nv_bfloat16)
                                     : sizeof(__nv_fp8_e4m3);
  const size_t slot = (dtype == 2) ? 8 : 16;
  const int vec_ok = ((reinterpret_cast<uintptr_t>(x) % slot) == 0) &&
                     (((size_t)d * item) % slot == 0);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  // the instance's X parameter is const T*; a pointer argument of the
  // same width is passed through the untyped launch
  void* args[] = {const_cast<void**>(&x), &y,  &w,      &beta,    &scalars,
                  &n,                     &d,  (void*)&vec_ok, &partials};
  err = cudaLaunchKernel(k.fn, dim3(n_parts), dim3(k.threads), args,
                         (size_t)k.smem, s);
  if (err == cudaSuccess) err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int width = d + 3;
  glm_reduce_kernel<<<(width + 255) / 256, 256, 0, s>>>(partials, n_parts,
                                                        width, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
