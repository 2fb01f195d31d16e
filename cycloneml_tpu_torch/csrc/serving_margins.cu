// Serving margins in a fixed order (sm_90a): for K linear models of Km
// margin rows over d features, and a bucket of B request rows,
//     out[k, b, m] = sum_j x[b, j] * c[k, m, j] + icpt[k, m]
// in the serving dtype (float32 or float64), with c either the serving
// dtype's coefficients or e4m3 codes times one scale a margin row,
// c[k, m, j] = code[k, m, j] * scale[k, m], rounded once.
//
// Replaces the reference's jnp predict kernels, not a Pallas kernel:
// linear_margins, stacked_linear_margins, quantized_linear_margins and
// stacked_quantized_linear_margins (cycloneml_tpu/serving/servable.py:67,
// :80, :88, :104). Their contract is bitwise: a row's margins are the same
// bits in every shape bucket, so zero-padding a batch up to its bucket
// changes nothing, and a gang of K models gives the bits of K serial
// lanes. No library call promises that: cuBLAS picks its gemm algorithm
// (split-K, tile) by shape, and torch's reductions split by the number of
// outputs, so x @ c^T may change its last bits with the bucket. A torch
// path would also have to materialize the dequantized coefficients, where
// the quantized tier's point is 1-byte coefficients read by the kernel.
//
// The order of one output, which depends on neither B nor K nor the tile:
// partial l (l = 0..31) adds the products of columns j = l, l + 32,
// l + 64, ... in that order, each product and each sum rounded on its own
// (__fmul_rn / __fadd_rn, __dmul_rn / __dadd_rn: the compiler cannot
// contract them into FMAs); then a fixed xor-shuffle tree over offsets 16,
// 8, 4, 2, 1; then the intercept. Lane l of a warp holds partial l. The
// plain twin (ops/kernels.py, serving_margins_plain) runs the same
// sequence with elementwise torch ops and gives the same bits on the CPU
// and on the card.
//
// Layout (the Hopper design): two layouts, picked a launch on the host
// by a rule (tile_plan; from Python kernels.serving_margins_plan).
//
// The staged tiles (serving_margins_kernel, plain coefficients). The
// flattened K * Km margin rows and the B request rows are cut into
// tiles. A CTA of WR x WM warps (8 at most) takes R = WR * RW request
// rows and M = WM * MW margin rows; warp (wr, wm) takes RW rows and MW
// margins of them, so that lane l keeps RW x MW accumulators (1 x 1, or
// 2 x MW with MW = 2, 4 or 5). The CTA stages its rows of X and its
// coefficient rows through shared memory: one cp.async.bulk a row
// segment, issued by the lanes of warp 0 onto the stage's mbarrier
// (complete_tx), waited on by parity. Where the tile's whole width fits
// a CTA's budget (110 KB, two CTAs an SM) it is one stage, every byte
// asked for at once and waited for once; past that a double buffer of
// two stages of as many columns as fit, a stage refilled once every warp
// is done with it. Each x[r, j] a lane reads from shared memory feeds MW
// products, each c[m, j] RW products; X is read from device memory once a
// margin tile and the coefficients once a row tile, where the
// one-warp-an-output layout reads X K * Km times and the coefficients B
// times through L1/L2. A bulk copy needs 16-byte aligned ends, and a row
// of a ragged width is not: each row segment is copied from the 16-byte
// boundary below its first element to the one above its last (never past
// the 16-byte block that holds a valid byte, so never past the
// allocation's page) and read from its element offset.
//
// The direct layout (serving_direct_kernel, the first design): one warp an
// output, its lanes reading the two rows straight from device memory as
// they sum them, e4m3 codes converted as they are read. It serves where
// the staged tiles measured slower: e4m3 codes, and launches of more
// than d / 4 outputs (float32) or d / 2 (float64) below the largest
// buckets of wide gangs (tile_plan gives the rule).
//
// Bound: bytes at large buckets, launch latency at small ones. The
// CIFAR-10 gang (10 x 3,072 f32) at bucket 1,024 reads 12.6 MB of X and
// 123 KB of coefficients, 3.8 us at an H100 SXM's 3.35 TB/s (data sheet);
// its 31.5M products are 63M separately rounded operations, 1.9 us at
// 33.5 T instructions/s. At the default bucket 64 the bytes take a tenth
// of a microsecond and the launch sets the time. The dispatch is one CUDA
// graph a bucket (serving/batcher.py): the copy of the pinned request rows
// to the device, this kernel and the copy of the margins back to pinned
// memory, captured once at registration and replayed a batch. So the
// entry takes the stream, synchronizes nothing and allocates nothing; the
// instances' shared-memory limits and the SM count are read once, at the
// first (eager) call, before any capture.
//
// Plain C interface (loaded with ctypes): the entry returns a cudaError_t,
// 0 on success.

#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxWarps = 8;             // warps of a CTA at most
constexpr int kSmemBudget = 110 * 1024;  // a CTA's stages: two CTAs an SM
constexpr int kSmemMax = 227 * 1024;     // the limit every instance allows

__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::
                   "r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// `bytes` (a multiple of 16) from 16-byte aligned global `src` to 16-byte
// aligned shared `dst`, completing on `bar`'s transaction count
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// the 16-byte aligned span that holds `n` bytes from `src`: its start and
// its length
__device__ __forceinline__ uint32_t span16(const char* src, uint32_t n,
                                           const char** start) {
  const uint64_t a = reinterpret_cast<uint64_t>(src);
  const uint64_t lo = a & ~uint64_t(15);
  const uint64_t hi = (a + n + 15) & ~uint64_t(15);
  *start = reinterpret_cast<const char*>(lo);
  return static_cast<uint32_t>(hi - lo);
}

// a launch's layout: the direct one, or a staged CTA's runtime tile:
// warps along rows and margins, rows and margins a warp, the columns of a
// chunk and the chunks in flight
struct Plan {
  bool direct;  // the one-warp-an-output layout (serving_direct_kernel)
  int wr, wm, rw, mw, cw, stages;
  int r() const { return wr * rw; }
  int m() const { return wm * mw; }
};

// a staged row of `cw` columns: its bytes and 16 more for a ragged row's
// start inside its 16-byte span (cw is a multiple of 32); a stage holds R
// X rows, then M coefficient rows
template <typename T>
__host__ __device__ int row_bytes(int cw) {
  return cw * (int)sizeof(T) + 16;
}

// coef is untyped, as the bulk copies read it: typed const T* __restrict__,
// ptxas interleaved the column loop's shared-memory loads with its chain of
// sums, 0.2-0.7 us slower a launch at the small buckets of float32 lanes
// on an H100 (serving_phases.py), the same bits
template <typename T, int RW, int MW>
__global__ void __launch_bounds__(kMaxWarps * 32)
serving_margins_kernel(const T* __restrict__ x, const void* __restrict__ coef,
                       const T* __restrict__ icpt, int b, int km, int mt,
                       int d, int wm, int cw, int stages,
                       T* __restrict__ out) {
  const int row = row_bytes<T>(cw);
  extern __shared__ __align__(16) uint8_t smem[];
  const int nwarps = blockDim.x / 32;
  const int R = (nwarps / wm) * RW, M = wm * MW;
  const int stage_bytes = (R + M) * row;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + stages * stage_bytes);
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const int wr = warp / wm, wmi = warp % wm;
  const int g0 = blockIdx.x * M;       // first margin row of the tile
  const int r0 = blockIdx.y * R;       // first request row of the tile
  const int nm = min(M, mt - g0);
  const int nr = min(R, b - r0);
  const int chunks = (d + cw - 1) / cw;
  const char* xb = reinterpret_cast<const char*>(x);
  const char* cb = reinterpret_cast<const char*>(coef);

  // warp 0 copies the chunk's staged rows, a row a lane: X rows first,
  // then coefficient rows; lane 0 arms the barrier with their bytes first
  auto issue = [&](int ch) {
    const int j0 = ch * cw;
    const int n = min(cw, d - j0);
    uint8_t* st = smem + (ch % stages) * stage_bytes;
    uint64_t* bar = &full[ch % stages];
    uint32_t mine = 0;
    for (int i = lane; i < nr + nm; i += 32) {
      const char* src;
      mine += i < nr
          ? span16(xb + ((long long)(r0 + i) * d + j0) * sizeof(T),
                   n * sizeof(T), &src)
          : span16(cb + ((long long)(g0 + i - nr) * d + j0) * sizeof(T),
                   n * sizeof(T), &src);
    }
    const uint32_t total = __reduce_add_sync(0xffffffffu, mine);
    if (lane == 0) mbar_expect(bar, total);
    __syncwarp();
    for (int i = lane; i < nr + nm; i += 32) {
      const char* src;
      if (i < nr) {
        const uint32_t bytes = span16(
            xb + ((long long)(r0 + i) * d + j0) * sizeof(T), n * sizeof(T),
            &src);
        bulk_copy(st + i * row, src, bytes, bar);
      } else {
        const int m = i - nr;
        const uint32_t bytes = span16(
            cb + ((long long)(g0 + m) * d + j0) * sizeof(T), n * sizeof(T),
            &src);
        bulk_copy(st + (R + m) * row, src, bytes, bar);
      }
    }
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) mbar_init(&full[s]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (warp == 0)
    for (int ch = 0; ch < stages && ch < chunks; ++ch) issue(ch);

  // a warp whose rows or margins all lie past the tile computes nothing
  const bool live = wr * RW < nr && wmi * MW < nm;
  T acc[RW][MW];
#pragma unroll
  for (int i = 0; i < RW; ++i)
#pragma unroll
    for (int m = 0; m < MW; ++m) acc[i][m] = T(0);

  for (int ch = 0; ch < chunks; ++ch) {
    const int j0 = ch * cw;
    const int n = min(cw, d - j0);
    uint8_t* st = smem + (ch % stages) * stage_bytes;
    mbar_wait(&full[ch % stages], (ch / stages) & 1);
    if (live) {
      // where each staged row's first element sits in its span
      const T* xs[RW];
#pragma unroll
      for (int i = 0; i < RW; ++i) {
        const int r = min(wr * RW + i, nr - 1);
        const uint64_t a = reinterpret_cast<uint64_t>(
            xb + ((long long)(r0 + r) * d + j0) * sizeof(T));
        xs[i] = reinterpret_cast<const T*>(st + r * row + (a & 15));
      }
      const T* cs[MW];
#pragma unroll
      for (int j = 0; j < MW; ++j) {
        const int m = min(wmi * MW + j, nm - 1);
        const uint64_t a = reinterpret_cast<uint64_t>(
            cb + ((long long)(g0 + m) * d + j0) * sizeof(T));
        cs[j] = reinterpret_cast<const T*>(st + (R + m) * row + (a & 15));
      }
      // lane l: columns l, l + 32, ... of the chunk, in order, for every
      // (row, margin) of the warp (a row or margin past the tile repeats
      // the last one, and nobody stores it)
#pragma unroll 4
      for (int c = lane; c < n; c += 32) {
        T xv[RW], cv[MW];
#pragma unroll
        for (int i = 0; i < RW; ++i) xv[i] = xs[i][c];
#pragma unroll
        for (int j = 0; j < MW; ++j) cv[j] = cs[j][c];
#pragma unroll
        for (int i = 0; i < RW; ++i)
#pragma unroll
          for (int j = 0; j < MW; ++j)
            acc[i][j] = add_rn(acc[i][j], mul_rn(xv[i], cv[j]));
      }
    }
    if (ch + stages < chunks) {
      __syncthreads();  // every warp is done with this stage
      if (warp == 0) issue(ch + stages);
    }
  }
  if (!live) return;

  // the xor tree of each output (every lane ends with the total), then
  // the intercept; lane o % 32 stores output o of the warp
#pragma unroll
  for (int i = 0; i < RW; ++i) {
#pragma unroll
    for (int j = 0; j < MW; ++j) {
      T v = acc[i][j];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        v = add_rn(v, __shfl_xor_sync(0xffffffffu, v, off));
      const int r = wr * RW + i, m = wmi * MW + j;
      if (lane == (i * MW + j) % 32 && r < nr && m < nm) {
        const int g = g0 + m;
        out[((long long)(g / km) * b + r0 + r) * km + g % km] =
            add_rn(v, icpt[g]);
      }
    }
  }
}

// The direct layout: one warp an output (model row, request row), each
// lane reading its columns of the two rows straight from device memory
// (through L1) as it sums them, e4m3 codes converted as they are read.
// No staging and no barrier: where the tiles would stage more bytes than
// they reuse (mid buckets of small gangs, every e4m3 lane) this streams
// them with the least latency. The same summation order.
constexpr int kDirectWarps = 4;

template <typename T, bool Q>
__device__ __forceinline__ T coef_at(const void* row, int j, T scale) {
  if constexpr (Q) {
    const __nv_fp8_e4m3 code = static_cast<const __nv_fp8_e4m3*>(row)[j];
    return mul_rn(static_cast<T>(static_cast<float>(code)), scale);
  } else {
    return static_cast<const T*>(row)[j];
  }
}

template <typename T, bool Q>
__global__ void __launch_bounds__(kDirectWarps * 32)
serving_direct_kernel(const T* __restrict__ x, const void* __restrict__ coef,
                      const T* __restrict__ scale,
                      const T* __restrict__ icpt, int b, int km, int d,
                      long long warps, T* __restrict__ out) {
  // out is (K, B, Km): warp w is (model, row, margin) in that order, so a
  // lane-0 store lands at out[w]
  const long long w = (long long)blockIdx.x * kDirectWarps + threadIdx.x / 32;
  if (w >= warps) return;  // a whole warp leaves together
  const int lane = threadIdx.x & 31;
  const int m = (int)(w % km);
  const long long rest = w / km;
  const int row = (int)(rest % b);
  const long long crow = (rest / b) * km + m;  // model * Km + margin
  const T* xr = x + (long long)row * d;
  const size_t elem = Q ? 1 : sizeof(T);
  const void* cr = static_cast<const char*>(coef) + crow * d * elem;
  const T s = Q ? scale[crow] : T(1);
  T acc = T(0);
  for (int j = lane; j < d; j += 32)
    acc = add_rn(acc, mul_rn(xr[j], coef_at<T, Q>(cr, j, s)));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc = add_rn(acc, __shfl_xor_sync(0xffffffffu, acc, off));
  if (lane == 0) out[w] = add_rn(acc, icpt[crow]);
}

int g_sms = 132;  // the card's SMs, read once (allow_all)

// the layout of a launch, by both layouts' times on an H100
// (serving_phases.py --variants): e4m3 codes take the direct one
// (converting a stage's codes in shared memory was slower at every
// bucket); plain coefficients the staged tiles while the launch has at
// most d / 4 outputs in float32, d / 2 in float64 (b K Km: a few long
// rows, whose chain of column steps the staging overlaps; the direct
// layout's float64 chain takes 4.5 us from bucket 1), or at the largest
// buckets of wide gangs (b >= 1,024 and K Km d at least 64 KB of
// coefficients: X read once for many margins), the direct layout
// between.
//
// The staged tile, by a rule (serving_phases.py prints it a bucket): one
// output a warp (1 x 1) while the launch's outputs fit one wave of 8-warp
// CTAs, else 2 x MW (MW the first of 5, 4, 2 that divides K Km; 1 x 1 if
// none does); then, while the CTAs outnumber the SMs, warps are added
// along rows and margins in turn (8 a CTA at most; an axis the launch has
// no more of is skipped, and a 1 x 1 tile grows only while its whole
// width fits one stage); the whole width in one stage where it fits the
// budget, else a double buffer of as many columns as fit.
template <typename T>
Plan tile_plan(bool quantized, int b, int mt, int d) {
  Plan p{};
  p.direct = quantized ||
             ((long long)b * mt * (16 / sizeof(T)) > d &&
              !(b >= 1024 && (long long)mt * d * sizeof(T) >= 65536));
  if (p.direct) return p;
  const int mw = mt % 5 == 0 ? 5 : mt % 4 == 0 ? 4 : mt % 2 == 0 ? 2 : 1;
  const bool wide = mw > 1 && (long long)b * mt > 8LL * g_sms;
  p.rw = wide ? 2 : 1;
  p.mw = wide ? mw : 1;
  p.wr = p.wm = 1;
  const int whole = (d + 31) / 32 * 32;
  auto fits = [&](int rows) {  // rows staged at the whole width
    return rows * row_bytes<T>(whole) + 8 <= kSmemBudget;
  };
  auto ctas = [&] {
    return (long long)((mt + p.m() - 1) / p.m()) * ((b + p.r() - 1) / p.r());
  };
  for (bool rows = true; ctas() > g_sms && p.wr * p.wm < kMaxWarps;
       rows = !rows) {
    const bool more_r = p.r() < b && (wide || fits(2 * p.r() + p.m()));
    const bool more_m = p.m() < mt && (wide || fits(p.r() + 2 * p.m()));
    if (!more_r && !more_m) break;
    if (more_r && (rows || !more_m))
      p.wr *= 2;
    else
      p.wm *= 2;
  }
  p.stages = fits(p.r() + p.m()) ? 1 : 2;
  // two stages of at most 42 rows (8 warps of 1 x 5) hold 160 columns
  p.cw = p.stages == 1 ? whole
                       : ((kSmemBudget - 16) / 2 / (p.r() + p.m()) - 16) /
                             (int)sizeof(T) / 32 * 32;
  return p;
}

template <typename T, int RW, int MW>
cudaError_t launch_tile(const Plan& p, const void* x, const void* coef,
                        const void* icpt, int b, int km, int mt, int d,
                        void* out, cudaStream_t stream) {
  const dim3 grid((mt + p.m() - 1) / p.m(), (b + p.r() - 1) / p.r());
  const int smem =
      p.stages * (p.r() + p.m()) * row_bytes<T>(p.cw) + 8 * p.stages;
  serving_margins_kernel<T, RW, MW>
      <<<grid, 32 * p.wr * p.wm, smem, stream>>>(
          static_cast<const T*>(x), coef,
          static_cast<const T*>(icpt), b, km, mt, d, p.wm, p.cw, p.stages,
          static_cast<T*>(out));
  return cudaGetLastError();
}

template <typename T, bool Q>
cudaError_t launch_direct(const void* x, const void* coef, const void* scale,
                          const void* icpt, int b, int km, int mt, int d,
                          void* out, cudaStream_t stream) {
  const long long warps = (long long)mt * b;
  const long long blocks = (warps + kDirectWarps - 1) / kDirectWarps;
  serving_direct_kernel<T, Q><<<(unsigned)blocks, kDirectWarps * 32, 0,
                                stream>>>(
      static_cast<const T*>(x), coef, static_cast<const T*>(scale),
      static_cast<const T*>(icpt), b, km, d, warps, static_cast<T*>(out));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(bool quantized, const void* x, const void* coef,
                   const void* scale, const void* icpt, int b, int km,
                   int mt, int d, void* out, cudaStream_t s) {
  if (quantized)
    return launch_direct<T, true>(x, coef, scale, icpt, b, km, mt, d, out,
                                  s);
  const Plan p = tile_plan<T>(false, b, mt, d);
  if (p.direct)
    return launch_direct<T, false>(x, coef, scale, icpt, b, km, mt, d, out,
                                   s);
  switch (p.rw * 10 + p.mw) {
    case 22: return launch_tile<T, 2, 2>(p, x, coef, icpt, b, km, mt, d, out, s);
    case 24: return launch_tile<T, 2, 4>(p, x, coef, icpt, b, km, mt, d, out, s);
    case 25: return launch_tile<T, 2, 5>(p, x, coef, icpt, b, km, mt, d, out, s);
    default: return launch_tile<T, 1, 1>(p, x, coef, icpt, b, km, mt, d, out, s);
  }
}

template <typename T, int RW, int MW>
cudaError_t allow_tile() {
  return cudaFuncSetAttribute(serving_margins_kernel<T, RW, MW>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              kSmemMax);
}

// every instance's shared-memory limit and the card's SM count, once
cudaError_t allow_all() {
  cudaError_t e = cudaSuccess, f;
  int dev = 0;
  if ((f = cudaGetDevice(&dev)) != cudaSuccess) return f;
  if ((f = cudaDeviceGetAttribute(&g_sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess)
    return f;
  const cudaError_t each[] = {
      allow_tile<float, 1, 1>(),  allow_tile<float, 2, 2>(),
      allow_tile<float, 2, 4>(),  allow_tile<float, 2, 5>(),
      allow_tile<double, 1, 1>(), allow_tile<double, 2, 2>(),
      allow_tile<double, 2, 4>(), allow_tile<double, 2, 5>()};
  for (const cudaError_t g : each)
    if (g != cudaSuccess) e = g;
  return e;
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 float64 (x, scale, icpt and out); quantized: coef is
// e4m3 codes (K, Km, d) with scale (K, Km), else coef is (K, Km, d) in the
// dtype and scale is unused. x: (B, d) and out: (K, B, Km) on the device.
// The launch is enqueued on `stream`; nothing synchronizes.
int serving_margins_launch(int dtype, int quantized, const void* x,
                           const void* coef, const void* scale,
                           const void* icpt, int k, int b, int km, int d,
                           void* out, void* stream) {
  if (k < 1 || b < 1 || km < 1 || d < 1 || dtype < 0 || dtype > 1)
    return (int)cudaErrorInvalidValue;
  static const cudaError_t allowed = allow_all();  // once, thread-safe
  if (allowed != cudaSuccess) return (int)allowed;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int mt = k * km;
  return (int)(dtype == 0 ? launch<float>(quantized, x, coef, scale, icpt,
                                          b, km, mt, d, out, s)
                          : launch<double>(quantized, x, coef, scale, icpt,
                                           b, km, mt, d, out, s));
}

// the tile a launch of (dtype, quantized) takes for b rows, mt margin rows
// and d columns: plan[0..4] = warps along rows, warps along margins, rows
// and margins a warp, stages in flight; plan[5] = the CTAs; plan[6] = the
// columns of a chunk; plan[7] = 1 for the direct layout (plan[0..4] and
// plan[6] are then 0)
int serving_margins_plan(int dtype, int quantized, int b, int mt, int d,
                         int* plan) {
  if (b < 1 || mt < 1 || d < 1 || dtype < 0 || dtype > 1)
    return (int)cudaErrorInvalidValue;
  static const cudaError_t allowed = allow_all();
  if (allowed != cudaSuccess) return (int)allowed;
  const Plan p = dtype == 0 ? tile_plan<float>(quantized, b, mt, d)
                            : tile_plan<double>(quantized, b, mt, d);
  plan[0] = p.wr;
  plan[1] = p.wm;
  plan[2] = p.rw;
  plan[3] = p.mw;
  plan[4] = p.stages;
  plan[5] = p.direct ? (mt * b + kDirectWarps - 1) / kDirectWarps
                     : ((mt + p.m() - 1) / p.m()) * ((b + p.r() - 1) / p.r());
  plan[6] = p.cw;
  plan[7] = p.direct;
  return 0;
}

}  // extern "C"
