// Hopper (sm_90a) building blocks shared by the port's kernels
// (gramian.cu, kmeans_assign.cu, glm_stacked.cu, glm_sweep.cu):
// shared-memory matrix descriptors for wgmma, the bf16 m64n128k16 product
// with float32 sums, the fences around it, and cp.async copies of 16, 8
// and 4 bytes into shared memory.
//
// Layout. Every wgmma operand here lives in shared memory in the 128-byte
// swizzled layout (the one TMA's SWIZZLE_128B writes): a region of rows of
// 128 bytes (64 bf16 values), 1024-byte aligned, where the 16-byte chunk j
// of row r is stored at chunk j ^ (r % 8) of that row (sw128 below). For a
// K-major operand a row is one row of the matrix (M or N) and holds 64
// values of K; for an MN-major operand a row is one k and holds 64 values
// of M or N.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <stdint.h>

namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of 16-byte chunk `chunk` (0..7) of row `row` in a region
__device__ __forceinline__ uint32_t sw128(int row, int chunk) {
  return (uint32_t)(row * 128 + ((chunk ^ (row & 7)) << 4));
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// byte offset (LBO) and stride byte offset (SBO), each in 16-byte units.
// K-major: SBO = the step between groups of 8 rows (1024), LBO unused (1).
// MN-major: SBO = the step between groups of 8 k (1024), LBO = the step
// between 64-wide blocks of M or N.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  uint64_t d = 0;
  d |= (uint64_t)((addr & 0x3FFFF) >> 4);
  d |= (uint64_t)((lbo >> 4) & 0x3FFF) << 16;
  d |= (uint64_t)((sbo >> 4) & 0x3FFF) << 32;
  d |= (uint64_t)1 << 62;  // SWIZZLE_128B
  return d;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving reads or writes of the accumulators
// across an asynchronous wgmma
__device__ __forceinline__ void fence_operand(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// makes this thread's ordinary shared-memory writes (st.shared, cp.async)
// visible to the async proxy that wgmma reads through
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// 16 bytes global -> shared; src_bytes = 0 fills the 16 bytes with zeros
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}
// 8 or 4 bytes global -> shared (the .cg form takes 16 bytes only, so
// these go through L1); src_bytes < the size fills the rest with zeros
__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// two e4m3 codes -> two bf16 values packed in 32 bits, exactly (every
// e4m3 value is a bf16 value): the hardware e4m3x2 -> f16x2 conversion,
// then f16 -> f32 -> bf16, neither of which rounds
__device__ __forceinline__ uint32_t e4m3x2_to_bf16x2(uint16_t two) {
  const __half2_raw h =
      __nv_cvt_fp8x2_to_halfraw2((__nv_fp8x2_storage_t)two, __NV_E4M3);
  const __half2 hh(h);
  const __nv_bfloat162 b = __floats2bfloat162_rn(__low2float(hh),
                                                 __high2float(hh));
  return *reinterpret_cast<const uint32_t*>(&b);
}

// dynamic shared memory rounded up to the 1024-byte alignment that the
// 128-byte swizzle needs (the launch asks for 1024 bytes more)
__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~(uintptr_t)1023);
}

// 8 consecutive elements of row r of a (., d) row-major X from column c0,
// as 8 bf16 values packed in 16 bytes, zeros past d or for a dead row.
// vec: d % 8 == 0 and X's base aligned, so the 8 elements are one 16-byte
// (bf16) or 8-byte (e4m3) load, all in the row or all past it.
__device__ __forceinline__ uint4 load8(const __nv_bfloat16* x, long long r,
                                       int c0, int d, bool live, bool vec) {
  const uint16_t* xr = reinterpret_cast<const uint16_t*>(x) + r * d;
  if (vec) {
    return (live && c0 < d) ? __ldg(reinterpret_cast<const uint4*>(xr + c0))
                            : make_uint4(0, 0, 0, 0);
  }
  uint16_t h[8];
#pragma unroll
  for (int e = 0; e < 8; ++e)
    h[e] = (live && c0 + e < d) ? __ldg(xr + c0 + e) : (uint16_t)0;
  return make_uint4(h[0] | (uint32_t)h[1] << 16, h[2] | (uint32_t)h[3] << 16,
                    h[4] | (uint32_t)h[5] << 16, h[6] | (uint32_t)h[7] << 16);
}

__device__ __forceinline__ uint4 load8(const __nv_fp8_e4m3* x, long long r,
                                       int c0, int d, bool live, bool vec) {
  const uint8_t* xr = reinterpret_cast<const uint8_t*>(x) + r * d;
  uint8_t b[8];
  if (vec) {
    uint2 v = make_uint2(0, 0);
    if (live && c0 < d) v = __ldg(reinterpret_cast<const uint2*>(xr + c0));
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      b[e] = (uint8_t)(v.x >> (8 * e));
      b[4 + e] = (uint8_t)(v.y >> (8 * e));
    }
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e)
      b[e] = (live && c0 + e < d) ? __ldg(xr + c0 + e) : (uint8_t)0;
  }
  uint32_t p[4];
#pragma unroll
  for (int e = 0; e < 4; ++e)
    p[e] = e4m3x2_to_bf16x2((uint16_t)(b[2 * e] | b[2 * e + 1] << 8));
  return make_uint4(p[0], p[1], p[2], p[3]);
}

// 16 bytes from registers into shared memory
__device__ __forceinline__ void st_shared16(uint32_t dst, uint4 v) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(dst),
               "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

// D (64 x 128, float32, in registers) += A (64 x 16) B (16 x 128), bf16
// operands in shared memory given by their descriptors; TA / TB = 1 for an
// MN-major (transposed) A / B. Asynchronous: fence before, commit and wait
// after.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, %68;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

}  // namespace hopper
