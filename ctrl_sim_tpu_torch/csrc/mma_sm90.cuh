// The register-level helpers of the port's attention kernels on Hopper
// (sm_90a) that are not wgmma's own (wgmma_sm90.cuh): shared-memory
// addresses, 4-byte cp.async copies, exp2, bf16 packing, mma.sync m16n8k16
// and movmatrix (the int8 decode's P V at Q <= 16), fragment loads from
// device memory and row stores. Fragment layout (mma.sync's m16n8k16, and
// per warp wgmma's m64nN): thread (g = lane / 4, t = lane % 4) holds rows g
// and g + 8, columns 2t and 2t + 1 of each 8-wide block of the C (and A)
// operands.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 4 bytes from src to shared dst; zeros where !pred (src is then not read)
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(pred ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// d += a b for a 16 x 16 bf16 A fragment and a 16 x 8 bf16 B fragment (b0, b1)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The transpose of an 8 x 8 bf16 matrix held by the warp in the C layout
// (thread g, t: row g, columns 2t, 2t + 1): thread g, t then holds row g of
// the transpose, that is column g, rows 2t and 2t + 1 of the original.
__device__ __forceinline__ uint32_t movmatrix_t(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(y) : "r"(x));
  return y;
}

__device__ __forceinline__ uint32_t ldg_u32(const __nv_bfloat16* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}

// The A fragments of rows [r0, r0 + 16) x D of a row-major bf16 matrix with
// row stride H, straight from device memory; rows >= n are zeros. Thread
// (g = lane / 4, t = lane % 4) holds rows g and g + 8, columns 2t, 2t + 1
// and 2t + 8, 2t + 9 of each 16-wide step.
template <int KS>
__device__ __forceinline__ void load_a_frags(uint32_t (&a)[KS][4], const __nv_bfloat16* __restrict__ x,
                                             int r0, int n, int H, int g, int t) {
  const int ra = r0 + g, rb = ra + 8;
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const int c = 16 * ks + 2 * t;
    a[ks][0] = ra < n ? ldg_u32(x + (size_t)ra * H + c) : 0u;
    a[ks][1] = rb < n ? ldg_u32(x + (size_t)rb * H + c) : 0u;
    a[ks][2] = ra < n ? ldg_u32(x + (size_t)ra * H + c + 8) : 0u;
    a[ks][3] = rb < n ? ldg_u32(x + (size_t)rb * H + c + 8) : 0u;
  }
}

// Writes rows (g, g + 8) of a warp's 16 x D fp32 accumulators, times mul, as bf16.
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* __restrict__ x, const float (&acc)[D / 8][4],
                                           const int (&row)[2], const float (&mul)[2], int n, int H, int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= n) continue;
    __nv_bfloat16* p = x + (size_t)row[r] * H + 2 * t;
#pragma unroll
    for (int db = 0; db < D / 8; ++db)
      *reinterpret_cast<__nv_bfloat162*>(p + 8 * db) =
          __floats2bfloat162_rn(acc[db][2 * r] * mul[r], acc[db][2 * r + 1] * mul[r]);
  }
}

}  // namespace
