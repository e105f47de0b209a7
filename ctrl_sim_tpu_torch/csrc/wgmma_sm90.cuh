// Hopper's own building blocks (sm_90a) for the port's attention kernels:
// the training flash attention (flash_attention.cu) and the decode
// attention (decode_mma.cuh): the Tensor Memory Accelerator (TMA) with its
// tensor maps and mbarriers, warpgroup matrix multiply (wgmma) with its
// shared-memory descriptors, and setmaxnreg for warp specialisation.
//
// Tiles. Every bf16 tile is kTileRows rows (or a 16-row part of them) of
// one head's D bf16 columns of a row-major [B, n, H] tensor, copied by one
// TMA load into shared memory with the swizzle whose span is a row (D = 16,
// 32, 64: 32, 64, 128 bytes), so that row r's 16-byte chunk c lands at chunk
// c ^ f(r) of row r (swz below; a kernel that writes a tile itself writes
// it so). wgmma reads the same layout through a descriptor of the same
// swizzle: as a K-major operand (the head width is the reduction: Q and K
// in S = Q K^T) it steps 32 bytes along a row per 16-wide slice of D; as an
// MN-major operand (the rows are the reduction: V in O = P V, transposed by
// the instruction) it steps 16 rows per slice. Tiles are aligned to 1024
// bytes, the widest swizzle's period, so both agree on f(r). An int8 tile
// (the decode's int8 cache: several heads' columns a row) is swizzled by
// its own row's span, and threads widen it into bf16 tiles before wgmma
// reads them.
//
// Accumulators (m64nNk16, fp32). Warp w of the warpgroup holds rows 16 w
// + g and 16 w + g + 8 (g = lane / 4); d[j][0..1] are that thread's
// columns 8 j + 2 t, + 1 (t = lane % 4) of row 16 w + g, d[j][2..3] the same
// of row 16 w + g + 8: per warp, mma.sync's m16n8 C layout for each block of
// 8 columns. An A operand from registers has mma.sync's m16n8k16 A layout,
// so the scores of 16 columns, rounded to bf16, are the A operand of the
// next product without leaving registers.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sm90.cuh"

namespace {

constexpr int kTileRows = 64;  // rows of every TMA tile and wgmma M

template <int D>
__host__ __device__ constexpr int tile_bytes() {
  return kTileRows * D * 2;
}

// The physical 16-byte chunk of chunk u of row r of a swizzled tile of U
// chunks a row (U = D / 8 = 2, 4, 8): TMA's 32-, 64- or 128-byte swizzle.
template <int U>
__host__ __device__ constexpr int swz(int r, int u) {
  return u ^ ((r / (8 / U)) % U);
}

// ---------------------------------------------------------------------------
// mbarriers
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count) : "memory");
}

// makes the barriers' initialisation visible to the async proxy (TMA)
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// one arrival, and bytes that TMA loads must bring before the phase completes
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(bytes)
               : "memory");
}

// The barrier's phase also waits for every cp.async this thread issued so far.
__device__ __forceinline__ void mbar_track_cp_async(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.shared::cta.b64 [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Waits for the phase of the given parity to complete. A phase that never
// completes is a bug of the kernel: after about ten seconds the launch
// fails (trap) instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  if (mbar_try_wait(a, parity)) return;
  const long long start = clock64();
  while (!mbar_try_wait(a, parity))
    if (clock64() - start > 20000000000ll) __trap();
}

// ---------------------------------------------------------------------------
// TMA
// ---------------------------------------------------------------------------

// The box of the tensor behind map whose first element is (col, row, b)
// into dst (1024-byte aligned, or at a 16-row part of a tile), completing
// bytes on bar. Rows outside the tensor's [0, n) come in as zeros.
__device__ __forceinline__ void tma_load_tile(void* dst, const CUtensorMap* map, int col, int row, int b,
                                              uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5}], "
      "[%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(col), "r"(row), "r"(b)
      : "memory");
}

// Orders this thread's shared-memory writes before later reads of the async
// proxy (wgmma's operands, TMA): a tile written by threads and read by wgmma.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// bytes (a multiple of 16) from src to dst (both 16-byte aligned) by the
// TMA engine, completing on bar.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes), "r"(smem_addr(bar))
               : "memory");
}

// The threads of one warpgroup wait for each other (named barrier id, 1-15).
__device__ __forceinline__ void warpgroup_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}
// The same for `threads` threads (a multiple of 32).
__device__ __forceinline__ void threads_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void tma_prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled of libcuda, found through the runtime's entry-point
// query, so that the library needs no link against libcuda.
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                                             &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return (err == cudaSuccess && found == cudaDriverEntryPointSuccess) ? reinterpret_cast<EncodeTiledFn>(p)
                                                                         : nullptr;
  }();
  return fn;
}

// The tensor map of a bf16 [B, n, H] tensor at base (16-byte aligned, H a
// multiple of 8) whose box is `rows` rows (kTileRows, or 16) of D columns
// of one batch row, swizzled by the row's span (D = 16, 32, 64). The
// pointer changes with every call, so the map is encoded per call (a few
// microseconds of host time). Returns false if the encode fails.
template <int D>
bool encode_tile_map(CUtensorMap* map, const void* base, int B, int n, int H, int rows = kTileRows) {
  static_assert(D == 16 || D == 32 || D == 64, "the swizzle span is a row of 32, 64 or 128 bytes");
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)H, (cuuint64_t)n, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)H * 2, (cuuint64_t)n * H * 2};
  const cuuint32_t box[3] = {(cuuint32_t)D, (cuuint32_t)rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUtensorMapSwizzle swizzle = D == 64   ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : D == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                               : CU_TENSOR_MAP_SWIZZLE_32B;
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The tensor map of an int8 [B, n, H] tensor at base (16-byte aligned, H a
// multiple of 16) whose box is kTileRows rows of `cols` bytes (16, 32, 64
// or 128) of one batch row, swizzled by the row's span as the bf16 tiles
// are (swz<cols / 16>; 16-byte rows unswizzled). Rows past n come in as
// zeros.
inline bool encode_i8_tile_map(CUtensorMap* map, const void* base, int B, int n, int H, int cols) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)H, (cuuint64_t)n, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)H, (cuuint64_t)n * H};
  const cuuint32_t box[3] = {(cuuint32_t)cols, (cuuint32_t)kTileRows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUtensorMapSwizzle swizzle = cols == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : cols == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                     : cols == 32 ? CU_TENSOR_MAP_SWIZZLE_32B
                                                  : CU_TENSOR_MAP_SWIZZLE_NONE;
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, const_cast<void*>(base), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------

// The descriptor of a TMA tile of rows of D bf16 (layout: the swizzle of
// the row's span; stride between 8-row groups: 8 rows). Add kWgmmaKStep
// per 16 columns for a K-major operand, wgmma_row_step<D>() per 16 rows for
// an MN-major one.
template <int D>
__device__ __forceinline__ uint64_t wgmma_desc(const void* tile) {
  constexpr uint64_t layout = D == 64 ? 1 : D == 32 ? 2 : 3;  // 128-, 64-, 32-byte swizzle
  constexpr uint64_t group = (8 * 2 * D) >> 4;               // 8 rows, in 16-byte units
  return (uint64_t)((smem_addr(tile) & 0x3FFFF) >> 4) | (1ull << 16) | (group << 32) | (layout << 62);
}
constexpr uint64_t kWgmmaKStep = 32 >> 4;  // 16 bf16 columns of a K-major operand
template <int D>
__host__ __device__ constexpr uint64_t wgmma_row_step() {
  return (16 * 2 * D) >> 4;
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pins registers in place around the asynchronous products: ordinary code
// may not move their reads or writes across this point.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R][4]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[i][e])::"memory");
}
template <int R>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[R][4]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[i][e])::"memory");
}

// d (+)= A B^T for A a 64 x 16 K-major tile (descriptor a) and B an N x 16
// K-major tile (descriptor b); scale_d = 0 overwrites d.
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 8][4], uint64_t a, uint64_t b, int scale_d);

// d += A B for A 64 x 16 in registers and B a 16 x N MN-major tile
// (descriptor b, transposed by the instruction).
template <int N>
__device__ __forceinline__ void wgmma_rs_t(float (&d)[N / 8][4], const uint32_t (&a)[4], uint64_t b);

// d (+)= A B^T for A 64 x 16 in registers and B an N x 16 K-major tile
// (descriptor b); scale_d = 0 overwrites d.
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 8][4], const uint32_t (&a)[4], uint64_t b, int scale_d);

template <>
__device__ __forceinline__ void wgmma_rs<16>(float (&d)[2][4], const uint32_t (&a)[4], uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[4][4], const uint32_t (&a)[4], uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[8][4], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs_t<16>(float (&d)[2][4], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs_t<32>(float (&d)[4][4], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs_t<64>(float (&d)[8][4], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// The products of an attention kernel's consumer warpgroup (K3/K4's, K1/K2's).

// The consumer warps release a stage: each warp's reads of it are done
// (its products waited on), and its lane 0 arrives.
__device__ __forceinline__ void release(uint64_t* empty) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive(empty);
}

// The scores of 16 columns (two 8-column blocks of the accumulators) as
// the bf16 A operand of the next product.
__device__ __forceinline__ void a_frags(uint32_t (&a)[kTileRows / 16][4], const float (&s)[kTileRows / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < kTileRows / 16; ++kk) {
    a[kk][0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
    a[kk][1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
    a[kk][2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
    a[kk][3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
  }
}

// acc += A B for A the 64 x 64 operand in registers and B the 64-row tile
// (rows the reduction, transposed by the instruction); issued.
template <int D>
__device__ __forceinline__ void product_rs(float (&acc)[D / 8][4], uint32_t (&a)[kTileRows / 16][4], const void* tile) {
  const uint64_t desc = wgmma_desc<D>(tile);
#pragma unroll
  for (int kk = 0; kk < kTileRows / 16; ++kk) wgmma_rs_t<D>(acc, a[kk], desc + kk * wgmma_row_step<D>());
}

// s = A B^T over the head width, A and B 64-row tiles (K-major); issued.
template <int D>
__device__ __forceinline__ void product_ss(float (&s)[kTileRows / 8][4], const void* a, const void* b) {
  const uint64_t da = wgmma_desc<D>(a), db = wgmma_desc<D>(b);
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks)
    wgmma_ss<kTileRows>(s, da + ks * kWgmmaKStep, db + ks * kWgmmaKStep, ks > 0);
}

template <int R>
__device__ __forceinline__ void zero(float (&x)[R][4]) {
#pragma unroll
  for (int i = 0; i < R; ++i) x[i][0] = x[i][1] = x[i][2] = x[i][3] = 0.f;
}

// ---------------------------------------------------------------------------
// warp specialisation
// ---------------------------------------------------------------------------

// Sets the registers of each thread of the (whole, or lone-warp) warpgroup.
template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

}  // namespace
