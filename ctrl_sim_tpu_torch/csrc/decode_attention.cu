// Masked multi-head decode attention over the streaming rollout's KV ring
// cache, for Hopper (sm_90a). Built by ctrl_sim_tpu_torch/ops/build.py with
// nvcc into a shared library with a plain C interface, loaded with ctypes.
//
// Replaces the TPU kernel ctrl_sim_tpu/ops/attention.py:_attn_body (reached
// through cached_decode_attention -> _decode_kernel -> pl.pallas_call).
//
// What it computes, per lane b and head h (d = H / num_heads):
//   out[b, i, h*d:(h+1)*d] = softmax_j(q'[b, i] . k[b, j] + bias[i, j]) v[b, j]
// with q' = q * log2(e) / sqrt(d) (pre-scaled by the wrapper, as the JAX
// wrapper does), the softmax taken in base 2, bias = 0 where mask[i, j] != 0
// and -1e30 where it is 0. One [Q, N] int8 mask is shared by the batch. A
// fully masked row comes out as the uniform average of V: finite, unused.
//
// What bounds it: one read of K and V. At the bench shape (B = 256 lanes,
// N = 32 steps * 3 token types * 16 slots = 1536 keys, H = 256, bf16) that is
// 2 * B * N * H * 2 = 402,653,184 bytes per launch (0.12 ms at 3.35 TB/s),
// against 4 * B * Q * N * H = 12.9 GFLOP (Q = 32), 0.013 ms at the bf16
// tensor-core rate: the work is memory-bound.
//
// bf16: tensor cores (decode_attention_wgmma_kernel<D, G>), the body in
// decode_mma.cuh, shared with K2: a persistent grid of warp-specialised
// blocks, each item one lane, G heads and all its query rows (Q <= 64), the
// 64-key chunks of K and V streamed by TMA through an mbarrier ring, S =
// Q K^T and O += P V on wgmma; its design notes are there.
//
// f32: CUDA cores (decode_attention_kernel<D>), kept for the 1e-4 agreement
// of the f32 path, which TF32 tensor cores cannot hold:
// - one block per (lane b, head h, tile of 32 query rows); 4 warps, each warp
//   owns 8 query rows, so K/V of one (b, h) are read once per 32 queries;
// - K/V tiles of 32 keys x d are staged through shared memory; the next
//   tile's K, V (16-byte loads) and mask bytes are loaded into registers
//   while the current tile is computed, so device-memory latency overlaps
//   the arithmetic (waiting for each tile makes the kernel latency-bound);
// - each lane owns one key of the tile for the scores, and output dims
//   lane, lane + 32 for the weighted sum; both loops are register-blocked
//   over the warp's 8 rows so each shared-memory load feeds 8 FMAs;
// - an online exp2 softmax in fp32 registers: the running max is
//   warp-uniform, the running denominator stays per lane and is summed once
//   at the end; the denominator divides the [Q, d] output.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "decode_mma.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 8;
constexpr int kQTile = kWarps * kRowsPerWarp;  // query rows per block
constexpr int kKTile = 32;                     // keys per tile: one per lane
constexpr float kMaskNeg = -1e30f;             // exp2 of (x - 1e30 - m) is 0

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const int8_t* __restrict__ mask,
                        float* __restrict__ out, int Q, int N, int H, int num_heads) {
  constexpr int DK = D + 4;  // padded K rows: float4 reads across lanes hit distinct banks
  constexpr int DCH = (D + 31) / 32;
  constexpr int kElems = 4;                    // elements per 16-byte load
  constexpr int kVecRow = D / kElems;          // 16-byte loads per key row
  constexpr int kVecTile = kKTile * kVecRow;   // per tile, for K and for V
  constexpr int kVecThread = (kVecTile + kThreads - 1) / kThreads;
  __shared__ __align__(16) float qs[kQTile][D];
  __shared__ __align__(16) float ks[kKTile][DK];
  __shared__ __align__(16) float vs[kKTile][D];
  __shared__ __align__(16) float ps[kWarps][kRowsPerWarp][kKTile];

  const int b = blockIdx.x / num_heads;
  const int h = blockIdx.x % num_heads;
  const int q0 = blockIdx.y * kQTile;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row0 = warp * kRowsPerWarp;

  const size_t head = (size_t)h * D;
  const float* qb = q + (size_t)b * Q * H + head;
  const float* kb = k + (size_t)b * N * H + head;
  const float* vb = v + (size_t)b * N * H + head;
  const int ldm = N + (N & 1);  // the mask's row stride

  for (int i = threadIdx.x; i < kQTile * D; i += kThreads) {
    const int r = i / D, c = i % D;
    qs[r][c] = (q0 + r < Q) ? qb[(size_t)(q0 + r) * H + c] : 0.f;
  }

  // registers holding the next tile: K/V as raw 16-byte loads, and this
  // lane's mask byte per row (1 attend, 0 masked, -1 key past N)
  uint4 kreg[kVecThread], vreg[kVecThread];
  int8_t mreg[kRowsPerWarp];
  auto prefetch = [&](int n0) {
#pragma unroll
    for (int j = 0; j < kVecThread; ++j) {
      const int i = threadIdx.x + j * kThreads;
      const int n = n0 + i / kVecRow;
      const int c = (i % kVecRow) * kElems;
      kreg[j] = make_uint4(0, 0, 0, 0);
      vreg[j] = make_uint4(0, 0, 0, 0);
      if (i < kVecTile && n < N) {
        kreg[j] = __ldg(reinterpret_cast<const uint4*>(kb + (size_t)n * H + c));
        vreg[j] = __ldg(reinterpret_cast<const uint4*>(vb + (size_t)n * H + c));
      }
    }
    const int n = n0 + lane;
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int qi = q0 + row0 + r;
      mreg[r] = n >= N ? int8_t(-1) : (qi >= Q ? int8_t(1) : (mask[(size_t)qi * ldm + n] != 0 ? int8_t(1) : int8_t(0)));
    }
  };

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][DCH];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < DCH; ++c) acc[r][c] = 0.f;
  }

  prefetch(0);
  for (int n0 = 0; n0 < N; n0 += kKTile) {
    __syncthreads();  // the previous tile is consumed (and qs is written)
#pragma unroll
    for (int j = 0; j < kVecThread; ++j) {
      const int i = threadIdx.x + j * kThreads;
      if (i < kVecTile) {
        const int r = i / kVecRow, c = (i % kVecRow) * kElems;
        *reinterpret_cast<uint4*>(&ks[r][c]) = kreg[j];
        *reinterpret_cast<uint4*>(&vs[r][c]) = vreg[j];
      }
    }
    int8_t mcur[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) mcur[r] = mreg[r];
    __syncthreads();
    if (n0 + kKTile < N) prefetch(n0 + kKTile);  // in flight during the compute below

    // scores of this lane's key against the warp's rows
    float s[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) s[r] = 0.f;
#pragma unroll
    for (int c = 0; c < D; c += 4) {
      const float4 kk = *reinterpret_cast<const float4*>(&ks[lane][c]);
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float4 qq = *reinterpret_cast<const float4*>(&qs[row0 + r][c]);
        s[r] += qq.x * kk.x + qq.y * kk.y + qq.z * kk.z + qq.w * kk.w;
      }
    }

    // online softmax update, one row at a time
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      // keys past N take no weight at all; masked keys take the -1e30 bias
      const float sr = mcur[r] < 0 ? -INFINITY : (mcur[r] ? s[r] : s[r] + kMaskNeg);
      const float m_new = fmaxf(m[r], warp_max(sr));
      const float alpha = exp2f(m[r] - m_new);
      const float p = exp2f(sr - m_new);
      l[r] = l[r] * alpha + p;
#pragma unroll
      for (int c = 0; c < DCH; ++c) acc[r][c] *= alpha;
      m[r] = m_new;
      ps[warp][r][lane] = p;
    }
    __syncwarp();

    // weighted sum: this lane's output dims over the tile's keys
#pragma unroll
    for (int j = 0; j < kKTile; j += 4) {
      float vv[4][DCH];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int c = 0; c < DCH; ++c) {
          const int o = lane + 32 * c;
          vv[jj][c] = (o < D) ? vs[j + jj][o] : 0.f;
        }
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float4 pp = *reinterpret_cast<const float4*>(&ps[warp][r][j]);
#pragma unroll
        for (int c = 0; c < DCH; ++c)
          acc[r][c] += pp.x * vv[0][c] + pp.y * vv[1][c] + pp.z * vv[2][c] + pp.w * vv[3][c];
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const float denom = warp_sum(l[r]);
    const int qi = q0 + row0 + r;
    if (qi >= Q) continue;
    float* ob = out + ((size_t)b * Q + qi) * H + head;
#pragma unroll
    for (int c = 0; c < DCH; ++c) {
      const int o = lane + 32 * c;
      if (o < D) ob[o] = acc[r][c] / denom;
    }
  }
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, const void* mask, void* out,
                       int B, int Q, int N, int H, int num_heads, cudaStream_t stream) {
  const dim3 grid(B * num_heads, (Q + kQTile - 1) / kQTile);
  decode_attention_kernel<D><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const int8_t*>(mask), static_cast<float*>(out), Q, N, H, num_heads);
  return cudaGetLastError();
}

template <int D, int G>
__global__ void __launch_bounds__(dec_threads(G), dec_min_blocks(G))
decode_attention_wgmma_kernel(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
                              const __grid_constant__ CUtensorMap v_map, const DecodeArgs a) {
  decode_attention_ws<D, G, false, kDecRows>(&q_map, &k_map, &v_map, a);
}

template <int D, int G>
cudaError_t launch_bf16_heads(const DecodeArgs& a, cudaStream_t stream) {
  CUtensorMap qm, km, vm;  // Q in 16-row parts (rotated per head), K and V in 64-key chunks
  if (!encode_tile_map<D>(&qm, a.q, a.B, a.Q, a.H, 16) || !encode_tile_map<D>(&km, a.k, a.B, a.N, a.H) ||
      !encode_tile_map<D>(&vm, a.v, a.B, a.N, a.H))
    return cudaErrorInvalidValue;
  return launch_decode<D, G, false, kDecRows>(decode_attention_wgmma_kernel<D, G>, qm, km, vm, a, stream);
}

// G heads a block, as dec_heads chooses
template <int D>
cudaError_t launch_bf16(const DecodeArgs& a, cudaStream_t stream) {
  const int G = dec_heads(D, a.heads);
  if constexpr (dec_max_heads(D) == 4)
    if (G == 4) return launch_bf16_heads<D, 4>(a, stream);
  return G == 2 ? launch_bf16_heads<D, 2>(a, stream) : launch_bf16_heads<D, 1>(a, stream);
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* mask, void* out, int B,
                   int Q, int N, int H, int num_heads, int is_bf16, cudaStream_t stream) {
  if (!is_bf16) return launch_f32<D>(q, k, v, mask, out, B, Q, N, H, num_heads, stream);
  const DecodeArgs a{static_cast<const __nv_bfloat16*>(q), k, v, nullptr, nullptr,
                     static_cast<const int8_t*>(mask), static_cast<__nv_bfloat16*>(out), B, Q, N, H, num_heads};
  return launch_bf16<D>(a, stream);
}

}  // namespace

// q [B, Q, H] (pre-scaled), k/v [B, N, H], out [B, Q, H], all contiguous on
// the device and of one type: float32 (is_bf16 = 0, CUDA cores) or
// bfloat16 (is_bf16 = 1, tensor cores); k and v 16-byte aligned; mask
// [Q, N + N % 2] int8 (rows padded to an even length). Returns the
// cudaError_t of the launch.
extern "C" int ctrl_sim_decode_attention(const void* q, const void* k, const void* v,
                                         const void* mask, void* out, int B, int Q, int N,
                                         int H, int num_heads, int is_bf16, void* stream) {
  if (B <= 0 || Q <= 0 || N <= 0 || num_heads <= 0 || H % num_heads != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (H / num_heads) {
    case 16: return (int)launch<16>(q, k, v, mask, out, B, Q, N, H, num_heads, is_bf16, s);
    case 32: return (int)launch<32>(q, k, v, mask, out, B, Q, N, H, num_heads, is_bf16, s);
    case 64: return (int)launch<64>(q, k, v, mask, out, B, Q, N, H, num_heads, is_bf16, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
