// Masked multi-head decode attention over the streaming rollout's int8 KV
// ring cache, for Hopper (sm_90a). Built by ctrl_sim_tpu_torch/ops/build.py
// with nvcc into a shared library with a plain C interface, loaded with
// ctypes.
//
// Replaces the TPU kernel ctrl_sim_tpu/ops/attention.py:_attn_body_q8
// (reached through cached_decode_attention_q8 -> _decode_kernel_q8 ->
// pl.pallas_call).
//
// What it computes, per lane b and head h (d = H / num_heads):
//   s[i, j] = (q'[b, i] . k[b, j]) * k_scale[b, j] + bias[i, j]
//   out[b, i, h*d:(h+1)*d] = sum_j 2^(s[i, j] - m_i) v_scale[b, j] v[b, j]
//                            / sum_j 2^(s[i, j] - m_i)
// with k, v the int8 values, q' = q * log2(e) / sqrt(d) (pre-scaled by the
// wrapper), bias = 0 where mask[i, j] != 0 and -1e30 where it is 0, and m_i
// the row max. One [Q, N] int8 mask is shared by the batch. A fully masked
// row comes out as the uniform average of the dequantized V: finite, unused.
// The K scale folds into the score row and the V scale into the weights, so
// the products run on the int8 values widened to fp32 (exact: |x| <= 127).
//
// Rounding: the TPU body casts the weights e * v_scale to q's dtype before
// the product with V, with e taken against the row's global max. This kernel
// holds e against a running max (online softmax), so its rounding points
// would differ anyway: it keeps the weights in fp32, and the tolerance
// against the plain version (which rounds as the TPU does) covers the
// difference (2e-2 absolute in bf16; in f32 the cast is a no-op).
//
// What bounds it: one read of the int8 K and V and their fp32 scales. At the
// bench shape (B = 256 lanes, N = 32 steps * 3 token types * 16 slots = 1536
// keys, H = 256) that is 2 * B * N * H = 201,326,592 bytes plus 3,145,728
// bytes of scales per launch (0.061 ms at 3.35 TB/s), half of K1's bf16
// cache, against 4 * B * Q * N * H = 12.9 GFLOP (Q = 32): memory-bound. The
// products run on CUDA cores here (int8 mma is later work).
//
// Design (K1 v2's, with int8 tiles):
// - one block per (lane b, head h, tile of 32 query rows); 4 warps, each warp
//   owns 8 query rows, so K/V of one (b, h) are read once per 32 queries;
// - K/V tiles of 32 keys x d are loaded 16 int8 values a thread, widened to
//   fp32 in registers and staged through shared memory; the next tile's K, V,
//   the two scales of each lane's key and the mask bytes are loaded into
//   registers while the current tile is computed;
// - each lane owns one key of the tile for the scores (scaled by its
//   k_scale), and output dims lane, lane + 32 for the weighted sum, whose
//   weights carry its key's v_scale; both loops are register-blocked over
//   the warp's 8 rows so each shared-memory load feeds 8 FMAs;
// - an online exp2 softmax in fp32 registers: the running max is
//   warp-uniform, the running denominator (without v_scale) stays per lane
//   and is summed once at the end; the denominator divides the [Q, d]
//   output.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 8;
constexpr int kQTile = kWarps * kRowsPerWarp;  // query rows per block
constexpr int kKTile = 32;                     // keys per tile: one per lane
constexpr int kElems = 16;                     // int8 values per 16-byte load
constexpr float kMaskNeg = -1e30f;             // exp2 of (x - 1e30 - m) is 0

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float x, float* p) { *p = x; }
__device__ __forceinline__ void store(float x, __nv_bfloat16* p) { *p = __float2bfloat16(x); }

// byte j of w, sign-extended, as fp32
__device__ __forceinline__ float byte_to_float(uint32_t w, int j) {
  return static_cast<float>(static_cast<int32_t>(w << (24 - 8 * j)) >> 24);
}

// 16 int8 values, widened to fp32 and stored at dst (16-byte aligned).
__device__ __forceinline__ void store_i8x16(const uint4& raw, float* dst) {
  const uint32_t words[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
    *reinterpret_cast<float4*>(dst + 4 * i) =
        make_float4(byte_to_float(words[i], 0), byte_to_float(words[i], 1),
                    byte_to_float(words[i], 2), byte_to_float(words[i], 3));
}

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

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
decode_attention_q8_kernel(const T* __restrict__ q, const int8_t* __restrict__ k,
                           const int8_t* __restrict__ v, const float* __restrict__ k_scale,
                           const float* __restrict__ v_scale, const int8_t* __restrict__ mask,
                           T* __restrict__ out, int Q, int N, int H, int num_heads) {
  constexpr int DK = D + 4;  // padded K rows: float4 reads across lanes hit distinct banks
  constexpr int DCH = (D + 31) / 32;
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
  const T* qb = q + (size_t)b * Q * H + head;
  const int8_t* kb = k + (size_t)b * N * H + head;
  const int8_t* vb = v + (size_t)b * N * H + head;
  const float* ksb = k_scale + (size_t)b * N;
  const float* vsb = v_scale + (size_t)b * N;

  for (int i = threadIdx.x; i < kQTile * D; i += kThreads) {
    const int r = i / D, c = i % D;
    qs[r][c] = (q0 + r < Q) ? to_float(qb[(size_t)(q0 + r) * H + c]) : 0.f;
  }

  // registers holding the next tile: K/V as raw 16-byte loads, this lane's
  // key's two scales, and its mask byte per row (1 attend, 0 masked, -1 key
  // past N)
  uint4 kreg[kVecThread], vreg[kVecThread];
  float kscale_reg, vscale_reg;
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
    kscale_reg = n < N ? __ldg(ksb + n) : 0.f;
    vscale_reg = n < N ? __ldg(vsb + n) : 0.f;
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int qi = q0 + row0 + r;
      mreg[r] = n >= N ? int8_t(-1) : (qi >= Q ? int8_t(1) : (mask[(size_t)qi * N + n] != 0 ? int8_t(1) : int8_t(0)));
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
        store_i8x16(kreg[j], &ks[r][c]);
        store_i8x16(vreg[j], &vs[r][c]);
      }
    }
    const float kscale = kscale_reg, vscale = vscale_reg;
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
      const float sk = s[r] * kscale;
      const float sr = mcur[r] < 0 ? -INFINITY : (mcur[r] ? sk : sk + kMaskNeg);
      const float m_new = fmaxf(m[r], warp_max(sr));
      const float alpha = exp2f(m[r] - m_new);
      const float p = exp2f(sr - m_new);
      l[r] = l[r] * alpha + p;
#pragma unroll
      for (int c = 0; c < DCH; ++c) acc[r][c] *= alpha;
      m[r] = m_new;
      ps[warp][r][lane] = p * vscale;
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
    T* ob = out + ((size_t)b * Q + qi) * H + head;
#pragma unroll
    for (int c = 0; c < DCH; ++c) {
      const int o = lane + 32 * c;
      if (o < D) store(acc[r][c] / denom, ob + o);
    }
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const void* k_scale,
                   const void* v_scale, const void* mask, void* out, int B, int Q, int N, int H,
                   int num_heads, cudaStream_t stream) {
  const dim3 grid(B * num_heads, (Q + kQTile - 1) / kQTile);
  const int d = H / num_heads;
  const T* qp = static_cast<const T*>(q);
  const int8_t* kp = static_cast<const int8_t*>(k);
  const int8_t* vp = static_cast<const int8_t*>(v);
  const float* ksp = static_cast<const float*>(k_scale);
  const float* vsp = static_cast<const float*>(v_scale);
  const int8_t* mp = static_cast<const int8_t*>(mask);
  T* op = static_cast<T*>(out);
  switch (d) {
    case 16:
      decode_attention_q8_kernel<T, 16><<<grid, kThreads, 0, stream>>>(qp, kp, vp, ksp, vsp, mp, op, Q, N, H, num_heads);
      break;
    case 32:
      decode_attention_q8_kernel<T, 32><<<grid, kThreads, 0, stream>>>(qp, kp, vp, ksp, vsp, mp, op, Q, N, H, num_heads);
      break;
    case 64:
      decode_attention_q8_kernel<T, 64><<<grid, kThreads, 0, stream>>>(qp, kp, vp, ksp, vsp, mp, op, Q, N, H, num_heads);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// q [B, Q, H] (pre-scaled) and out [B, Q, H] of one type: float32
// (is_bf16 = 0) or bfloat16 (is_bf16 = 1); k/v [B, N, H] int8, 16-byte
// aligned; k_scale/v_scale [B, N] float32; mask [Q, N] int8; all contiguous
// on the device. Returns the cudaError_t of the launch.
extern "C" int ctrl_sim_decode_attention_q8(const void* q, const void* k, const void* v,
                                            const void* k_scale, const void* v_scale,
                                            const void* mask, void* out, int B, int Q, int N,
                                            int H, int num_heads, int is_bf16, void* stream) {
  if (B <= 0 || Q <= 0 || N <= 0 || num_heads <= 0 || H % num_heads != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch<__nv_bfloat16>(q, k, v, k_scale, v_scale, mask, out, B, Q, N, H, num_heads, s)
              : launch<float>(q, k, v, k_scale, v_scale, mask, out, B, Q, N, H, num_heads, s);
  return (int)err;
}
