// Decode attention over the streaming rollout's KV ring cache on Hopper's
// tensor cores (sm_90a), in bf16: the body shared by kernel K1
// (decode_attention.cu, bf16 cache) and kernel K2 (decode_attention_q8.cu,
// int8 cache with fp32 per-token scales). Each source wraps it in a kernel
// of its own name.
//
// What it computes, per lane b and head h (d = H / num_heads), with q'
// pre-scaled by log2(e) / sqrt(d) (by the wrapper, the factor rounded to
// bf16), bias = 0 where mask[i, j] != 0 and -1e30 where it is 0:
//   s[i, j] = q'[b, i] . k[b, j] (times k_scale[b, j] over the int8 cache) + bias[i, j]
//   e[i, j] = 2^(s[i, j] - m_i)
//   out[b, i, h*d:(h+1)*d] = sum_j bf16(e[i, j] (times v_scale[b, j])) v[b, j] / sum_j e[i, j]
// which is the TPU bodies' function (ctrl_sim_tpu/ops/attention.py:_attn_body,
// _attn_body_q8), with m_i a running max instead of the row max: the
// weights are rounded to bf16 against it, a rounding of the same relative
// size. A fully masked row comes out as the uniform average of V over the
// N keys, finite; keys past N take no weight at all.
//
// What bounds it: one read of K and V (at the bench shape, B = 256 lanes,
// N = 1536 keys, H = 256, 402,653,184 bytes in bf16, 0.12 ms at 3.35 TB/s;
// half of that in int8) against 12.9 GFLOP at Q = 32 (0.013 ms on the
// tensor cores): bytes. The design keeps enough bytes in flight to stream,
// and keeps the arithmetic below them (over the int8 cache, whose bytes
// are half, the widening and the softmax come close):
// - a warp takes one (lane b, head h) and 16 MT query rows (MT m16 tiles:
//   2 on pass 1, 1 on pass 2, so no warp computes a padding tile), and
//   walks all the keys of its head; a block holds the warps of up to 4
//   heads of one lane (4 at the bench shape: 512 blocks, one wave at 4
//   blocks an SM), so that it reads 256 contiguous bytes of each key row;
//   a warp needs no other warp's results, and the block no barrier (a
//   sweep on the card chose this over splitting one head's keys over 4
//   warps and merging their partial results);
// - each warp streams its 32-key chunks through a cp.async ring of its own
//   in shared memory (3 stages of bf16 K/V, or 4 of int8 K/V and their
//   scales), so its only barrier in the loop is __syncwarp; the tiles'
//   16-byte units are XOR-swizzled, so that ldmatrix and the int8 widening
//   are free of bank conflicts without padding;
// - the int8 chunk is widened to a bf16 chunk in shared memory by the warp
//   (exact: |x| <= 127), then both caches take the same products;
// - q's A fragments come once, straight from device memory; S = q K^T and
//   O += P V run on mma.sync m16n8k16 (ldmatrix, .trans for V); the mask
//   bytes are read a chunk ahead, straight into the C fragment's layout,
//   and skipped (a warp-uniform branch) on chunks whose keys every row
//   sees; the online exp2 softmax works on the fp32 fragments with quad
//   shuffles; P is rounded to bf16 in registers as the A operand of P V;
// - the output is divided by the denominator and written once, in bf16,
//   straight from the accumulator fragments.

#pragma once

#include <math.h>

#include "mma_sm90.cuh"

namespace {

constexpr int kDecWarps = 4;             // warps a block holds at most: one a head
constexpr int kDecThreads = kDecWarps * 32;
constexpr int kDecChunk = 32;              // keys a warp takes per step: one per lane
constexpr int kDecNB = kDecChunk / 8;      // 8-key blocks of a chunk
constexpr float kDecMaskNeg = -1e30f;      // the TPU kernels' masked score
// blocks of 4 warps an SM holds (__launch_bounds__), as the rings' shared
// memory allows: over the bf16 cache 4 at d <= 32, so that the bench grid
// (256 lanes x 2 groups of 4 heads) runs in one wave; over the int8 cache
// 3, whose widening needs more than the 128 registers a thread of 4 blocks
// may hold (the card measured no gain from a 4th block with spills); 2 at
// d = 64
constexpr int decode_min_blocks(int D, bool int8) { return D > 32 ? 2 : (int8 ? 3 : 4); }

// The physical 16-byte unit of unit u of row r in a shared tile of U units a
// row (U = 1, 2, 4 or 8): XOR-swizzled, so that one unit of 8 consecutive
// rows (an ldmatrix phase, or the widening's reads and writes) falls on 8
// distinct bank groups without padding the rows.
template <int U>
__device__ __forceinline__ int swz(int r, int u) {
  return u ^ ((r / (8 / U)) % U);
}

struct DecodeArgs {
  const __nv_bfloat16* q;        // [B, Q, H], pre-scaled
  const void *k, *v;             // [B, N, H] bf16 or int8
  const float *k_scale, *v_scale;  // [B, N] (int8 cache only)
  const int8_t* mask;            // [Q, ldm], ldm = N + N % 2
  __nv_bfloat16* out;            // [B, Q, H]
  int Q, N, H, heads;
};

// 4 int8 values (one 32-bit word) as 4 bf16 (two bf16x2 words), exactly:
// x + 128 as the low byte of the fp32 2^23 + (x + 128), minus 2^23 + 128;
// the result is an integer of magnitude <= 128, whose bf16 bits are its
// fp32 bits' upper half.
__device__ __forceinline__ uint2 widen_i8x4(uint32_t w) {
  const uint32_t u = w ^ 0x80808080u;
  uint32_t f[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    f[j] = __float_as_uint(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440 + j)) - 8388736.f);
  return make_uint2(__byte_perm(f[0], f[1], 0x7632), __byte_perm(f[2], f[3], 0x7632));
}

// A warp's ring of K/V chunks in shared memory.
template <int D, bool kInt8>
struct DecodeRing;

template <int D>
struct DecodeRing<D, false> {
  static constexpr int kStages = 3;
  uint16_t k[kStages][kDecChunk * D];  // [key][D], swizzled units of 8
  uint16_t v[kStages][kDecChunk * D];

  // keys [key0, key0 + 32) x D into stage st, 16 bytes a copy; keys >= N are zeros
  __device__ __forceinline__ void fetch(int st, const DecodeArgs& a, size_t kv, const float*, const float*,
                                        int key0, int lane) {
    constexpr int kPerRow = D / 8;
    const __nv_bfloat16* kb = static_cast<const __nv_bfloat16*>(a.k) + kv;
    const __nv_bfloat16* vb = static_cast<const __nv_bfloat16*>(a.v) + kv;
#pragma unroll
    for (int i = 0; i < kPerRow; ++i) {
      const int c = lane + 32 * i, row = c / kPerRow, u = c % kPerRow;
      const bool ok = key0 + row < a.N;
      const size_t off = (size_t)(ok ? key0 + row : 0) * a.H + 8 * u;
      const int dst = row * D + 8 * swz<kPerRow>(row, u);
      cp_async16(&k[st][dst], kb + off, ok);
      cp_async16(&v[st][dst], vb + off, ok);
    }
  }
  __device__ __forceinline__ const uint16_t* k_tile(int st) const { return k[st]; }
  __device__ __forceinline__ const uint16_t* v_tile(int st) const { return v[st]; }
};

template <int D>
struct DecodeRing<D, true> {
  static constexpr int kStages = 4;
  int8_t k[kStages][kDecChunk * D];  // [key][D], swizzled units of 16
  int8_t v[kStages][kDecChunk * D];
  float ks[kStages][kDecChunk], vs[kStages][kDecChunk];
  uint16_t kw[kDecChunk * D], vw[kDecChunk * D];  // the stage in use, widened to bf16 (units of 8)

  __device__ __forceinline__ void fetch(int st, const DecodeArgs& a, size_t kv, const float* ksb,
                                        const float* vsb, int key0, int lane) {
    constexpr int kPerRow = D / 16;
    const int8_t* kb = static_cast<const int8_t*>(a.k) + kv;
    const int8_t* vb = static_cast<const int8_t*>(a.v) + kv;
#pragma unroll
    for (int i = 0; i < kPerRow; ++i) {
      const int c = lane + 32 * i, row = c / kPerRow, u = c % kPerRow;
      const bool ok = key0 + row < a.N;
      const size_t off = (size_t)(ok ? key0 + row : 0) * a.H + 16 * u;
      const int dst = row * D + 16 * swz<kPerRow>(row, u);
      cp_async16(&k[st][dst], kb + off, ok);
      cp_async16(&v[st][dst], vb + off, ok);
    }
    const bool ok = key0 + lane < a.N;
    cp_async4(&ks[st][lane], ksb + (ok ? key0 + lane : 0), ok);
    cp_async4(&vs[st][lane], vsb + (ok ? key0 + lane : 0), ok);
  }
  // each lane widens its key's row of K and V; the caller syncs the warp
  __device__ __forceinline__ void widen(int st, int lane) {
    const int row = lane * D;
#pragma unroll
    for (int u = 0; u < D / 16; ++u) {
      const int src = row + 16 * swz<D / 16>(lane, u);
      const int lo = row + 8 * swz<D / 8>(lane, 2 * u), hi = row + 8 * swz<D / 8>(lane, 2 * u + 1);
      const uint4 kr = *reinterpret_cast<const uint4*>(&k[st][src]);
      const uint4 vr = *reinterpret_cast<const uint4*>(&v[st][src]);
      const uint2 k0 = widen_i8x4(kr.x), k1 = widen_i8x4(kr.y), k2 = widen_i8x4(kr.z), k3 = widen_i8x4(kr.w);
      const uint2 v0 = widen_i8x4(vr.x), v1 = widen_i8x4(vr.y), v2 = widen_i8x4(vr.z), v3 = widen_i8x4(vr.w);
      *reinterpret_cast<uint4*>(&kw[lo]) = make_uint4(k0.x, k0.y, k1.x, k1.y);
      *reinterpret_cast<uint4*>(&kw[hi]) = make_uint4(k2.x, k2.y, k3.x, k3.y);
      *reinterpret_cast<uint4*>(&vw[lo]) = make_uint4(v0.x, v0.y, v1.x, v1.y);
      *reinterpret_cast<uint4*>(&vw[hi]) = make_uint4(v2.x, v2.y, v3.x, v3.y);
    }
  }
  __device__ __forceinline__ const uint16_t* k_tile(int) const { return kw; }
  __device__ __forceinline__ const uint16_t* v_tile(int) const { return vw; }
};

template <int D, int MT, bool kInt8>
__device__ __forceinline__ void decode_attention_mma(const DecodeArgs& a) {
  using Ring = DecodeRing<D, kInt8>;
  constexpr int S = Ring::kStages, R = 16 * MT, KS = D / 16;
  extern __shared__ __align__(128) unsigned char dec_smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  Ring& ring = reinterpret_cast<Ring*>(dec_smem)[warp];
  const int groups = a.heads / (blockDim.x >> 5);  // blocks per lane: a warp a head
  const int b = blockIdx.x / groups, h = (blockIdx.x % groups) * (blockDim.x >> 5) + warp;
  const int q0 = blockIdx.y * R;
  const int N = a.N, ldm = N + (N & 1), chunks = (N + kDecChunk - 1) / kDecChunk;
  const size_t head = (size_t)h * D, kv = (size_t)b * N * a.H + head;
  const float* ksb = kInt8 ? a.k_scale + (size_t)b * N : nullptr;
  const float* vsb = kInt8 ? a.v_scale + (size_t)b * N : nullptr;

#pragma unroll
  for (int i = 0; i < S - 1; ++i) {
    if (i < chunks) ring.fetch(i, a, kv, ksb, vsb, i * kDecChunk, lane);
    cp_async_commit();
  }
  uint32_t qf[MT][KS][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
    load_a_frags<KS>(qf[mt], a.q + (size_t)b * a.Q * a.H + head, q0 + 16 * mt, a.Q, a.H, g, t);

  // per row (mt, r = 0 for row g, 1 for g + 8): running max (log2 units),
  // this thread's part of the denominator, and the output accumulators
  float m[MT][2], l[MT][2], acc[MT][D / 8][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    m[mt][0] = m[mt][1] = -INFINITY;
    l[mt][0] = l[mt][1] = 0.f;
#pragma unroll
    for (int db = 0; db < D / 8; ++db) acc[mt][db][0] = acc[mt][db][1] = acc[mt][db][2] = acc[mt][db][3] = 0.f;
  }

  // the mask bytes of this thread's fragment entries (keys key0 + 8 nb + 2t,
  // + 1 of rows g, g + 8 of each m16 tile), loaded one chunk ahead, so that
  // their latency hides behind a chunk's products
  uint32_t mk[MT][2][kDecNB];
  auto load_mask = [&](int key0) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = q0 + 16 * mt + g + 8 * r;
#pragma unroll
        for (int nb = 0; nb < kDecNB; ++nb) {
          const int j = key0 + 8 * nb + 2 * t;
          mk[mt][r][nb] = (row < a.Q && j < N)
                              ? __ldg(reinterpret_cast<const unsigned short*>(a.mask + (size_t)row * ldm + j))
                              : 0x0101u;
        }
      }
  };
  load_mask(0);

  for (int c = 0; c < chunks; ++c) {
    const int key0 = c * kDecChunk;
    if (c + S - 1 < chunks) ring.fetch((c + S - 1) % S, a, kv, ksb, vsb, (c + S - 1) * kDecChunk, lane);
    cp_async_commit();
    cp_async_wait<S - 1>();  // chunk c has landed (this lane's copies)
    __syncwarp();            // ... and every lane's
    const int st = c % S;
    if constexpr (kInt8) {
      ring.widen(st, lane);
      __syncwarp();
    }

    // S = q K^T for the chunk: B fragments by ldmatrix, shared by the MT tiles
    float s[MT][kDecNB][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nb = 0; nb < kDecNB; ++nb) s[mt][nb][0] = s[mt][nb][1] = s[mt][nb][2] = s[mt][nb][3] = 0.f;
    const uint16_t* kt = ring.k_tile(st);
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int p = 0; p < kDecNB / 2; ++p) {
        uint32_t bf[4];
        const int row = 16 * p + (lane & 7) + ((lane >> 4) << 3);
        ldsm_x4(bf, kt + row * D + 8 * swz<D / 8>(row, 2 * ks + ((lane >> 3) & 1)));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(s[mt][2 * p], qf[mt][ks], bf[0], bf[1]);
          mma_bf16(s[mt][2 * p + 1], qf[mt][ks], bf[2], bf[3]);
        }
      }

    // scores: times k_scale (int8); then masked -1e30 and keys past N -inf,
    // unless every key of the chunk is visible to every row (a branch
    // uniform over the warp, taken by most chunks of the rollout's masks)
    float kscale[kDecNB][2], vscale[kDecNB][2];
    if constexpr (kInt8) {
#pragma unroll
      for (int nb = 0; nb < kDecNB; ++nb) {
        const float2 ksc = *reinterpret_cast<const float2*>(&ring.ks[st][8 * nb + 2 * t]);
        const float2 vsc = *reinterpret_cast<const float2*>(&ring.vs[st][8 * nb + 2 * t]);
        kscale[nb][0] = ksc.x, kscale[nb][1] = ksc.y, vscale[nb][0] = vsc.x, vscale[nb][1] = vsc.y;
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nb = 0; nb < kDecNB; ++nb)
#pragma unroll
          for (int i = 0; i < 4; ++i) s[mt][nb][i] *= kscale[nb][i & 1];
    }
    bool dense = key0 + kDecChunk <= N;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int nb = 0; nb < kDecNB; ++nb) dense = dense && mk[mt][r][nb] == 0x0101u;
    if (!__all_sync(0xffffffffu, dense)) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nb = 0; nb < kDecNB; ++nb)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const bool past = key0 + 8 * nb + 2 * t + e >= N;
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              float& x = s[mt][nb][2 * r + e];
              x = past ? -INFINITY : (((mk[mt][r][nb] >> (8 * e)) & 0xffu) ? x : kDecMaskNeg);
            }
          }
    }
    if (c + 1 < chunks) load_mask(key0 + kDecChunk);

    // online softmax on the fragments; the max is subtracted on its own,
    // never inside an FMA with a -1e30 score, so a fully masked chunk gives
    // 2^0 = 1 against its own max and a finite, uniform row
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = m[mt][r];
#pragma unroll
        for (int nb = 0; nb < kDecNB; ++nb) mx = fmaxf(mx, fmaxf(s[mt][nb][2 * r], s[mt][nb][2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float mu = mx == -INFINITY ? 0.f : mx;
        const float alpha = fast_exp2(m[mt][r] - mu);
        m[mt][r] = mx;
        float sum = 0.f;
#pragma unroll
        for (int nb = 0; nb < kDecNB; ++nb)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& x = s[mt][nb][2 * r + e];
            x = fast_exp2(x - mu);
            sum += x;
            if constexpr (kInt8) x *= vscale[nb][e];  // rounded to bf16 below, as the TPU body rounds e * v_scale
          }
        l[mt][r] = l[mt][r] * alpha + sum;
#pragma unroll
        for (int db = 0; db < D / 8; ++db) {
          acc[mt][db][2 * r] *= alpha;
          acc[mt][db][2 * r + 1] *= alpha;
        }
      }

    // O += P V: P rounded to bf16 A fragments in registers, V by ldmatrix .trans
    const uint16_t* vt = ring.v_tile(st);
#pragma unroll
    for (int kk = 0; kk < kDecNB / 2; ++kk) {
      uint32_t pa[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        pa[mt][0] = pack_bf16(s[mt][2 * kk][0], s[mt][2 * kk][1]);
        pa[mt][1] = pack_bf16(s[mt][2 * kk][2], s[mt][2 * kk][3]);
        pa[mt][2] = pack_bf16(s[mt][2 * kk + 1][0], s[mt][2 * kk + 1][1]);
        pa[mt][3] = pack_bf16(s[mt][2 * kk + 1][2], s[mt][2 * kk + 1][3]);
      }
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t bf[4];
        const int row = 16 * kk + (lane & 7) + (((lane >> 3) & 1) << 3);
        ldsm_x4_t(bf, vt + row * D + 8 * swz<D / 8>(row, 2 * dp + (lane >> 4)));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(acc[mt][2 * dp], pa[mt], bf[0], bf[1]);
          mma_bf16(acc[mt][2 * dp + 1], pa[mt], bf[2], bf[3]);
        }
      }
    }
    __syncwarp();  // the stage (and the widened chunk) is consumed before it is overwritten
  }

  // the denominators (this thread's parts summed over its quad) divide the output
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    float mul[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[mt][r] += __shfl_xor_sync(0xffffffffu, l[mt][r], 1);
      l[mt][r] += __shfl_xor_sync(0xffffffffu, l[mt][r], 2);
      mul[r] = 1.f / l[mt][r];
    }
    const int row[2] = {q0 + 16 * mt + g, q0 + 16 * mt + g + 8};
    store_rows<D>(a.out + (size_t)b * a.Q * a.H + head, acc[mt], row, mul, a.Q, a.H, t);
  }
}

// Launches kernel<D, MT> (a __global__ wrapper of decode_attention_mma<D,
// MT, kInt8>), after raising its dynamic shared memory limit once per
// device: blocks of G warps, a warp a head, G the largest of 4, 2 and 1
// that divides the heads; grid (B heads / G, query tiles of 16 MT rows).
template <int D, int MT, bool kInt8>
cudaError_t launch_decode_mma(void (*kernel)(DecodeArgs), const DecodeArgs& a, int B, cudaStream_t stream) {
  constexpr size_t ring = sizeof(DecodeRing<D, kInt8>);
  static unsigned configured = 0;  // bit i: set on device i
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (!((configured >> dev) & 1u)) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)(kDecWarps * ring));
    if (err == cudaSuccess)  // the most shared memory, so that decode_min_blocks blocks fit an SM
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout, cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    configured |= 1u << dev;
  }
  const int G = a.heads % 4 == 0 ? 4 : (a.heads % 2 == 0 ? 2 : 1);
  const dim3 grid(B * (a.heads / G), (a.Q + 16 * MT - 1) / (16 * MT));
  kernel<<<grid, 32 * G, G * ring, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace
