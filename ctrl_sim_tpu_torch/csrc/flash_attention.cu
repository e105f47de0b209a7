// Training flash attention under the multi-agent causal mask, for Hopper
// (sm_90a): the forward (kernel K3) and the backward (kernel K4, two CUDA
// kernels). Built by ctrl_sim_tpu_torch/ops/build.py with nvcc into a shared
// library with a plain C interface, loaded with ctypes.
//
// Replaces the TPU kernels of ctrl_sim_tpu/ops/flash_attention.py:
//   K3: _fwd_call -> pl.pallas_call(_fwd_kernel)   (flash_attention.py:271)
//   K4: _bwd_call -> pl.pallas_call(_bwd_kernel)   (flash_attention.py:299)
//
// What they compute, per batch row b and head h (d = H / heads, s = 1/sqrt(d)):
//   S = s * Q K^T, masked to -1e30 where the multi-agent causal predicate
//   (ops/masks.py:visible, evaluated from token indices, never stored) is
//   false; P = softmax(S); lse = m + log(l) per row, before dropout;
//   O = dropout(P) V with dropout applied after normalization:
//   keep ? p / (1 - p_drop) : 0, the keep bit the murmur3 finalizer over
//   (seed, b, h, row, col) in uint32 arithmetic, bit-identical to
//   _dropout_keep and so to any tiling. The backward recomputes P from lse:
//   delta = rowsum(dO . O), dP = keep ? dO V^T / (1 - p_drop) : 0,
//   dS = P (dP - delta) s, dQ = dS K, dK = dS^T Q, dV = dropout(P)^T dO.
//
// What bounds them. At the trainer's shape (B = 16, T = 32 steps x 24
// agents x 3 token types = 2304, H = 256 = 8 x 32, bf16) the mask admits
// 2,628,864 of the 5,308,416 (query, key) pairs; counting only those, the
// forward does 4 * pairs * H * B = 43.1 GFLOP (0.044 ms at the bf16
// tensor-core rate) against 76.7 MB of inputs and outputs (0.023 ms), the
// backward 10 * pairs * H * B = 107.7 GFLOP (0.109 ms) against 152 MB. Two
// kinds of per-element work stay on the CUDA cores whatever the design, and
// set floors the bound does not count: one exp per admitted element and
// pass (336 M elements at 16 per SM per clock, about 0.08 ms a pass; K3 has
// one pass, K4 two, since both its kernels recompute P), and with dropout
// the murmur3 keep bit, about 10 integer operations an element (about
// 0.2 ms a pass at 64 per SM per clock).
//
// bf16: tensor cores (flash_*_mma_kernel). FlashAttention-2's layout with
// mma.sync.m16n8k16 (bf16 operands, fp32 accumulators): a block of 4 warps
// owns 64 rows, 16 a warp, and streams 64-row tiles of the other side
// through a 2-stage cp.async ring of bf16 shared-memory tiles, rows padded
// to D + 8 elements so that ldmatrix (.trans where the product needs the
// tile transposed) is free of bank conflicts. The fixed side's operands
// (Q, and dO in the dq kernel; K and V in the dk/dv kernel) are loaded once
// from device memory straight into A fragments. Scores stay in fp32
// accumulators; the online softmax works on the fragments with quad
// shuffles; P (after the keep bit) and dS are rounded to bf16 and reused in
// registers as the A operand of the next product, never going through
// shared memory. Each output is written once, in bf16. The kernels are
// latency-bound, not bound by the tensor cores: each works through its
// streamed tile 16 or 32 columns at a time, which keeps few scores live, and
// __launch_bounds__ caps the registers so that 4-6 blocks share an SM
// without spilling (d = 32).
// - The tile schedule comes from the wrapper (ops/flash_attention.py:
//   tile_table): per 64-row tile, the range of tiles of the other side that
//   hold a visible pair, and within it the run of fully visible tiles, where
//   the predicate is not evaluated at all; tiles outside the range are never
//   touched. With the default mask every key of an earlier timestep is
//   visible, so only the tiles on a query tile's own timestep are partial.
//   Partial tiles read the streamed side's (t, a, k) coordinates from
//   shared memory, computed once per tile, and the fixed side's from
//   registers. Entries run heaviest first, so the longest blocks start
//   first.
// - The backward is two kernels and no atomics, so it is deterministic:
//   the dq kernel walks key tiles per 64-query tile (and writes delta for
//   the second), the dk/dv kernel walks the query tiles that see each
//   64-key tile, computing S^T and dP^T with keys as rows.
// - Rows and keys past T load as zeros; their scores are -inf (keys) or
//   -1e30 (rows) and take no weight, so nothing of them reaches an output.
//
// f32: CUDA cores (flash_fwd_kernel, flash_bwd_dq_kernel,
// flash_bwd_dkdv_kernel), kept for the 1e-4 agreement of the f32 path,
// which TF32 tensor cores cannot hold:
// - K/V stream through 32-row fp32 shared-memory tiles. The forward and dq
//   kernels give each block one (b, h, 32-query tile); 4 warps own 8 query
//   rows each and each lane one key of the tile, so every shared-memory
//   read feeds 8 FMAs. The forward keeps an online softmax (running max and
//   denominator); the dropped weights are left out of the weighted sum but
//   not of the denominator, which is what dropout after normalization means.
// - a key is visible only if its timestep is at most the query's (the
//   predicate implies it for every layout), so each query tile stops at the
//   end of its last row's timestep, and a sliding window starts it late:
//   masked pairs beyond those bounds are never computed, and each weight
//   they would have taken is exactly 0 in fp32 (exp of -1e30).
// - dkdv_kernel produces dK and dV per 32-key tile, walking the query tiles
//   that can see it, with warps owning 8 keys and lanes one query each;
//   both backward kernels accumulate in fp32 registers and write once.
// - the tile streamed by each loop is loaded 16 bytes a thread into
//   registers one tile ahead, so its device-memory latency overlaps the
//   current tile's arithmetic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sm90.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 8;                // rows each warp owns
constexpr int kTile = kWarps * kRows;   // rows per tile = one per lane
constexpr float kMaskNeg = -1e30f;      // the TPU kernel's masked score
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct MaskSpec {
  int A, K;          // agents, token types: token j = t*A*K + a*K + k
  int state_index;   // token type of the state token
  int own;           // attend_own_return_action
  int has_window, window;
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ void store(float x, float* p) { *p = x; }

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

// ops/masks.py:visible for query (ti, ai, index ii) and key (tj, aj, kj, index jj)
__device__ __forceinline__ bool visible(int ti, int ai, int ii, int tj, int aj, int kj, int jj,
                                        const MaskSpec& s) {
  const bool state_vis = (kj == s.state_index) && (tj <= ti);
  bool base = (jj <= ii) && ((tj < ti) || (aj == ai));
  if (s.own) base = base && !((tj < ti) && (aj != ai) && (kj != s.state_index));
  bool out = state_vis || base;
  if (s.has_window) out = out && (tj > ti - s.window);
  return out;
}

// flash_attention.py:_dropout_keep: the murmur3 finalizer over
// (row * kHashRow) ^ (col * kHashCol) ^ (b * kHashB) ^ (h * kHashH) ^ seed.
// The tensor-core kernels build that word from per-row and per-column parts.
constexpr uint32_t kHashRow = 0x9E3779B1u, kHashCol = 0x85EBCA77u;
constexpr uint32_t kHashB = 0xC2B2AE3Du, kHashH = 0x27D4EB2Fu;

__device__ __forceinline__ bool keep_hashed(uint32_t x, uint32_t threshold) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x < threshold;
}

__device__ __forceinline__ bool keep_bit(uint32_t seed, uint32_t b, uint32_t h, uint32_t row,
                                         uint32_t col, uint32_t threshold) {
  return keep_hashed(row * kHashRow ^ col * kHashCol ^ b * kHashB ^ h * kHashH ^ seed, threshold);
}

// 16 bytes of T, widened to fp32 and stored at dst (16-byte aligned).
__device__ __forceinline__ void store_vec(const uint4& raw, float* dst, float) {
  *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(&raw);
}

// One tile of kTile rows of one head's D columns held in registers as raw
// 16-byte loads, so the next tile's loads are in flight while the current
// tile is computed. x points at the head's column 0 of row 0 (row stride
// H, 16-byte aligned); rows >= n load as zeros.
template <typename T, int D>
struct TileRegs {
  static constexpr int kElems = 16 / sizeof(T);
  static constexpr int kVecRow = D / kElems;
  static constexpr int kVecTile = kTile * kVecRow;
  static constexpr int kVecThread = (kVecTile + kThreads - 1) / kThreads;
  uint4 r[kVecThread];

  __device__ __forceinline__ void load(const T* __restrict__ x, int r0, int n, int H) {
#pragma unroll
    for (int j = 0; j < kVecThread; ++j) {
      const int i = threadIdx.x + j * kThreads;
      const int row = i / kVecRow, c = (i % kVecRow) * kElems;
      r[j] = make_uint4(0, 0, 0, 0);
      if (i < kVecTile && r0 + row < n) r[j] = __ldg(reinterpret_cast<const uint4*>(x + (size_t)(r0 + row) * H + c));
    }
  }

  template <int S>
  __device__ __forceinline__ void store(float (*dst)[S]) const {
#pragma unroll
    for (int j = 0; j < kVecThread; ++j) {
      const int i = threadIdx.x + j * kThreads;
      if (i < kVecTile) store_vec(r[j], &dst[i / kVecRow][(i % kVecRow) * kElems], T());
    }
  }
};

// Rows [r0, r0 + kTile) straight into shared memory as fp32.
template <typename T, int D, int S>
__device__ __forceinline__ void load_tile(float (*dst)[S], const T* __restrict__ x, int r0, int n, int H) {
  TileRegs<T, D> t;
  t.load(x, r0, n, H);
  t.store(dst);
}

// Keys [begin, end) that a query tile [q0, q0 + kTile) can see: none past
// its last row's timestep, none before its first row's window. begin is
// aligned down to the tile.
__device__ __forceinline__ void key_range(int q0, int n, const MaskSpec& s, int* begin, int* end) {
  const int ak = s.A * s.K;
  const int t_lo = q0 / ak;
  const int t_hi = (min(q0 + kTile, n) - 1) / ak;
  const int e = min(n, (t_hi + 1) * ak);
  int bg = s.has_window ? max(0, (t_lo - s.window + 1) * ak) : 0;
  bg = min(bg, e - 1);
  *begin = (bg / kTile) * kTile;
  *end = e;
}

// ---------------------------------------------------------------------------
// K3 (f32): forward on CUDA cores
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const long long* __restrict__ seed_ptr, T* __restrict__ o, float* __restrict__ lse,
                 int n, int H, int heads, MaskSpec spec, float scale, float inv_keep,
                 uint32_t threshold, int use_dropout, int b_off) {
  constexpr int DP = D + 4;  // padded rows: float4 reads across lanes hit distinct banks
  constexpr int DCH = (D + 31) / 32;
  __shared__ __align__(16) float qs[kTile][D];
  __shared__ __align__(16) float ks[kTile][DP];
  __shared__ __align__(16) float vs[kTile][D];
  __shared__ __align__(16) float ps[kWarps][kRows][kTile];

  const int b = blockIdx.x / heads;
  const int h = blockIdx.x % heads;
  const int q0 = blockIdx.y * kTile;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row0 = warp * kRows;
  const size_t base = (size_t)b * n * H + (size_t)h * D;
  const uint32_t seed = (uint32_t)(*seed_ptr);
  const int ak = spec.A * spec.K;
  const float sl2 = scale * kLog2e;  // scores in log2 units: exp2 of them is exp of s * q.k

  load_tile<T, D, D>(qs, q + base, q0, n, H);
  int ti[kRows], ai[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int i = q0 + row0 + r;
    ti[r] = i / ak;
    ai[r] = (i / spec.K) % spec.A;
  }
  int n_begin, n_end;
  key_range(q0, n, spec, &n_begin, &n_end);

  float m[kRows], l[kRows], acc[kRows][DCH];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < DCH; ++c) acc[r][c] = 0.f;
  }

  TileRegs<T, D> kr, vr;
  kr.load(k + base, n_begin, n, H);
  vr.load(v + base, n_begin, n, H);
  for (int n0 = n_begin; n0 < n_end; n0 += kTile) {
    __syncthreads();  // the previous tile is consumed (and qs is written)
    kr.store(ks);
    vr.store(vs);
    __syncthreads();
    if (n0 + kTile < n_end) {  // in flight during the compute below
      kr.load(k + base, n0 + kTile, n, H);
      vr.load(v + base, n0 + kTile, n, H);
    }

    const int j = n0 + lane;
    const int tj = j / ak, aj = (j / spec.K) % spec.A, kj = j % spec.K;
    float s[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r] = 0.f;
#pragma unroll
    for (int c = 0; c < D; c += 4) {
      const float4 kk = *reinterpret_cast<const float4*>(&ks[lane][c]);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 qq = *reinterpret_cast<const float4*>(&qs[row0 + r][c]);
        s[r] += qq.x * kk.x + qq.y * kk.y + qq.z * kk.z + qq.w * kk.w;
      }
    }

#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int i = q0 + row0 + r;
      // keys past the range take no weight; masked keys take -1e30
      float sr = -INFINITY;
      if (j < n_end) sr = (i < n && visible(ti[r], ai[r], i, tj, aj, kj, j, spec)) ? s[r] * sl2 : kMaskNeg;
      const float m_new = fmaxf(m[r], warp_max(sr));
      const float alpha = exp2f(m[r] - m_new);
      const float p = exp2f(sr - m_new);
      l[r] = l[r] * alpha + p;
#pragma unroll
      for (int c = 0; c < DCH; ++c) acc[r][c] *= alpha;
      m[r] = m_new;
      const bool keep = !use_dropout || (j < n_end && keep_bit(seed, b + b_off, h, i, j, threshold));
      ps[warp][r][lane] = keep ? p : 0.f;
    }
    __syncwarp();

#pragma unroll
    for (int jj = 0; jj < kTile; jj += 4) {
      float vv[4][DCH];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int c = 0; c < DCH; ++c) {
          const int oc = lane + 32 * c;
          vv[u][c] = (oc < D) ? vs[jj + u][oc] : 0.f;
        }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 pp = *reinterpret_cast<const float4*>(&ps[warp][r][jj]);
#pragma unroll
        for (int c = 0; c < DCH; ++c)
          acc[r][c] += pp.x * vv[0][c] + pp.y * vv[1][c] + pp.z * vv[2][c] + pp.w * vv[3][c];
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const float denom = warp_sum(l[r]);
    const int i = q0 + row0 + r;
    if (i >= n) continue;
    if (lane == 0) lse[((size_t)b * heads + h) * n + i] = (m[r] + log2f(denom)) * kLn2;
    T* ob = o + base + (size_t)i * H;
#pragma unroll
    for (int c = 0; c < DCH; ++c) {
      const int oc = lane + 32 * c;
      if (oc < D) store(acc[r][c] / denom * inv_keep, ob + oc);
    }
  }
}

// ---------------------------------------------------------------------------
// K4 (f32), part 1: dQ per query tile, and delta = rowsum(dO . O) for part 2
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ o, const T* __restrict__ dout, const float* __restrict__ lse,
                    const long long* __restrict__ seed_ptr, T* __restrict__ dq, float* __restrict__ delta,
                    int n, int H, int heads, MaskSpec spec, float scale, float inv_keep,
                    uint32_t threshold, int use_dropout, int b_off) {
  constexpr int DP = D + 4;
  constexpr int DCH = (D + 31) / 32;
  __shared__ __align__(16) float qs[kTile][D];
  __shared__ __align__(16) float dos[kTile][D];
  __shared__ __align__(16) float ks[kTile][DP];
  __shared__ __align__(16) float vs[kTile][DP];
  __shared__ __align__(16) float dss[kWarps][kRows][kTile];

  const int b = blockIdx.x / heads;
  const int h = blockIdx.x % heads;
  const int q0 = blockIdx.y * kTile;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row0 = warp * kRows;
  const size_t base = (size_t)b * n * H + (size_t)h * D;
  const size_t lrow = ((size_t)b * heads + h) * n;  // this (b, h)'s row of lse and delta
  const uint32_t seed = (uint32_t)(*seed_ptr);
  const int ak = spec.A * spec.K;
  const float sl2 = scale * kLog2e;

  load_tile<T, D, D>(qs, q + base, q0, n, H);
  load_tile<T, D, D>(dos, dout + base, q0, n, H);
  __syncthreads();

  int ti[kRows], ai[kRows];
  float lse2[kRows], dlt[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int i = q0 + row0 + r;
    ti[r] = i / ak;
    ai[r] = (i / spec.K) % spec.A;
    float part = 0.f;
    if (i < n)
      for (int c = lane; c < D; c += 32) part += dos[row0 + r][c] * to_float(o[base + (size_t)i * H + c]);
    dlt[r] = warp_sum(part);
    lse2[r] = i < n ? lse[lrow + i] * kLog2e : 0.f;
    if (lane == 0 && i < n) delta[lrow + i] = dlt[r];
  }
  int n_begin, n_end;
  key_range(q0, n, spec, &n_begin, &n_end);

  float acc[kRows][DCH];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int c = 0; c < DCH; ++c) acc[r][c] = 0.f;

  TileRegs<T, D> kr, vr;
  kr.load(k + base, n_begin, n, H);
  vr.load(v + base, n_begin, n, H);
  for (int n0 = n_begin; n0 < n_end; n0 += kTile) {
    __syncthreads();
    kr.store(ks);
    vr.store(vs);
    __syncthreads();
    if (n0 + kTile < n_end) {
      kr.load(k + base, n0 + kTile, n, H);
      vr.load(v + base, n0 + kTile, n, H);
    }

    const int j = n0 + lane;
    const int tj = j / ak, aj = (j / spec.K) % spec.A, kj = j % spec.K;
    float s[kRows], dpd[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r] = dpd[r] = 0.f;
#pragma unroll
    for (int c = 0; c < D; c += 4) {
      const float4 kk = *reinterpret_cast<const float4*>(&ks[lane][c]);
      const float4 vv = *reinterpret_cast<const float4*>(&vs[lane][c]);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 qq = *reinterpret_cast<const float4*>(&qs[row0 + r][c]);
        const float4 dd = *reinterpret_cast<const float4*>(&dos[row0 + r][c]);
        s[r] += qq.x * kk.x + qq.y * kk.y + qq.z * kk.z + qq.w * kk.w;
        dpd[r] += dd.x * vv.x + dd.y * vv.y + dd.z * vv.z + dd.w * vv.w;
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int i = q0 + row0 + r;
      const bool vis = j < n_end && i < n && visible(ti[r], ai[r], i, tj, aj, kj, j, spec);
      const float p = vis ? exp2f(s[r] * sl2 - lse2[r]) : 0.f;
      float dp = dpd[r];
      if (use_dropout) dp = (vis && keep_bit(seed, b + b_off, h, i, j, threshold)) ? dp * inv_keep : 0.f;
      dss[warp][r][lane] = p * (dp - dlt[r]) * scale;
    }
    __syncwarp();

#pragma unroll
    for (int jj = 0; jj < kTile; jj += 4) {
      float kv[4][DCH];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int c = 0; c < DCH; ++c) {
          const int oc = lane + 32 * c;
          kv[u][c] = (oc < D) ? ks[jj + u][oc] : 0.f;
        }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 dd = *reinterpret_cast<const float4*>(&dss[warp][r][jj]);
#pragma unroll
        for (int c = 0; c < DCH; ++c)
          acc[r][c] += dd.x * kv[0][c] + dd.y * kv[1][c] + dd.z * kv[2][c] + dd.w * kv[3][c];
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int i = q0 + row0 + r;
    if (i >= n) continue;
    T* gb = dq + base + (size_t)i * H;
#pragma unroll
    for (int c = 0; c < DCH; ++c) {
      const int oc = lane + 32 * c;
      if (oc < D) store(acc[r][c], gb + oc);
    }
  }
}

// ---------------------------------------------------------------------------
// K4 (f32), part 2: dK and dV per key tile, over the query tiles that can see it
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                      const T* __restrict__ dout, const float* __restrict__ lse,
                      const float* __restrict__ delta, const long long* __restrict__ seed_ptr,
                      T* __restrict__ dk, T* __restrict__ dv, int n, int H, int heads, MaskSpec spec,
                      float scale, float inv_keep, uint32_t threshold, int use_dropout, int b_off) {
  constexpr int DP = D + 4;
  constexpr int DCH = (D + 31) / 32;
  __shared__ __align__(16) float ks[kTile][D];
  __shared__ __align__(16) float vs[kTile][D];
  __shared__ __align__(16) float qs[kTile][DP];
  __shared__ __align__(16) float dos[kTile][DP];
  __shared__ float lse2s[kTile];
  __shared__ float dlts[kTile];
  __shared__ __align__(16) float pds[kWarps][kRows][kTile];
  __shared__ __align__(16) float dss[kWarps][kRows][kTile];

  const int b = blockIdx.x / heads;
  const int h = blockIdx.x % heads;
  const int k0 = blockIdx.y * kTile;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row0 = warp * kRows;
  const size_t base = (size_t)b * n * H + (size_t)h * D;
  const size_t lrow = ((size_t)b * heads + h) * n;
  const uint32_t seed = (uint32_t)(*seed_ptr);
  const int ak = spec.A * spec.K;
  const float sl2 = scale * kLog2e;

  load_tile<T, D, D>(ks, k + base, k0, n, H);
  load_tile<T, D, D>(vs, v + base, k0, n, H);
  int tj[kRows], aj[kRows], kj[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int j = k0 + row0 + r;
    tj[r] = j / ak;
    aj[r] = (j / spec.K) % spec.A;
    kj[r] = j % spec.K;
  }
  // queries that can see a key of this tile: timestep at least the key's,
  // and within the window of the tile's last key
  const int tj_lo = k0 / ak;
  const int tj_hi = (min(k0 + kTile, n) - 1) / ak;
  const int m_begin = ((tj_lo * ak) / kTile) * kTile;
  const int m_end = spec.has_window ? min(n, (tj_hi + spec.window) * ak) : n;

  float dk_acc[kRows][DCH], dv_acc[kRows][DCH];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int c = 0; c < DCH; ++c) dk_acc[r][c] = dv_acc[r][c] = 0.f;

  // the next query tile: q, dO, and (first warp) its rows' lse and delta
  TileRegs<T, D> qr, dr;
  float lse_next = 0.f, dlt_next = 0.f;
  auto prefetch = [&](int m0) {
    qr.load(q + base, m0, n, H);
    dr.load(dout + base, m0, n, H);
    const int i = m0 + threadIdx.x;
    if (threadIdx.x < kTile && i < n) {
      lse_next = lse[lrow + i] * kLog2e;
      dlt_next = delta[lrow + i];
    } else {
      lse_next = dlt_next = 0.f;
    }
  };
  if (m_begin < m_end) prefetch(m_begin);
  for (int m0 = m_begin; m0 < m_end; m0 += kTile) {
    __syncthreads();
    qr.store(qs);
    dr.store(dos);
    if (threadIdx.x < kTile) {
      lse2s[threadIdx.x] = lse_next;
      dlts[threadIdx.x] = dlt_next;
    }
    __syncthreads();
    if (m0 + kTile < m_end) prefetch(m0 + kTile);

    const int i = m0 + lane;  // this lane's query
    const int ti = i / ak, ai = (i / spec.K) % spec.A;
    float s[kRows], dpd[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r] = dpd[r] = 0.f;
#pragma unroll
    for (int c = 0; c < D; c += 4) {
      const float4 qq = *reinterpret_cast<const float4*>(&qs[lane][c]);
      const float4 dd = *reinterpret_cast<const float4*>(&dos[lane][c]);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 kk = *reinterpret_cast<const float4*>(&ks[row0 + r][c]);
        const float4 vv = *reinterpret_cast<const float4*>(&vs[row0 + r][c]);
        s[r] += qq.x * kk.x + qq.y * kk.y + qq.z * kk.z + qq.w * kk.w;
        dpd[r] += dd.x * vv.x + dd.y * vv.y + dd.z * vv.z + dd.w * vv.w;
      }
    }
    const float lse_i = lse2s[lane], dlt_i = dlts[lane];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int j = k0 + row0 + r;
      const bool vis = i < n && j < n && visible(ti, ai, i, tj[r], aj[r], kj[r], j, spec);
      const float p = vis ? exp2f(s[r] * sl2 - lse_i) : 0.f;
      float pd = p, dp = dpd[r];
      if (use_dropout) {
        const bool keep = vis && keep_bit(seed, b + b_off, h, i, j, threshold);
        pd = keep ? p * inv_keep : 0.f;
        dp = keep ? dp * inv_keep : 0.f;
      }
      pds[warp][r][lane] = pd;
      dss[warp][r][lane] = p * (dp - dlt_i) * scale;
    }
    __syncwarp();

#pragma unroll
    for (int ii = 0; ii < kTile; ii += 4) {
      float dov[4][DCH], qv[4][DCH];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int c = 0; c < DCH; ++c) {
          const int oc = lane + 32 * c;
          dov[u][c] = (oc < D) ? dos[ii + u][oc] : 0.f;
          qv[u][c] = (oc < D) ? qs[ii + u][oc] : 0.f;
        }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 pp = *reinterpret_cast<const float4*>(&pds[warp][r][ii]);
        const float4 dd = *reinterpret_cast<const float4*>(&dss[warp][r][ii]);
#pragma unroll
        for (int c = 0; c < DCH; ++c) {
          dv_acc[r][c] += pp.x * dov[0][c] + pp.y * dov[1][c] + pp.z * dov[2][c] + pp.w * dov[3][c];
          dk_acc[r][c] += dd.x * qv[0][c] + dd.y * qv[1][c] + dd.z * qv[2][c] + dd.w * qv[3][c];
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int j = k0 + row0 + r;
    if (j >= n) continue;
    T* kb = dk + base + (size_t)j * H;
    T* vb = dv + base + (size_t)j * H;
#pragma unroll
    for (int c = 0; c < DCH; ++c) {
      const int oc = lane + 32 * c;
      if (oc < D) {
        store(dk_acc[r][c], kb + oc);
        store(dv_acc[r][c], vb + oc);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 on tensor cores: mma.sync.m16n8k16, cp.async, ldmatrix
// ---------------------------------------------------------------------------

constexpr int kMmaWarps = 4;
constexpr int kMmaThreads = kMmaWarps * 32;
constexpr int kBlock = 64;  // rows per block (16 a warp) and rows per streamed tile
// Columns of a streamed tile each kernel works on at once (8 per block of
// NB), and the blocks an SM must hold (__launch_bounds__), chosen together
// on the card at d = 32: narrower chunks keep fewer scores live, so the
// register cap that lets 4-6 blocks share an SM costs no spills. d = 64
// needs twice the accumulators and keeps fewer blocks.
constexpr int kFwdNB = 4, kDqNB = 2, kDkdvNB = 2;
constexpr int fwd_min_blocks(int D) { return D > 32 ? 3 : 6; }
constexpr int dq_min_blocks(int D) { return D > 32 ? 2 : 5; }
constexpr int dkdv_min_blocks(int D) { return D > 32 ? 2 : 4; }
// One entry of the wrapper's tile table: the block's own tile, and the range
// [begin, end) of tiles of the other side it walks, of which [full_begin,
// full_end) are fully visible.
struct TileRange {
  int tile, begin, full_begin, full_end, end;
  __device__ __forceinline__ explicit TileRange(const int* __restrict__ e)
      : tile(e[0]), begin(e[1]), full_begin(e[2]), full_end(e[3]), end(e[4]) {}
  __device__ __forceinline__ bool partial(int t) const { return t < full_begin || t >= full_end; }
};

// Rows [r0, r0 + kBlock) x D of x (row stride H) into a padded shared tile
// by cp.async, 16 bytes a copy; rows >= n are zeros.
template <int D>
__device__ __forceinline__ void load_tile_async(uint16_t (*dst)[D + 8], const __nv_bfloat16* __restrict__ x,
                                                int r0, int n, int H) {
  constexpr int kPerRow = D / 8;
  constexpr int kCopies = kBlock * kPerRow / kMmaThreads;
#pragma unroll
  for (int i = 0; i < kCopies; ++i) {
    const int c = threadIdx.x + i * kMmaThreads;
    const int row = c / kPerRow, col = (c % kPerRow) * 8;
    const bool ok = r0 + row < n;
    cp_async16(&dst[row][col], x + (size_t)(ok ? r0 + row : 0) * H + col, ok);
  }
}

// The streamed tiles of the forward and dq kernels: K and V, two stages,
// and each key's (t, a, k) coordinates for the partial tiles.
template <int D>
struct KVStages {
  uint16_t k[2][kBlock][D + 8];
  uint16_t v[2][kBlock][D + 8];
  int t[2][kBlock], a[2][kBlock], kind[2][kBlock];

  __device__ __forceinline__ void fetch(int stage, int tile, const __nv_bfloat16* __restrict__ kp,
                                        const __nv_bfloat16* __restrict__ vp, int n, int H, const MaskSpec& s) {
    const int n0 = tile * kBlock;
    load_tile_async<D>(k[stage], kp, n0, n, H);
    load_tile_async<D>(v[stage], vp, n0, n, H);
    if (threadIdx.x < kBlock) {
      const int j = n0 + threadIdx.x;
      t[stage][threadIdx.x] = j / (s.A * s.K);
      a[stage][threadIdx.x] = (j / s.K) % s.A;
      kind[stage][threadIdx.x] = j % s.K;
    }
    cp_async_commit();
  }
};

// ---------------------------------------------------------------------------
// K3 (bf16): forward on tensor cores
// ---------------------------------------------------------------------------

template <int D, int NB>
__global__ void __launch_bounds__(kMmaThreads, fwd_min_blocks(D))
flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, const long long* __restrict__ seed_ptr,
                     const int* __restrict__ table, __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                     int n, int H, int heads, MaskSpec spec, float scale, float inv_keep,
                     uint32_t threshold, int use_dropout, int b_off) {
  __shared__ __align__(128) KVStages<D> sm;
  const TileRange tr(table + 5 * blockIdx.y);
  const int b = blockIdx.x / heads, h = blockIdx.x % heads;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = tr.tile * kBlock + warp * 16;
  const size_t base = (size_t)b * n * H + (size_t)h * D;
  const uint32_t bhs = (uint32_t)(b + b_off) * kHashB ^ (uint32_t)h * kHashH ^ (uint32_t)(*seed_ptr);
  const int ak = spec.A * spec.K;
  const float sl2 = scale * kLog2e;  // scores in log2 units

  int row[2], ti[2], ai[2];
  uint32_t rowh[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    row[r] = r0 + g + 8 * r;
    ti[r] = row[r] / ak;
    ai[r] = (row[r] / spec.K) % spec.A;
    rowh[r] = (uint32_t)row[r] * kHashRow ^ bhs;
  }
  if (tr.begin < tr.end) sm.fetch(0, tr.begin, k + base, v + base, n, H, spec);
  uint32_t qf[D / 16][4];
  load_a_frags<D / 16>(qf, q + base, r0, n, H, g, t);

  // running max (log2 units) and per-thread partial denominators of rows g, g + 8
  float acc[D / 8][4], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int db = 0; db < D / 8; ++db) acc[db][0] = acc[db][1] = acc[db][2] = acc[db][3] = 0.f;

  for (int tile = tr.begin, it = 0; tile < tr.end; ++tile, ++it) {
    const int st = it & 1;
    if (tile + 1 < tr.end) {
      sm.fetch(st ^ 1, tile + 1, k + base, v + base, n, H, spec);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bool partial = tr.partial(tile);

#pragma unroll
    for (int ch = 0; ch < kBlock / (8 * NB); ++ch) {  // 8 NB keys at a time
      const int c0 = 8 * NB * ch, n0 = tile * kBlock + c0;
      float s[NB][4];
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) s[nb][0] = s[nb][1] = s[nb][2] = s[nb][3] = 0.f;
      mma_a_tile_t<D, NB>(s, qf, sm.k[st] + c0, lane);

      // scores in log2 units; masked: -1e30, keys past T: -inf (no weight even in a masked row)
      if (partial) {
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = c0 + 8 * nb + 2 * t + e, j = n0 + 8 * nb + 2 * t + e;
            const int tj = sm.t[st][c], aj = sm.a[st][c], kj = sm.kind[st][c];
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              float& x = s[nb][2 * r + e];
              x = j >= n ? -INFINITY
                         : ((row[r] < n && visible(ti[r], ai[r], row[r], tj, aj, kj, j, spec)) ? x * sl2 : kMaskNeg);
            }
          }
      } else {
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
#pragma unroll
          for (int i = 0; i < 4; ++i) s[nb][i] *= sl2;
      }

      // online softmax on the fragments: rows g (r = 0) and g + 8 (r = 1)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = m[r];
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) mx = fmaxf(mx, fmaxf(s[nb][2 * r], s[nb][2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float mu = mx == -INFINITY ? 0.f : mx;
        const float alpha = fast_exp2(m[r] - mu);
        m[r] = mx;
        float sum = 0.f;
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) {
          s[nb][2 * r] = fast_exp2(s[nb][2 * r] - mu);
          s[nb][2 * r + 1] = fast_exp2(s[nb][2 * r + 1] - mu);
          sum += s[nb][2 * r] + s[nb][2 * r + 1];
        }
        l[r] = l[r] * alpha + sum;
#pragma unroll
        for (int db = 0; db < D / 8; ++db) {
          acc[db][2 * r] *= alpha;
          acc[db][2 * r + 1] *= alpha;
        }
      }
      if (use_dropout) {  // dropped weights stay in l, not in O
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const uint32_t ch_hash = (uint32_t)(n0 + 2 * t + e) * kHashCol;
#pragma unroll
          for (int nb = 0; nb < NB; ++nb)
#pragma unroll
            for (int r = 0; r < 2; ++r)
              if (!keep_hashed(rowh[r] ^ (ch_hash + (uint32_t)(8 * nb) * kHashCol), threshold))
                s[nb][2 * r + e] = 0.f;
        }
      }
      mma_p_tile<D, NB>(acc, s, sm.v[st] + c0, lane);
    }
    __syncthreads();  // stage st is consumed before the next fetch overwrites it
  }

  float mul[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    mul[r] = l[r] > 0.f ? inv_keep / l[r] : 0.f;
    if (t == 0 && row[r] < n) lse[((size_t)b * heads + h) * n + row[r]] = (m[r] + log2f(l[r])) * kLn2;
  }
  store_rows<D>(o + base, acc, row, mul, n, H, t);
}

// ---------------------------------------------------------------------------
// K4 (bf16), part 1: dQ per 64-query tile, and delta = rowsum(dO . O)
// ---------------------------------------------------------------------------

template <int D, int NB>
__global__ void __launch_bounds__(kMmaThreads, dq_min_blocks(D))
flash_bwd_dq_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ o,
                        const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
                        const long long* __restrict__ seed_ptr, const int* __restrict__ table,
                        __nv_bfloat16* __restrict__ dq, float* __restrict__ delta, int n, int H, int heads,
                        MaskSpec spec, float scale, float inv_keep, uint32_t threshold, int use_dropout,
                        int b_off) {
  __shared__ __align__(128) KVStages<D> sm;
  const TileRange tr(table + 5 * blockIdx.y);
  const int b = blockIdx.x / heads, h = blockIdx.x % heads;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = tr.tile * kBlock + warp * 16;
  const size_t base = (size_t)b * n * H + (size_t)h * D;
  const size_t lrow = ((size_t)b * heads + h) * n;  // this (b, h)'s row of lse and delta
  const uint32_t bhs = (uint32_t)(b + b_off) * kHashB ^ (uint32_t)h * kHashH ^ (uint32_t)(*seed_ptr);
  const int ak = spec.A * spec.K;
  const float sl2 = scale * kLog2e;
  const float dp_mul = scale * inv_keep;

  if (tr.begin < tr.end) sm.fetch(0, tr.begin, k + base, v + base, n, H, spec);
  uint32_t qf[D / 16][4], df[D / 16][4], of[D / 16][4];
  load_a_frags<D / 16>(qf, q + base, r0, n, H, g, t);
  load_a_frags<D / 16>(df, dout + base, r0, n, H, g, t);
  load_a_frags<D / 16>(of, o + base, r0, n, H, g, t);

  int row[2], ti[2], ai[2];
  uint32_t rowh[2];
  float lse2[2], dlt[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    row[r] = r0 + g + 8 * r;
    ti[r] = row[r] / ak;
    ai[r] = (row[r] / spec.K) % spec.A;
    rowh[r] = (uint32_t)row[r] * kHashRow ^ bhs;
    // delta from the fragments: this thread's columns of row r, summed over the quad
    float part = 0.f;
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const uint32_t dw = df[ks][r + 2 * half], ow = of[ks][r + 2 * half];
        const float2 dd = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&dw));
        const float2 oo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&ow));
        part += dd.x * oo.x + dd.y * oo.y;
      }
    part += __shfl_xor_sync(0xffffffffu, part, 1);
    part += __shfl_xor_sync(0xffffffffu, part, 2);
    dlt[r] = part * scale;  // delta s
    lse2[r] = row[r] < n ? lse[lrow + row[r]] * kLog2e : 0.f;
    if (t == 0 && row[r] < n) delta[lrow + row[r]] = part;
  }

  float acc[D / 8][4];
#pragma unroll
  for (int db = 0; db < D / 8; ++db) acc[db][0] = acc[db][1] = acc[db][2] = acc[db][3] = 0.f;

  for (int tile = tr.begin, it = 0; tile < tr.end; ++tile, ++it) {
    const int st = it & 1;
    if (tile + 1 < tr.end) {
      sm.fetch(st ^ 1, tile + 1, k + base, v + base, n, H, spec);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    const bool partial = tr.partial(tile);
#pragma unroll
    for (int ch = 0; ch < kBlock / (8 * NB); ++ch) {  // 8 NB keys at a time
      const int c0 = 8 * NB * ch, n0 = tile * kBlock + c0;
      float s[NB][4], dp[NB][4];
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[nb][i] = dp[nb][i] = 0.f;
      mma_a_tile_t<D, NB>(s, qf, sm.k[st] + c0, lane);
      mma_a_tile_t<D, NB>(dp, df, sm.v[st] + c0, lane);
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = c0 + 8 * nb + 2 * t + e, j = n0 + 8 * nb + 2 * t + e;
          const uint32_t ch_hash = (uint32_t)j * kHashCol;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int i = 2 * r + e;
            bool vis = true;
            if (partial)
              vis = j < n && row[r] < n &&
                    visible(ti[r], ai[r], row[r], sm.t[st][c], sm.a[st][c], sm.kind[st][c], j, spec);
            const float p = vis ? fast_exp2(fmaf(s[nb][i], sl2, -lse2[r])) : 0.f;
            float dps = dp[nb][i] * dp_mul;  // dP s, dropped entries 0
            if (use_dropout && !keep_hashed(rowh[r] ^ ch_hash, threshold)) dps = 0.f;
            s[nb][i] = p * (dps - dlt[r]);  // dS = P (dP - delta) s
          }
        }
      mma_p_tile<D, NB>(acc, s, sm.k[st] + c0, lane);  // dQ += dS K
    }
    __syncthreads();
  }
  const float one[2] = {1.f, 1.f};
  store_rows<D>(dq + base, acc, row, one, n, H, t);
}

// ---------------------------------------------------------------------------
// K4 (bf16), part 2: dK and dV per 64-key tile, over the query tiles that see it
// ---------------------------------------------------------------------------

// The streamed tiles of the dk/dv kernel: Q and dO, two stages, and each
// query's lse, delta and (t, a) coordinates.
template <int D>
struct QStages {
  uint16_t q[2][kBlock][D + 8];
  uint16_t dout[2][kBlock][D + 8];
  float lse[2][kBlock], delta[2][kBlock];
  int t[2][kBlock], a[2][kBlock];

  __device__ __forceinline__ void fetch(int stage, int tile, const __nv_bfloat16* __restrict__ qp,
                                        const __nv_bfloat16* __restrict__ dp, const float* __restrict__ lse_row,
                                        const float* __restrict__ delta_row, int n, int H, const MaskSpec& s) {
    const int m0 = tile * kBlock;
    load_tile_async<D>(q[stage], qp, m0, n, H);
    load_tile_async<D>(dout[stage], dp, m0, n, H);
    if (threadIdx.x < kBlock) {
      const int i = m0 + threadIdx.x;
      const bool ok = i < n;
      cp_async4(&lse[stage][threadIdx.x], lse_row + (ok ? i : 0), ok);
      cp_async4(&delta[stage][threadIdx.x], delta_row + (ok ? i : 0), ok);
      t[stage][threadIdx.x] = i / (s.A * s.K);
      a[stage][threadIdx.x] = (i / s.K) % s.A;
    }
    cp_async_commit();
  }
};

template <int D, int NB>
__global__ void __launch_bounds__(kMmaThreads, dkdv_min_blocks(D))
flash_bwd_dkdv_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          const long long* __restrict__ seed_ptr, const int* __restrict__ table,
                          __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int n, int H,
                          int heads, MaskSpec spec, float scale, float inv_keep, uint32_t threshold,
                          int use_dropout, int b_off) {
  __shared__ __align__(128) QStages<D> sm;
  const TileRange tr(table + 5 * blockIdx.y);
  const int b = blockIdx.x / heads, h = blockIdx.x % heads;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = tr.tile * kBlock + warp * 16;  // this warp's 16 keys
  const size_t base = (size_t)b * n * H + (size_t)h * D;
  const size_t lrow = ((size_t)b * heads + h) * n;
  const uint32_t bhs = (uint32_t)(b + b_off) * kHashB ^ (uint32_t)h * kHashH ^ (uint32_t)(*seed_ptr);
  const int ak = spec.A * spec.K;
  const float sl2 = scale * kLog2e;
  const float dp_mul = scale * inv_keep;

  if (tr.begin < tr.end) sm.fetch(0, tr.begin, q + base, dout + base, lse + lrow, delta + lrow, n, H, spec);
  uint32_t kf[D / 16][4], vf[D / 16][4];
  load_a_frags<D / 16>(kf, k + base, r0, n, H, g, t);
  load_a_frags<D / 16>(vf, v + base, r0, n, H, g, t);

  int key[2], tj[2], aj[2], kj[2];
  uint32_t keyh[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    key[r] = r0 + g + 8 * r;
    tj[r] = key[r] / ak;
    aj[r] = (key[r] / spec.K) % spec.A;
    kj[r] = key[r] % spec.K;
    keyh[r] = (uint32_t)key[r] * kHashCol ^ bhs;
  }

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int db = 0; db < D / 8; ++db)
#pragma unroll
    for (int i = 0; i < 4; ++i) dk_acc[db][i] = dv_acc[db][i] = 0.f;

  for (int tile = tr.begin, it = 0; tile < tr.end; ++tile, ++it) {
    const int st = it & 1;
    if (tile + 1 < tr.end) {
      sm.fetch(st ^ 1, tile + 1, q + base, dout + base, lse + lrow, delta + lrow, n, H, spec);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    const bool partial = tr.partial(tile);
#pragma unroll
    for (int ch = 0; ch < kBlock / (8 * NB); ++ch) {  // 8 NB queries at a time
      // S^T = K Q^T and dP^T = V dO^T: keys are rows, these queries columns
      const int c0 = 8 * NB * ch, m0 = tile * kBlock + c0;
      float s[NB][4], dp[NB][4];
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[nb][i] = dp[nb][i] = 0.f;
      mma_a_tile_t<D, NB>(s, kf, sm.q[st] + c0, lane);
      mma_a_tile_t<D, NB>(dp, vf, sm.dout[st] + c0, lane);
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        const int c = c0 + 8 * nb + 2 * t;
        const float2 lse_c = *reinterpret_cast<const float2*>(&sm.lse[st][c]);
        const float2 dlt_c = *reinterpret_cast<const float2*>(&sm.delta[st][c]);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = m0 + 8 * nb + 2 * t + e;
          const float lse2 = (e ? lse_c.y : lse_c.x) * kLog2e, dlt = (e ? dlt_c.y : dlt_c.x) * scale;
          const uint32_t qh = (uint32_t)i * kHashRow;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int x = 2 * r + e;
            bool vis = true;
            if (partial)
              vis = i < n && key[r] < n &&
                    visible(sm.t[st][c + e], sm.a[st][c + e], i, tj[r], aj[r], kj[r], key[r], spec);
            const float p = vis ? fast_exp2(fmaf(s[nb][x], sl2, -lse2)) : 0.f;
            float pd = p * inv_keep, dps = dp[nb][x] * dp_mul;
            if (use_dropout && !keep_hashed(qh ^ keyh[r], threshold)) pd = dps = 0.f;
            s[nb][x] = pd;               // dropout(P)^T
            dp[nb][x] = p * (dps - dlt);  // dS^T
          }
        }
      }
      mma_p_tile<D, NB>(dv_acc, s, sm.dout[st] + c0, lane);  // dV += dropout(P)^T dO
      mma_p_tile<D, NB>(dk_acc, dp, sm.q[st] + c0, lane);    // dK += dS^T Q
    }
    __syncthreads();
  }
  const float one[2] = {1.f, 1.f};
  store_rows<D>(dk + base, dk_acc, key, one, n, H, t);
  store_rows<D>(dv + base, dv_acc, key, one, n, H, t);
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

struct Args {
  const void *q, *k, *v, *o, *dout, *lse, *seed;
  const int* table;  // the bf16 kernels' tile schedule, [2, ceil(n / kBlock), 5]
  void *out, *lse_out, *dq, *dk, *dv, *delta;
  int B, n, H, heads;
  MaskSpec spec;
  float scale, inv_keep;
  uint32_t threshold;
  int use_dropout;
  int b_off;  // the launch's first row in a global batch, added to b in the dropout hash
};

template <typename T, int D>
cudaError_t run_fwd(const Args& a, cudaStream_t stream) {
  const dim3 grid(a.B * a.heads, (a.n + kTile - 1) / kTile);
  flash_fwd_kernel<T, D><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const long long*>(a.seed), static_cast<T*>(a.out), static_cast<float*>(a.lse_out),
      a.n, a.H, a.heads, a.spec, a.scale, a.inv_keep, a.threshold, a.use_dropout, a.b_off);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t run_bwd(const Args& a, cudaStream_t stream) {
  const dim3 grid(a.B * a.heads, (a.n + kTile - 1) / kTile);
  flash_bwd_dq_kernel<T, D><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.o), static_cast<const T*>(a.dout), static_cast<const float*>(a.lse),
      static_cast<const long long*>(a.seed), static_cast<T*>(a.dq), static_cast<float*>(a.delta),
      a.n, a.H, a.heads, a.spec, a.scale, a.inv_keep, a.threshold, a.use_dropout, a.b_off);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dkdv_kernel<T, D><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<const long long*>(a.seed),
      static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.n, a.H, a.heads, a.spec, a.scale,
      a.inv_keep, a.threshold, a.use_dropout, a.b_off);
  return cudaGetLastError();
}

template <int D>
cudaError_t run_fwd_mma(const Args& a, cudaStream_t stream) {
  const dim3 grid(a.B * a.heads, (a.n + kBlock - 1) / kBlock);
  flash_fwd_mma_kernel<D, kFwdNB><<<grid, kMmaThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(a.q), static_cast<const __nv_bfloat16*>(a.k),
      static_cast<const __nv_bfloat16*>(a.v), static_cast<const long long*>(a.seed), a.table,
      static_cast<__nv_bfloat16*>(a.out), static_cast<float*>(a.lse_out), a.n, a.H, a.heads, a.spec,
      a.scale, a.inv_keep, a.threshold, a.use_dropout, a.b_off);
  return cudaGetLastError();
}

template <int D>
cudaError_t run_bwd_mma(const Args& a, cudaStream_t stream) {
  const int tiles = (a.n + kBlock - 1) / kBlock;
  const dim3 grid(a.B * a.heads, tiles);
  flash_bwd_dq_mma_kernel<D, kDqNB><<<grid, kMmaThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(a.q), static_cast<const __nv_bfloat16*>(a.k),
      static_cast<const __nv_bfloat16*>(a.v), static_cast<const __nv_bfloat16*>(a.o),
      static_cast<const __nv_bfloat16*>(a.dout), static_cast<const float*>(a.lse),
      static_cast<const long long*>(a.seed), a.table, static_cast<__nv_bfloat16*>(a.dq),
      static_cast<float*>(a.delta), a.n, a.H, a.heads, a.spec, a.scale, a.inv_keep, a.threshold,
      a.use_dropout, a.b_off);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dkdv_mma_kernel<D, kDkdvNB><<<grid, kMmaThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(a.q), static_cast<const __nv_bfloat16*>(a.k),
      static_cast<const __nv_bfloat16*>(a.v), static_cast<const __nv_bfloat16*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<const long long*>(a.seed), a.table + 5 * tiles, static_cast<__nv_bfloat16*>(a.dk),
      static_cast<__nv_bfloat16*>(a.dv), a.n, a.H, a.heads, a.spec, a.scale, a.inv_keep, a.threshold,
      a.use_dropout, a.b_off);
  return cudaGetLastError();
}

// bf16 on the tensor cores, f32 on the CUDA cores
template <int D>
cudaError_t run(bool backward, bool bf16, const Args& a, cudaStream_t stream) {
  if (bf16) return backward ? run_bwd_mma<D>(a, stream) : run_fwd_mma<D>(a, stream);
  return backward ? run_bwd<float, D>(a, stream) : run_fwd<float, D>(a, stream);
}

cudaError_t dispatch(bool backward, bool bf16, const Args& a, cudaStream_t stream) {
  if (bf16 && a.table == nullptr) return cudaErrorInvalidValue;
  switch (a.H / a.heads) {
    case 16: return run<16>(backward, bf16, a, stream);
    case 32: return run<32>(backward, bf16, a, stream);
    case 64: return run<64>(backward, bf16, a, stream);
    default: return cudaErrorInvalidValue;
  }
}

// H is the row width of the (head-padded) tensors, head_dim the true width
// of a head: the softmax scale is that of the true width
Args make_args(int B, int n, int H, int heads, int head_dim, int A, int K, int state_index, int own,
               int has_window, int window, float dropout_p, unsigned threshold) {
  Args a = {};
  a.B = B;
  a.n = n;
  a.H = H;
  a.heads = heads;
  a.spec = MaskSpec{A, K, state_index, own, has_window, window};
  a.scale = 1.0f / sqrtf((float)head_dim);
  a.use_dropout = dropout_p > 0.f;
  a.inv_keep = a.use_dropout ? 1.0f / (1.0f - dropout_p) : 1.0f;
  a.threshold = threshold;
  return a;
}

bool bad_shape(int B, int n, int H, int heads, int head_dim, int A, int K) {
  return B <= 0 || n <= 0 || heads <= 0 || H % heads != 0 || head_dim <= 0 || head_dim > H / heads ||
         A <= 0 || K <= 0;
}

}  // namespace

// K3. q, k, v, out [B, n, H] contiguous and 16-byte aligned on the device,
// H = heads x an instantiated head width (16, 32 or 64), of which the first
// head_dim columns of each head are the true ones (the rest zero),
// of one type: float32 (is_bf16 = 0, CUDA cores) or bfloat16 (is_bf16 = 1,
// tensor cores); lse [B, heads, n] float32; seed one int64 on the device
// (its low 32 bits key the dropout hash; read only when dropout_p > 0 but
// always a valid pointer); b_offset is added to the batch index in the hash
// (a data-parallel rank's first row of the global batch, else 0).
// threshold = min(int((1 - dropout_p) * 2^32),
// 2^32 - 1). table: for bf16, the int32 [2, ceil(n / 64), 5] tile schedule
// of ops/flash_attention.py:tile_table for this mask and n, on the device;
// unused (may be null) for float32. Returns the cudaError_t of the launch.
extern "C" int ctrl_sim_flash_fwd(const void* q, const void* k, const void* v, const void* seed,
                                  const void* table, void* out, void* lse, int B, int n, int H,
                                  int heads, int head_dim, int A, int K, int state_index, int own,
                                  int has_window, int window, int b_offset, float dropout_p,
                                  unsigned threshold, int is_bf16, void* stream) {
  if (bad_shape(B, n, H, heads, head_dim, A, K)) return (int)cudaErrorInvalidValue;
  Args a = make_args(B, n, H, heads, head_dim, A, K, state_index, own, has_window, window, dropout_p,
                     threshold);
  a.q = q;
  a.k = k;
  a.v = v;
  a.seed = seed;
  a.b_off = b_offset;
  a.table = static_cast<const int*>(table);
  a.out = out;
  a.lse_out = lse;
  return (int)dispatch(false, is_bf16 != 0, a, static_cast<cudaStream_t>(stream));
}

// K4. As K3, plus o and dout [B, n, H] (the forward's output and its
// gradient), lse from K3; writes dq, dk, dv [B, n, H] in the inputs' type
// and uses delta [B, heads, n] float32 as scratch. Two launches on one
// stream; returns the first error.
extern "C" int ctrl_sim_flash_bwd(const void* q, const void* k, const void* v, const void* o,
                                  const void* dout, const void* lse, const void* seed, const void* table,
                                  void* dq, void* dk, void* dv, void* delta, int B, int n, int H,
                                  int heads, int head_dim, int A, int K, int state_index, int own,
                                  int has_window, int window, int b_offset, float dropout_p,
                                  unsigned threshold, int is_bf16, void* stream) {
  if (bad_shape(B, n, H, heads, head_dim, A, K)) return (int)cudaErrorInvalidValue;
  Args a = make_args(B, n, H, heads, head_dim, A, K, state_index, own, has_window, window, dropout_p,
                     threshold);
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.dout = dout;
  a.lse = lse;
  a.seed = seed;
  a.b_off = b_offset;
  a.table = static_cast<const int*>(table);
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  a.delta = delta;
  return (int)dispatch(true, is_bf16 != 0, a, static_cast<cudaStream_t>(stream));
}
