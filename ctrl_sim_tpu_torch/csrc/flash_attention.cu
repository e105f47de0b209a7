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
// 0.2 ms a pass at 64 per SM per clock), which only the forward computes:
// it saves the bits for the backward.
//
// bf16: Hopper's tensor cores, fed by TMA, warp-specialised
// (flash_*_wgmma_kernel; building blocks in wgmma_sm90.cuh). A block owns
// one 64-row tile (queries in the forward and dq kernels, keys in the dk/dv
// kernel) and walks the 64-row tiles of the other side that the tile
// schedule gives it. It has 256 threads: one consumer warpgroup (16 of the
// tile's rows a warp) and one producer warpgroup, which setmaxnreg cuts to
// 24 registers a thread (40 in the forward) so that the consumers get the
// rest (setmaxnreg acts on whole warpgroups: on a lone warp the card
// raises an illegal instruction).
// - The producer's first warp loads the block's fixed tiles once (Q; Q and
//   dO; K and V) and streams the other side's tile pairs (K and V; Q and
//   dO) through a ring of 3 stages in shared memory, each a TMA load of 64
//   rows x the head's D columns of a [B, n, H] tensor map (3-D, so rows
//   past n come in as zeros), swizzled by the row's span, completing on the
//   stage's full mbarrier. In the backward it also copies, by cp.async
//   tracked by the same barrier, the dk/dv kernel's lse and delta and the
//   pair's dropout keep words, and writes the streamed rows' (t, a, k)
//   coordinates for a partial tile; the other three warps leave.
// - In the forward all four producer warps stay: each of the 128 threads
//   computes one 32-bit word of the stage's tile pair (query row, 32 keys):
//   with dropout its keep bits (the murmur3 hash, 32 of them in four
//   independent chains, also written to the saved mask), and on a partial
//   tile its visibility bits (the mask predicate a word at a time, from
//   prefix masks and the agent's and state type's patterns: visible_keys).
//   The hash and the mask run beside the consumers' softmax instead of in it.
// - The consumers run every product as wgmma m64nNk16 (fp32 accumulators):
//   S = Q K^T with both operands in shared memory, then O += P V with P,
//   rounded to bf16, as the A operand in registers and V transposed by the
//   instruction; the backward's dP = dO V^T, dQ += dS K, dV += P^T dO and
//   dK += dS^T Q alike. The online softmax and the mask work on the
//   accumulators (rows g and g + 8 of a warp's 16, quad shuffles, tree
//   reductions), branch-free: masked pairs are set once on a partial tile,
//   and without dropout the backward's keep words are all ones.
// - Softmax overlaps the products across blocks: 3 blocks share an SM in
//   the forward (2 at d = 64) and 2 in the backward, so one warpgroup's
//   exps run while another's wgmma does. What bounds them is then the
//   per-element work on the CUDA cores: one exp per admitted element and
//   pass (K3 one pass, K4 two), and in the forward with dropout the murmur3
//   keep bit.
// - Dropout keep bits are hashed once, in the forward, which writes them
//   packed (bit j % 32 of word j / 32 of query row i) for the tile pairs it
//   walks; both backward kernels walk the same pairs and read them, so K4
//   runs no hash.
// - The tile schedule comes from the wrapper (ops/flash_attention.py:
//   tile_table): per 64-row tile, the range of tiles of the other side that
//   hold a visible pair, and within it the run of fully visible tiles, where
//   the predicate is not evaluated at all; tiles outside the range are never
//   touched. With the default mask every key of an earlier timestep is
//   visible, so only the tiles on a query tile's own timestep are partial.
//   Entries run heaviest first, so the longest blocks start first.
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
#include "wgmma_sm90.cuh"

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

// Bits k < 32 set where k < bits (clamped).
__device__ __forceinline__ uint32_t prefix_bits(int bits) {
  return bits <= 0 ? 0u : bits >= 32 ? ~0u : (1u << bits) - 1u;
}

// visible() of query i (timestep ti, agent ai) over the 32 keys j0 + k, as
// bit k: the mask a word at a time, from prefix masks and the patterns of
// the query's agent and of the state type. tj0 = j0 / (A K) and kind0 = j0 %
// K come from the caller; keys past T are the caller's.
__device__ __forceinline__ uint32_t visible_keys(int i, int ti, int ai, int j0, int tj0, int kind0,
                                                 const MaskSpec& s) {
  const int ak = s.A * s.K;
  uint32_t agent = 0u;  // aj == ai: keys t ak + ai K + [0, K)
  for (int t = tj0; t * ak < j0 + 32; ++t) {
    const int lo = t * ak + ai * s.K - j0;
    agent |= prefix_bits(lo + s.K) & ~prefix_bits(lo);
  }
  uint32_t state = 0u;  // kj == state_index
  for (int k = (s.state_index - kind0 + s.K) % s.K; k < 32; k += s.K) state |= 1u << k;
  const uint32_t lt_t = prefix_bits(ti * ak - j0);           // tj < ti
  uint32_t base = prefix_bits(i + 1 - j0) & (lt_t | agent);  // jj <= ii
  if (s.own) base &= ~(lt_t & ~agent & ~state);
  uint32_t out = (state & prefix_bits((ti + 1) * ak - j0)) | base;  // state tokens of tj <= ti
  if (s.has_window) out &= ~prefix_bits((ti - s.window + 1) * ak - j0);  // tj > ti - window
  return out;
}

// flash_attention.py:_dropout_keep: the murmur3 finalizer over
// (row * kHashRow) ^ (col * kHashCol) ^ (b * kHashB) ^ (h * kHashH) ^ seed.
// The tensor-core kernels build that word from per-row and per-column parts.
constexpr uint32_t kHashRow = 0x9E3779B1u, kHashCol = 0x85EBCA77u;
constexpr uint32_t kHashB = 0xC2B2AE3Du, kHashH = 0x27D4EB2Fu;

// The finalizer after its first step, x ^ (x >> 16), which distributes over
// the xor of a row part and a column part, so callers may apply it to each.
__device__ __forceinline__ bool keep_mixed(uint32_t x, uint32_t threshold) {
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x < threshold;
}

__device__ __forceinline__ bool keep_hashed(uint32_t x, uint32_t threshold) {
  return keep_mixed(x ^ (x >> 16), threshold);
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
// bf16 on Hopper: TMA, wgmma, warp specialisation (wgmma_sm90.cuh)
// ---------------------------------------------------------------------------

constexpr int kBlock = kTileRows;  // rows per block and rows per streamed tile
constexpr int kConsumerThreads = 128;  // one warpgroup: 16 of the block's rows a warp
// and a producer warpgroup (setmaxnreg acts on whole warpgroups), of which
// one warp loads; the other three hash and mask in the forward and leave at
// once in the backward
constexpr int kWsThreads = kConsumerThreads + 128;
constexpr int kStages = 3;  // streamed tile pairs in flight
constexpr int kProducerRegs = 24;      // the backward's loader warp
constexpr int kFwdProducerRegs = 40;   // the forward's producers, which also hash and mask

// Blocks an SM must hold (__launch_bounds__), chosen so that the consumers
// do not spill: the forward keeps 32 fp32 scores and D / 4 accumulators a
// thread, the backward kernels twice the scores and one or two accumulators.
__host__ __device__ constexpr int fwd_min_blocks(int D) { return D > 32 ? 2 : 3; }
__host__ __device__ constexpr int bwd_min_blocks(int) { return 2; }
// The registers a thread gets at launch, as ptxas allocates them under those
// bounds (its report, and cudaFuncGetAttributes before the first launch,
// which refuses a kernel that gets fewer), and what the consumer warpgroup
// takes once the producer warpgroup has dropped to producer_regs: the
// block's registers at launch pay for both.
__host__ __device__ constexpr int fwd_entry_regs(int D) { return D > 32 ? 128 : 80; }
__host__ __device__ constexpr int bwd_entry_regs(int) { return 128; }
__host__ __device__ constexpr int consumer_regs(int entry, int producer_regs) {
  return (kWsThreads * entry - (kWsThreads - kConsumerThreads) * producer_regs) / kConsumerThreads / 8 * 8;
}

// One entry of the wrapper's tile table: the block's own tile, and the range
// [begin, end) of tiles of the other side it walks, of which [full_begin,
// full_end) are fully visible.
struct TileRange {
  int tile, begin, full_begin, full_end, end;
  __device__ __forceinline__ explicit TileRange(const int* __restrict__ e)
      : tile(e[0]), begin(e[1]), full_begin(e[2]), full_end(e[3]), end(e[4]) {}
  __device__ __forceinline__ bool partial(int t) const { return t < full_begin || t >= full_end; }
};

// What the producer warp writes beside a streamed tile pair, per streamed
// row j: on partial tiles its (t, a, k) coordinates, in the
// dk/dv kernel the query's lse and delta (copied by cp.async), and in the backward
// the two dropout keep words of the tile pair (all ones without dropout),
// for the query rows of the pair (the fixed tile's in the dq kernel, the
// streamed tile's in dk/dv).
struct StageRows {
  int t[kBlock], a[kBlock], kind[kBlock];
  float lse[kBlock], dlt[kBlock];
  uint32_t bits[kBlock][2];
  uint32_t vis[kBlock][2];  // the forward's partial tiles: bit k of word w of row r, key 32 w + k visible
};

// The block's shared memory: NF fixed tiles (loaded once), the ring of
// streamed tile pairs and their rows, and the barriers. Tiles are whole
// multiples of 1024 bytes from a 1024-aligned base.
template <int D, int NF>
struct WsSmem {
  uint16_t fixed[NF][kBlock * D];
  uint16_t ring[kStages][2][kBlock * D];
  StageRows rows[kStages];
  uint64_t fixed_full, full[kStages], empty[kStages];
};

template <int D, int NF>
constexpr size_t ws_smem_bytes() {
  return sizeof(WsSmem<D, NF>) + 1024;  // slack to align the base
}

// The block's shared memory, initialised: fixed_full completes on the
// fixed tiles' bytes; full[s] on the arrivals of the producer threads that
// work (32, or 128 when the forward hashes keep bits) after they wrote stage
// s's rows, plus one arrival with the bytes of the stage's two TMA loads;
// empty[s] on one arrival per consumer warp done with stage s.
template <int D, int NF>
__device__ __forceinline__ WsSmem<D, NF>& ws_smem_init(int producers) {
  extern __shared__ __align__(16) uint8_t ws_raw[];
  // aligned by pointer arithmetic on the shared array, so that the compiler
  // keeps shared-memory loads (LDS), not generic ones
  uint8_t* base = ws_raw + ((1024 - (smem_addr(ws_raw) & 1023)) & 1023);
  WsSmem<D, NF>& sm = *reinterpret_cast<WsSmem<D, NF>*>(base);
  if (threadIdx.x == 0) {
    mbar_init(&sm.fixed_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sm.full[s], 1 + producers);
      mbar_init(&sm.empty[s], kConsumerThreads / 32);
    }
    mbar_fence_init();
  }
  __syncthreads();
  return sm;
}

enum class Pass { kFwd, kDq, kDkdv };

// What the forward's producer warpgroup computes beside the loads.
struct FwdWords {
  bool dropout;
  uint32_t bhs, threshold;  // the keep hash's (b, h, seed) part, and its keep threshold
  uint32_t* keep_bh;        // this (b, h)'s [n, words] keep words to write, or null
};

// The producer warpgroup: its first warp loads the fixed tiles once, then
// for each streamed tile of the range, once the consumers released its
// stage, the two streamed tiles by TMA (lane 0) and the stage's rows. In
// the forward (fwd not null) every one of its 128 threads also computes one
// word of the tile pair, query row pt / 2 and keys 32 (pt % 2) on: with
// dropout its keep bits (the murmur3 hash, into the stage and the saved
// mask), and on a partial tile its visibility bits. The first warp returns when the
// consumers released the last stages. The streamed tiles are K and V
// (forward, dq) or Q and dO (dk/dv); lse_row and delta_row (dk/dv) and
// keep_bh (backward with dropout: this (b, h)'s [n, words] keep words) may
// be null.
template <Pass P, int D, int NF>
__device__ __forceinline__ void produce(WsSmem<D, NF>& sm, const TileRange& tr, const CUtensorMap* const (&fixed)[NF],
                                        const CUtensorMap* s0, const CUtensorMap* s1, int b, int h, int n,
                                        const MaskSpec& spec, const float* __restrict__ lse_row,
                                        const float* __restrict__ delta_row, const uint32_t* __restrict__ keep_bh,
                                        int words, const FwdWords* fwd = nullptr) {
  const int pt = threadIdx.x - kConsumerThreads, lane = pt & 31;
  const bool loader = pt < 32;
  const int ak = spec.A * spec.K;
  // the forward's visibility word: its query row and that row's coordinates
  const int qi = tr.tile * kBlock + (pt >> 1), qt = qi / ak, qa = (qi / spec.K) % spec.A;
  if (pt == 0) {
    tma_prefetch_map(s0);
    tma_prefetch_map(s1);
    mbar_arrive_expect_tx(&sm.fixed_full, NF * tile_bytes<D>());
#pragma unroll
    for (int f = 0; f < NF; ++f) tma_load_tile(sm.fixed[f], fixed[f], h * D, tr.tile * kBlock, b, &sm.fixed_full);
  }
  for (int tile = tr.begin, it = 0; tile < tr.end; ++tile, ++it) {
    const int st = it % kStages;
    mbar_wait(&sm.empty[st], ((it / kStages) & 1) ^ 1);  // the first round finds every stage free
    if (pt == 0) {
      mbar_arrive_expect_tx(&sm.full[st], 2 * tile_bytes<D>());
      tma_load_tile(sm.ring[st][0], s0, h * D, tile * kBlock, b, &sm.full[st]);
      tma_load_tile(sm.ring[st][1], s1, h * D, tile * kBlock, b, &sm.full[st]);
    }
    StageRows& rows = sm.rows[st];
    // device-memory rows by cp.async (zeros past n), which the stage's
    // phase waits for; the rest by stores before this lane's arrival
    if (loader && (P == Pass::kDkdv || (P == Pass::kDq && keep_bh != nullptr))) {
#pragma unroll
      for (int r = lane; r < kBlock; r += 32) {
        const int j = tile * kBlock + r;
        if (P == Pass::kDkdv) {
          cp_async4(&rows.lse[r], lse_row + (j < n ? j : 0), j < n);
          cp_async4(&rows.dlt[r], delta_row + (j < n ? j : 0), j < n);
        }
        if (keep_bh != nullptr) {
          const int i = (P == Pass::kDq ? tr.tile : tile) * kBlock + r;  // the query row
          const int w = 2 * (P == Pass::kDq ? tile : tr.tile);           // the key tile's first word
          const uint32_t* src = keep_bh + (size_t)(i < n ? i : 0) * words + w;
          cp_async4(&rows.bits[r][0], src, i < n);
          cp_async4(&rows.bits[r][1], src + (w + 1 < words ? 1 : 0), i < n && w + 1 < words);
        }
      }
      mbar_track_cp_async(&sm.full[st]);
    }
    const bool partial = tr.partial(tile);
    for (int r = lane; loader && P != Pass::kFwd && r < kBlock; r += 32) {
      const int j = tile * kBlock + r;
      if (partial) {
        rows.t[r] = j / ak;
        rows.a[r] = (j / spec.K) % spec.A;
        rows.kind[r] = j % spec.K;
      }
      if (P != Pass::kFwd && keep_bh == nullptr) rows.bits[r][0] = rows.bits[r][1] = ~0u;  // no dropout
    }
    if (P == Pass::kFwd) {
      const int j0 = tile * kBlock + 32 * (pt & 1);
      if (fwd->dropout) {  // 32 hashes in four independent chains; no bits for keys past T
        uint32_t part[4] = {0u, 0u, 0u, 0u};
        if (qi < n) {
          const uint32_t rowh = (uint32_t)qi * kHashRow ^ fwd->bhs, rowmix = rowh ^ (rowh >> 16);
          const uint32_t col0 = (uint32_t)j0 * kHashCol;
#pragma unroll
          for (int k = 0; k < 32; ++k) {
            const uint32_t col = col0 + (uint32_t)k * kHashCol;
            if (keep_mixed(rowmix ^ col ^ (col >> 16), fwd->threshold)) part[k & 3] |= 1u << k;
          }
        }
        const uint32_t word = (part[0] | part[1] | part[2] | part[3]) & prefix_bits(n - j0);
        const int w = j0 / 32;
        if (qi < n && fwd->keep_bh != nullptr && w < words) fwd->keep_bh[(size_t)qi * words + w] = word;
        rows.bits[pt >> 1][pt & 1] = word;
      }
      if (partial)
        rows.vis[pt >> 1][pt & 1] = qi < n ? visible_keys(qi, qt, qa, j0, j0 / ak, j0 % spec.K, spec) : 0u;
    }
    mbar_arrive(&sm.full[st]);
  }
  if (!loader) return;
  // the loader leaves only once the consumers released every stage it filled
  const int count = tr.end - tr.begin;
  for (int it = count > kStages ? count - kStages : 0; it < count; ++it)
    mbar_wait(&sm.empty[it % kStages], (it / kStages) & 1);
}

// ---------------------------------------------------------------------------
// K3 (bf16): forward
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kWsThreads, fwd_min_blocks(D))
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
                       const __grid_constant__ CUtensorMap v_map, const long long* __restrict__ seed_ptr,
                       const int* __restrict__ table, __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                       uint32_t* __restrict__ keep, int n, int H, int heads, MaskSpec spec, float scale,
                       float inv_keep, uint32_t threshold, int use_dropout, int b_off) {
  WsSmem<D, 1>& sm = ws_smem_init<D, 1>(kWsThreads - kConsumerThreads);
  const TileRange tr(table + 5 * blockIdx.y);
  const int b = blockIdx.x / heads, h = blockIdx.x % heads;
  const int words = (n + 31) / 32;
  if (threadIdx.x >= kConsumerThreads) {
    setmaxnreg_dec<kFwdProducerRegs>();
    const size_t bh = (size_t)b * heads + h;
    const FwdWords fwd{use_dropout != 0, (uint32_t)(b + b_off) * kHashB ^ (uint32_t)h * kHashH ^ (uint32_t)(*seed_ptr),
                       threshold, keep == nullptr ? nullptr : keep + bh * n * words};
    const CUtensorMap* fixed[1] = {&q_map};
    produce<Pass::kFwd, D, 1>(sm, tr, fixed, &k_map, &v_map, b, h, n, spec, nullptr, nullptr, nullptr, words, &fwd);
    return;
  }
  setmaxnreg_inc<consumer_regs(fwd_entry_regs(D), kFwdProducerRegs)>();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = tr.tile * kBlock + warp * 16;
  const size_t base = (size_t)b * n * H + (size_t)h * D;
  const size_t bh = (size_t)b * heads + h;
  const float sl2 = scale * kLog2e;  // scores in log2 units

  int row[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) row[r] = r0 + g + 8 * r;
  // running max (log2 units) and per-thread partial denominators of rows g, g + 8
  float acc[D / 8][4], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  zero(acc);
  mbar_wait(&sm.fixed_full, 0);

  for (int tile = tr.begin, it = 0; tile < tr.end; ++tile, ++it) {
    const int st = it % kStages;
    mbar_wait(&sm.full[st], (it / kStages) & 1);
    float s[kBlock / 8][4];
    zero(s);
    fence_regs(s);
    wgmma_fence();
    product_ss<D>(s, sm.fixed[0], sm.ring[st][0]);  // S = Q K^T
    wgmma_commit();

    const int n0 = tile * kBlock;
    wgmma_wait<0>();
    fence_regs(s);

    const StageRows& rows = sm.rows[st];
    // scores in log2 units; masked: -1e30, keys past T: -inf (no weight even in a masked row)
    if (tr.partial(tile)) {
      uint32_t vw[2][2];  // the visibility words of rows g, g + 8, shifted to this thread's first column
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int w = 0; w < 2; ++w) vw[r][w] = rows.vis[warp * 16 + g + 8 * r][w] >> (2 * t);
#pragma unroll
      for (int nb = 0; nb < kBlock / 8; ++nb)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool past = n0 + 8 * nb + 2 * t + e >= n;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            float& x = s[nb][2 * r + e];
            x = past ? -INFINITY : ((vw[r][nb / 4] >> ((8 * nb + e) & 31)) & 1u) ? x * sl2 : kMaskNeg;
          }
        }
    } else {
#pragma unroll
      for (int nb = 0; nb < kBlock / 8; ++nb)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[nb][i] *= sl2;
    }

    // online softmax on the accumulators: rows g (r = 0) and g + 8 (r = 1)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float v[kBlock / 8];  // reductions as trees: short dependency chains
#pragma unroll
      for (int nb = 0; nb < kBlock / 8; ++nb) v[nb] = fmaxf(s[nb][2 * r], s[nb][2 * r + 1]);
#pragma unroll
      for (int w = kBlock / 16; w > 0; w /= 2)
#pragma unroll
        for (int i = 0; i < w; ++i) v[i] = fmaxf(v[i], v[i + w]);
      float mx = fmaxf(m[r], v[0]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float mu = mx == -INFINITY ? 0.f : mx;
      const float alpha = fast_exp2(m[r] - mu);
      m[r] = mx;
#pragma unroll
      for (int nb = 0; nb < kBlock / 8; ++nb) {
        s[nb][2 * r] = fast_exp2(s[nb][2 * r] - mu);
        s[nb][2 * r + 1] = fast_exp2(s[nb][2 * r + 1] - mu);
        v[nb] = s[nb][2 * r] + s[nb][2 * r + 1];
      }
#pragma unroll
      for (int w = kBlock / 16; w > 0; w /= 2)
#pragma unroll
        for (int i = 0; i < w; ++i) v[i] += v[i + w];
      l[r] = l[r] * alpha + v[0];
#pragma unroll
      for (int db = 0; db < D / 8; ++db) {
        acc[db][2 * r] *= alpha;
        acc[db][2 * r + 1] *= alpha;
      }
    }
    if (use_dropout) {  // dropped weights stay in l, not in O
      uint32_t kw[2][2];  // the keep words of rows g, g + 8, shifted to this thread's first column
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int w = 0; w < 2; ++w) kw[r][w] = rows.bits[warp * 16 + g + 8 * r][w] >> (2 * t);
#pragma unroll
      for (int nb = 0; nb < kBlock / 8; ++nb)
#pragma unroll
        for (int e = 0; e < 2; ++e)
#pragma unroll
          for (int r = 0; r < 2; ++r)
            if (!((kw[r][nb / 4] >> ((8 * nb + e) & 31)) & 1u)) s[nb][2 * r + e] = 0.f;
    }

    uint32_t pa[kBlock / 16][4];
    a_frags(pa, s);
    fence_regs(acc);
    fence_regs(pa);
    wgmma_fence();
    product_rs<D>(acc, pa, sm.ring[st][1]);  // O += P V
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    release(&sm.empty[st]);
  }

  float mul[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    mul[r] = l[r] > 0.f ? inv_keep / l[r] : 0.f;
    if (t == 0 && row[r] < n) lse[bh * n + row[r]] = (m[r] + log2f(l[r])) * kLn2;
  }
  store_rows<D>(o + base, acc, row, mul, n, H, t);
}

// ---------------------------------------------------------------------------
// K4 (bf16), part 1: dQ per 64-query tile, and delta = rowsum(dO . O)
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kWsThreads, bwd_min_blocks(D))
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
                          const __grid_constant__ CUtensorMap v_map, const __grid_constant__ CUtensorMap do_map,
                          const __nv_bfloat16* __restrict__ o, const __nv_bfloat16* __restrict__ dout,
                          const float* __restrict__ lse, const uint32_t* __restrict__ keep,
                          const int* __restrict__ table, __nv_bfloat16* __restrict__ dq, float* __restrict__ delta,
                          int n, int H, int heads, MaskSpec spec, float scale, float inv_keep, int use_dropout) {
  WsSmem<D, 2>& sm = ws_smem_init<D, 2>(32);
  const TileRange tr(table + 5 * blockIdx.y);
  const int b = blockIdx.x / heads, h = blockIdx.x % heads;
  const size_t bh = (size_t)b * heads + h;
  const int words = (n + 31) / 32;
  if (threadIdx.x >= kConsumerThreads) {
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x >= kConsumerThreads + 32) return;
    const CUtensorMap* fixed[2] = {&q_map, &do_map};
    produce<Pass::kDq, D, 2>(sm, tr, fixed, &k_map, &v_map, b, h, n, spec, nullptr, nullptr,
                             use_dropout ? keep + bh * n * words : nullptr, words);
    return;
  }
  setmaxnreg_inc<consumer_regs(bwd_entry_regs(D), kProducerRegs)>();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = tr.tile * kBlock + warp * 16;
  const size_t base = (size_t)b * n * H + (size_t)h * D;
  const int ak = spec.A * spec.K;
  const float sl2 = scale * kLog2e;
  const float dp_mul = scale * inv_keep;

  int row[2], ti[2], ai[2];
  float lse2[2], dlt[2];
  {
    uint32_t df[D / 16][4], of[D / 16][4];
    load_a_frags<D / 16>(df, dout + base, r0, n, H, g, t);
    load_a_frags<D / 16>(of, o + base, r0, n, H, g, t);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      row[r] = r0 + g + 8 * r;
      ti[r] = row[r] / ak;
      ai[r] = (row[r] / spec.K) % spec.A;
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
      lse2[r] = row[r] < n ? lse[bh * n + row[r]] * kLog2e : 0.f;
      if (t == 0 && row[r] < n) delta[bh * n + row[r]] = part;
    }
  }

  float acc[D / 8][4];
  zero(acc);
  mbar_wait(&sm.fixed_full, 0);

  for (int tile = tr.begin, it = 0; tile < tr.end; ++tile, ++it) {
    const int st = it % kStages;
    mbar_wait(&sm.full[st], (it / kStages) & 1);
    float s[kBlock / 8][4], dp[kBlock / 8][4];
    zero(s);
    zero(dp);
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
    product_ss<D>(s, sm.fixed[0], sm.ring[st][0]);   // S = Q K^T
    product_ss<D>(dp, sm.fixed[1], sm.ring[st][1]);  // dP = dO V^T
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);

    const int n0 = tile * kBlock;
    const StageRows& rows = sm.rows[st];
    if (tr.partial(tile)) {  // hidden pairs: score -inf, weight exp2(-inf) = 0
#pragma unroll
      for (int nb = 0; nb < kBlock / 8; ++nb)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * nb + 2 * t + e, j = n0 + c;
          const int tj = rows.t[c], aj = rows.a[c], kj = rows.kind[c];
#pragma unroll
          for (int r = 0; r < 2; ++r)
            if (!(j < n && row[r] < n && visible(ti[r], ai[r], row[r], tj, aj, kj, j, spec)))
              s[nb][2 * r + e] = -INFINITY;
        }
    }
    uint32_t kw[2][2];  // the keep words of rows g, g + 8, shifted to this thread's first column
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int w = 0; w < 2; ++w) kw[r][w] = rows.bits[warp * 16 + g + 8 * r][w] >> (2 * t);
#pragma unroll
    for (int nb = 0; nb < kBlock / 8; ++nb)
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int i = 2 * r + e;
          const float p = fast_exp2(fmaf(s[nb][i], sl2, -lse2[r]));
          const bool kept = (kw[r][nb / 4] >> ((8 * nb + e) & 31)) & 1u;
          const float dps = kept ? dp[nb][i] * dp_mul : 0.f;  // dP s, dropped entries 0
          s[nb][i] = p * (dps - dlt[r]);                      // dS = P (dP - delta) s
        }
    uint32_t da[kBlock / 16][4];
    a_frags(da, s);
    fence_regs(acc);
    fence_regs(da);
    wgmma_fence();
    product_rs<D>(acc, da, sm.ring[st][0]);  // dQ += dS K
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    release(&sm.empty[st]);
  }
  const float one[2] = {1.f, 1.f};
  store_rows<D>(dq + base, acc, row, one, n, H, t);
}

// ---------------------------------------------------------------------------
// K4 (bf16), part 2: dK and dV per 64-key tile, over the query tiles that see it
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kWsThreads, bwd_min_blocks(D))
flash_bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
                            const __grid_constant__ CUtensorMap v_map, const __grid_constant__ CUtensorMap do_map,
                            const float* __restrict__ lse, const float* __restrict__ delta,
                            const uint32_t* __restrict__ keep, const int* __restrict__ table,
                            __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int n, int H, int heads,
                            MaskSpec spec, float scale, float inv_keep, int use_dropout) {
  WsSmem<D, 2>& sm = ws_smem_init<D, 2>(32);
  const TileRange tr(table + 5 * blockIdx.y);
  const int b = blockIdx.x / heads, h = blockIdx.x % heads;
  const size_t bh = (size_t)b * heads + h;
  const int words = (n + 31) / 32;
  if (threadIdx.x >= kConsumerThreads) {
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x >= kConsumerThreads + 32) return;
    const CUtensorMap* fixed[2] = {&k_map, &v_map};
    produce<Pass::kDkdv, D, 2>(sm, tr, fixed, &q_map, &do_map, b, h, n, spec, lse + bh * n, delta + bh * n,
                               use_dropout ? keep + bh * n * words : nullptr, words);
    return;
  }
  setmaxnreg_inc<consumer_regs(bwd_entry_regs(D), kProducerRegs)>();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = tr.tile * kBlock + warp * 16;  // this warp's 16 keys
  const size_t base = (size_t)b * n * H + (size_t)h * D;
  const int ak = spec.A * spec.K;
  const float sl2 = scale * kLog2e;
  const float dp_mul = scale * inv_keep;
  const int kword = warp >= 2;  // the keep word of this warp's keys within the tile's two

  int key[2], tj[2], aj[2], kj[2], kbit[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    key[r] = r0 + g + 8 * r;
    tj[r] = key[r] / ak;
    aj[r] = (key[r] / spec.K) % spec.A;
    kj[r] = key[r] % spec.K;
    kbit[r] = (warp * 16 + g + 8 * r) & 31;
  }

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
  zero(dk_acc);
  zero(dv_acc);
  mbar_wait(&sm.fixed_full, 0);

  for (int tile = tr.begin, it = 0; tile < tr.end; ++tile, ++it) {
    const int st = it % kStages;
    mbar_wait(&sm.full[st], (it / kStages) & 1);
    // S^T = K Q^T and dP^T = V dO^T: keys are rows, this tile's queries columns
    float s[kBlock / 8][4], dp[kBlock / 8][4];
    zero(s);
    zero(dp);
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
    product_ss<D>(s, sm.fixed[0], sm.ring[st][0]);
    product_ss<D>(dp, sm.fixed[1], sm.ring[st][1]);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);

    const int m0 = tile * kBlock;
    const StageRows& rows = sm.rows[st];
    if (tr.partial(tile)) {  // hidden pairs: score -inf, weight exp2(-inf) = 0
#pragma unroll
      for (int nb = 0; nb < kBlock / 8; ++nb)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * nb + 2 * t + e, i = m0 + c;
          const int ti = rows.t[c], ai = rows.a[c];
#pragma unroll
          for (int r = 0; r < 2; ++r)
            if (!(i < n && key[r] < n && visible(ti, ai, i, tj[r], aj[r], kj[r], key[r], spec)))
              s[nb][2 * r + e] = -INFINITY;
        }
    }
#pragma unroll
    for (int nb = 0; nb < kBlock / 8; ++nb)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * nb + 2 * t + e;
        const float lse2 = rows.lse[c] * kLog2e, dlt = rows.dlt[c] * scale;
        const uint32_t qw = rows.bits[c][kword];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int x = 2 * r + e;
          const float p = fast_exp2(fmaf(s[nb][x], sl2, -lse2));
          const bool kept = (qw >> kbit[r]) & 1u;
          const float dps = kept ? dp[nb][x] * dp_mul : 0.f;
          s[nb][x] = kept ? p * inv_keep : 0.f;  // dropout(P)^T
          dp[nb][x] = p * (dps - dlt);            // dS^T
        }
      }
    uint32_t pa[kBlock / 16][4], da[kBlock / 16][4];
    a_frags(pa, s);
    a_frags(da, dp);
    fence_regs(dv_acc);
    fence_regs(dk_acc);
    fence_regs(pa);
    fence_regs(da);
    wgmma_fence();
    product_rs<D>(dv_acc, pa, sm.ring[st][1]);  // dV += dropout(P)^T dO
    product_rs<D>(dk_acc, da, sm.ring[st][0]);  // dK += dS^T Q
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dv_acc);
    fence_regs(dk_acc);
    release(&sm.empty[st]);
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
  void* keep;  // bf16 with dropout: the packed keep words, written by K3 (if not null), read by K4
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

// Once per kernel: raises its dynamic shared memory limit (every launch
// takes the same bytes), and refuses it if it gets fewer registers at launch
// than its setmaxnreg budget assumes (the consumers' increase would then
// wait forever).
template <auto Kernel, size_t Bytes, int EntryRegs>
cudaError_t prepare() {
  static const cudaError_t err = [] {
    cudaFuncAttributes attr;
    cudaError_t e = cudaFuncGetAttributes(&attr, Kernel);
    if (e == cudaSuccess && attr.numRegs < EntryRegs) e = cudaErrorInvalidConfiguration;
    if (e == cudaSuccess) e = cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Bytes);
    return e;
  }();
  return err;
}

template <int D>
cudaError_t run_fwd_wgmma(const Args& a, cudaStream_t stream) {
  CUtensorMap qm, km, vm;
  if (!encode_tile_map<D>(&qm, a.q, a.B, a.n, a.H) || !encode_tile_map<D>(&km, a.k, a.B, a.n, a.H) ||
      !encode_tile_map<D>(&vm, a.v, a.B, a.n, a.H))
    return cudaErrorInvalidValue;
  constexpr size_t smem = ws_smem_bytes<D, 1>();
  const cudaError_t attr = prepare<flash_fwd_wgmma_kernel<D>, smem, fwd_entry_regs(D)>();
  if (attr != cudaSuccess) return attr;
  const dim3 grid(a.B * a.heads, (a.n + kBlock - 1) / kBlock);
  flash_fwd_wgmma_kernel<D><<<grid, kWsThreads, smem, stream>>>(
      qm, km, vm, static_cast<const long long*>(a.seed), a.table, static_cast<__nv_bfloat16*>(a.out),
      static_cast<float*>(a.lse_out), static_cast<uint32_t*>(a.keep), a.n, a.H, a.heads, a.spec, a.scale,
      a.inv_keep, a.threshold, a.use_dropout, a.b_off);
  return cudaGetLastError();
}

template <int D>
cudaError_t run_bwd_wgmma(const Args& a, cudaStream_t stream) {
  if (a.use_dropout && a.keep == nullptr) return cudaErrorInvalidValue;  // K4 reads K3's keep words
  CUtensorMap qm, km, vm, dom;
  if (!encode_tile_map<D>(&qm, a.q, a.B, a.n, a.H) || !encode_tile_map<D>(&km, a.k, a.B, a.n, a.H) ||
      !encode_tile_map<D>(&vm, a.v, a.B, a.n, a.H) || !encode_tile_map<D>(&dom, a.dout, a.B, a.n, a.H))
    return cudaErrorInvalidValue;
  constexpr size_t smem = ws_smem_bytes<D, 2>();
  cudaError_t err = prepare<flash_bwd_dq_wgmma_kernel<D>, smem, bwd_entry_regs(D)>();
  if (err == cudaSuccess) err = prepare<flash_bwd_dkdv_wgmma_kernel<D>, smem, bwd_entry_regs(D)>();
  if (err != cudaSuccess) return err;
  const int tiles = (a.n + kBlock - 1) / kBlock;
  const dim3 grid(a.B * a.heads, tiles);
  const uint32_t* keep = static_cast<const uint32_t*>(a.keep);
  flash_bwd_dq_wgmma_kernel<D><<<grid, kWsThreads, smem, stream>>>(
      qm, km, vm, dom, static_cast<const __nv_bfloat16*>(a.o), static_cast<const __nv_bfloat16*>(a.dout),
      static_cast<const float*>(a.lse), keep, a.table, static_cast<__nv_bfloat16*>(a.dq),
      static_cast<float*>(a.delta), a.n, a.H, a.heads, a.spec, a.scale, a.inv_keep, a.use_dropout);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dkdv_wgmma_kernel<D><<<grid, kWsThreads, smem, stream>>>(
      qm, km, vm, dom, static_cast<const float*>(a.lse), static_cast<const float*>(a.delta), keep,
      a.table + 5 * tiles, static_cast<__nv_bfloat16*>(a.dk), static_cast<__nv_bfloat16*>(a.dv), a.n, a.H,
      a.heads, a.spec, a.scale, a.inv_keep, a.use_dropout);
  return cudaGetLastError();
}

// bf16 on the tensor cores (wgmma), f32 on the CUDA cores
template <int D>
cudaError_t run(bool backward, bool bf16, const Args& a, cudaStream_t stream) {
  if (bf16) return backward ? run_bwd_wgmma<D>(a, stream) : run_fwd_wgmma<D>(a, stream);
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
// unused (may be null) for float32. keep: for bf16 with dropout, null or
// the uint32 [B, heads, n, ceil(n / 32)] packed keep mask (bit j % 32 of
// word j / 32 of row i: key j of query i kept), of which the kernel writes
// the words of the tile pairs it walks; unused for float32. Returns the
// cudaError_t of the launch.
extern "C" int ctrl_sim_flash_fwd(const void* q, const void* k, const void* v, const void* seed,
                                  const void* table, void* out, void* lse, void* keep, int B, int n, int H,
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
  a.keep = keep;
  return (int)dispatch(false, is_bf16 != 0, a, static_cast<cudaStream_t>(stream));
}

// K4. As K3, plus o and dout [B, n, H] (the forward's output and its
// gradient), lse from K3, and for bf16 with dropout the keep mask K3 wrote
// (required: the bf16 kernels read the keep bits and do not hash; the f32
// kernels hash and ignore it); writes dq, dk, dv [B, n, H] in the inputs'
// type and uses delta [B, heads, n] float32 as scratch. Two launches on one
// stream; returns the first error.
extern "C" int ctrl_sim_flash_bwd(const void* q, const void* k, const void* v, const void* o,
                                  const void* dout, const void* lse, const void* seed, const void* table,
                                  const void* keep, void* dq, void* dk, void* dv, void* delta, int B, int n,
                                  int H, int heads, int head_dim, int A, int K, int state_index, int own,
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
  a.keep = const_cast<void*>(keep);
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  a.delta = delta;
  return (int)dispatch(true, is_bf16 != 0, a, static_cast<cudaStream_t>(stream));
}
