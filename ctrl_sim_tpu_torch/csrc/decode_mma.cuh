// Decode attention over the streaming rollout's KV ring cache on Hopper
// (sm_90a), in bf16: the body shared by kernel K1 (decode_attention.cu,
// bf16 cache) and kernel K2 (decode_attention_q8.cu, int8 cache with fp32
// per-token scales). Each source wraps it in a kernel of its own name.
// Building blocks (TMA, mbarriers, wgmma, setmaxnreg) in wgmma_sm90.cuh.
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
// size. A fully masked row comes out as the uniform average of V over the N
// keys, finite; keys past N take no weight at all.
//
// What bounds it: one read of K and V (at the bench shape, B = 256 lanes,
// N = 1536 keys, H = 256, 402,653,184 bytes in bf16, 0.12 ms at 3.35 TB/s;
// half of that in int8) against 12.9 GFLOP at Q = 32 (0.013 ms on the
// tensor cores): bytes. Both designs below read each byte of the cache once
// at Q <= 64, keep a deep TMA stream in flight, and keep the work that is
// not loads (the products of padded rows, the softmax, the int8 widening,
// the mask) off the loads' path.
//
// Common to both:
// - Work. An item is one lane b, G heads (4, or 2 at d = 64; 2 or 1 when 4
//   does not divide the heads) and NQ query rows; Q > NQ takes further
//   items. The grid is persistent, as many blocks as the SMs hold (one an
//   SM at G = 4 and 2), each walking items blockIdx.x, + gridDim.x, ...:
//   the ring of stages runs on from one item into the next.
// - A block has G consumer warpgroups, one a head, and one producer
//   warpgroup; setmaxnreg moves registers from the producers to the
//   consumers (dec_consumer_regs; the host refuses a kernel whose
//   registers at launch differ from dec_entry_regs).
// - The producer loads each item's Q tile of every head by TMA (16-row
//   boxes, double-buffered under q_full / q_empty mbarriers) and streams
//   the 64-key chunks of K and V through a ring of stages under full /
//   empty mbarriers (3-D maps over [H, N, B], so keys past N come in as
//   zeros): over the bf16 cache one tile a head and tensor, swizzled by the
//   row's span as wgmma reads it (4 stages); over the int8 cache one tile
//   of the G heads' columns a tensor, swizzled by its row's span, and the
//   chunk's scales by one bulk copy each (cp.async for a ragged chunk), 6
//   stages.
//
// The rows design (K1; K2 at Q > 32): NQ = 64, all the lane's rows at Q <=
// 64 (DT's 48, the families' 32).
// - Each of the 128 producer threads also packs one 32-key word of the
//   chunk's mask (bit k: key 32 w + k visible to the row; its bytes read a
//   chunk ahead, 16 at a time where the row allows, rows >= Q never), and
//   each producer warp flags whether every word it packed sees all 32 keys.
// - Consumers run K3's loop without dropout: S = Q K^T by wgmma (64 x 64,
//   fp32, both operands in shared memory); k_scale on the scores (int8);
//   the mask words as the bias, skipped on chunks whose flags say every
//   real row sees every key; keys past N -inf; the online exp2 softmax on
//   the accumulators (rows g, g + 8 of each warp's 16, quad shuffles, tree
//   reductions); the weights times v_scale (int8), rounded to bf16 in
//   registers; O += P V by wgmma (V transposed by the instruction); the
//   output divided once and written in bf16, rows < Q. While the P V
//   product runs, over the int8 cache the warpgroup widens the head's next
//   int8 columns to bf16 tiles (exactly; two buffers) and fences them for
//   the async proxy.
// - Padded rows cost products, not bytes: a warp whose 16 rows are all
//   >= Q skips the softmax and multiplies zeros. Head j's Q tile is
//   rotated by 16 (4 / G) j rows, so that at Q < 64 the warps that hold
//   real rows fall on different SM sub-partitions for different heads.
//
// The keys design (K2 at Q <= 32: the rollout's two passes, the 3-pass
// decode): NQ = 16 or 32, the keys on wgmma's 64-row side.
// - S^T = K Q^T by wgmma m64nNQk16: the A operand is the chunk's int8 K,
//   which each thread widens exactly from shared memory into its
//   registers (no bf16 tile is written), and the B operand the Q tile, so
//   a padded row costs a column of the product, not a row.
// - Warp w of a consumer warpgroup takes keys 16 w to 16 w + 15 of every
//   chunk, with a running max, denominator and output of its own for each
//   query row: its softmax runs down its columns (a max over the 8 lanes of
//   equal t). The max moves only where a score of the warp lies more than
//   kDecRescale above its column's (always on an item's first chunk), and
//   then every column takes its exact max: the usual chunk pays no shuffle
//   and no rescale, and the weights stay below 2^kDecRescale.
// - P is transposed in registers (movmatrix) into mma.sync's A operand and
//   O += P V runs on mma.sync m16n8k16, V widened in registers into its B
//   operand (column g of block j being the head's column d / 8 g + j, so a
//   thread's bytes of a key are one word).
// - The producer's warp 0 only loads. The mask is packed once a launch, by
//   the consumers while the first chunks load, into shared memory: the
//   rows' words, each chunk's flag that every row sees every key, and each
//   consumer thread's bits.
// - At an item's end the four warps are merged: each output times 2^(its
//   max - the row's max) over the row's denominator, summed.

#pragma once

#include <math.h>
#include <stdint.h>

#include "wgmma_sm90.cuh"

namespace {

constexpr int kDecChunk = kTileRows;      // keys a stage: S = Q K^T is 64 x 64
constexpr int kDecRows = kTileRows;       // query rows an item
constexpr int kDecProducerRegs = 64;      // the producer warpgroup's registers after setmaxnreg
constexpr float kDecMaskNeg = -1e30f;     // the TPU kernels' masked score
constexpr size_t kDecSmemLimit = 227 * 1024;  // Hopper's shared memory a block
constexpr float kDecRescale = 8.f;  // keys design: how far (log2 units) a score may lie above the running max

// the heads a block takes at most: 4 heads of 32 (or 16), 2 of 64
__host__ __device__ constexpr int dec_max_heads(int D) { return D > 32 ? 2 : 4; }
// the block: G consumer warpgroups and one producer warpgroup
__host__ __device__ constexpr int dec_threads(int G) { return 128 * (G + 1); }
// blocks an SM holds (__launch_bounds__): one at G = 4 and 2 (shared memory),
// two at G = 1
__host__ __device__ constexpr int dec_min_blocks(int G) { return G == 1 ? 2 : 1; }
// The registers a thread gets at launch, which ptxas allocates under those
// bounds (all the SM's registers over the block's threads, in steps of 8),
// and what a consumer thread takes once the producers dropped to
// kDecProducerRegs: 96 -> 104 at G = 4, 168 -> 216 at G = 2, 128 -> 192 at G = 1.
__host__ __device__ constexpr int dec_entry_regs(int G) {
  return 65536 / (dec_threads(G) * dec_min_blocks(G)) / 8 * 8;
}
__host__ __device__ constexpr int dec_consumer_regs(int G) {
  return (dec_threads(G) * dec_entry_regs(G) - 128 * kDecProducerRegs) / (128 * G) / 8 * 8;
}
// the rotation of head j's Q tile, in 16-row parts: heads of a block on
// different sub-partitions
template <int G>
__device__ __forceinline__ int dec_rotation(int j) {
  return (j * (4 / G)) & 3;
}

struct DecodeArgs {
  const __nv_bfloat16* q;          // [B, Q, H], pre-scaled
  const void *k, *v;               // [B, N, H] bf16 or int8
  const float *k_scale, *v_scale;  // [B, N] (int8 cache only)
  const int8_t* mask;              // [Q, N + N % 2]
  __nv_bfloat16* out;              // [B, Q, H]
  int B, Q, N, H, heads;
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

// The 2 int8 values in the low half of w as 2 bf16 (one bf16x2 word), exactly.
__device__ __forceinline__ uint32_t widen_i8x2(uint32_t w) {
  const uint32_t u = w ^ 0x8080u;
  const uint32_t f0 = __float_as_uint(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440)) - 8388736.f);
  const uint32_t f1 = __float_as_uint(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7441)) - 8388736.f);
  return __byte_perm(f0, f1, 0x7632);
}

// Byte j of each of two words, already xor'd with 0x80 in every byte, as
// 2 bf16 (the first word's in the low half), exactly.
__device__ __forceinline__ uint32_t widen_pair(uint32_t ua, uint32_t ub, int j) {
  const uint32_t fa = __float_as_uint(__uint_as_float(__byte_perm(ua, 0x4B000000u, 0x7440 + j)) - 8388736.f);
  const uint32_t fb = __float_as_uint(__uint_as_float(__byte_perm(ub, 0x4B000000u, 0x7440 + j)) - 8388736.f);
  return __byte_perm(fa, fb, 0x7632);
}

// bit k set where byte k of w is nonzero
__device__ __forceinline__ uint32_t nonzero_bits4(uint32_t w) {
  const uint32_t hi = (((w & 0x7f7f7f7fu) + 0x7f7f7f7fu) | w) & 0x80808080u;
  return ((hi >> 7) * 0x01020408u) >> 24;
}

// A stage's K and V: over the bf16 cache one TMA tile a head and tensor,
// read by wgmma as they land; over the int8 cache one tile of the G heads'
// columns a tensor (swizzled by its row's span, swz<G * D / 16>). In the
// rows design each consumer warpgroup widens its head's columns into bf16
// tiles (kWide; two buffers: the next chunk's is written while this one's
// are read); in the keys design the threads widen them in registers.
template <int D, int G, bool kInt8, bool kWide>
struct DecTiles {
  static constexpr int kStages = 4;
  uint16_t k[kStages][G][kDecChunk * D];
  uint16_t v[kStages][G][kDecChunk * D];
};
template <int D, int G>
struct DecTiles<D, G, true, false> {
  static constexpr int kStages = 6;
  int8_t k[kStages][kDecChunk * G * D];
  int8_t v[kStages][kDecChunk * G * D];
};
template <int D, int G>
struct DecTiles<D, G, true, true> : DecTiles<D, G, true, false> {
  uint16_t kw[G][2][kDecChunk * D];
  uint16_t vw[G][2][kDecChunk * D];
};

// The keys design's merge of the four warps of each head at an item's end:
// their running maxima and denominators, and their outputs (already
// divided), warps 0 and 1 written, warps 2 and 3 added to them.
template <int D, int G, int NQ>
struct DecMerge {
  float o[G][2][NQ][D + 1];  // + 1: the warp's rows fall on different banks
  float m[G][4][NQ], l[G][4][NQ];
};
template <int D, int G>
struct DecMerge<D, G, kDecRows> {};

// The rows design's mask words of each stage, packed by the producers.
template <int S, bool kRows>
struct DecStageMask {
  uint32_t vis[S][kDecRows][2];  // bit k of word w of row i: key 32 w + k visible to query row i
  uint32_t dense[S][4];          // per producer warp: every word it packed is all ones
};
template <int S>
struct DecStageMask<S, false> {};

// The block's shared memory (tiles first: each a multiple of 1024 bytes
// from a 1024-aligned base). NQ is the query rows of an item: kDecRows in
// the rows design, 16 or 32 in the keys design, whose mask words (packed
// once a launch) follow the struct.
template <int D, int G, bool kInt8, int NQ>
struct DecSmem {
  using Tiles = DecTiles<D, G, kInt8, NQ == kDecRows>;
  static constexpr int kStages = Tiles::kStages, kHeads = G;
  // a stage is full once its loads' bytes are in and, in the rows design, the producers packed its mask
  static constexpr int kFullArrivals = NQ == kDecRows ? 129 : 1;
  uint16_t q[2][G][NQ * D];  // the items' Q tiles, double-buffered
  Tiles tiles;
  alignas(16) float ks[kStages][kDecChunk];  // int8: the stage's scales
  alignas(16) float vs[kStages][kDecChunk];
  DecStageMask<kStages, NQ == kDecRows> mask;
  DecMerge<D, G, NQ> merge;
  uint64_t q_full[2], q_empty[2], full[kStages], empty[kStages];
};

// The keys design's mask, per chunk: NQ rows of two 32-key words, a flag
// that every row < Q sees all of its keys, and 16 bits a consumer thread.
__host__ __device__ constexpr int dec_mask_words(int NQ, int N) {
  return (N + kDecChunk - 1) / kDecChunk * (2 * NQ + 1 + 64);
}

template <int D, int G, bool kInt8, int NQ>
constexpr size_t dec_smem_bytes(int N) {
  return sizeof(DecSmem<D, G, kInt8, NQ>) + 1024 +  // slack to align the base
         (NQ == kDecRows ? 0 : 4 * (size_t)dec_mask_words(NQ, N));
}

// What a block walks: items (lane, G heads, NQ query rows) blockIdx.x,
// + gridDim.x, ..., each in chunks of 64 keys.
struct DecItem {
  int b, h0, q0;
};
template <int G, int NQ>
struct DecWork {
  int qtiles, groups, items, chunks;
  __device__ __forceinline__ explicit DecWork(const DecodeArgs& a)
      : qtiles((a.Q + NQ - 1) / NQ),
        groups(a.heads / G),
        items(a.B * (a.heads / G) * ((a.Q + NQ - 1) / NQ)),
        chunks((a.N + kDecChunk - 1) / kDecChunk) {}
  // the block's i-th item
  __device__ __forceinline__ DecItem item(int i) const {
    const int it = blockIdx.x + i * gridDim.x, qt = it % qtiles, rest = it / qtiles;
    return {rest / groups, (rest % groups) * G, qt * NQ};
  }
  __device__ __forceinline__ int count() const { return (items - blockIdx.x + gridDim.x - 1) / gridDim.x; }
};

// One 32-key word of the mask: query row `row`, keys [key0, key0 + 32).
// Loaded 16 bytes at a time where the row allows, a chunk before it is
// packed; otherwise byte by byte when packed.
struct MaskBytes {
  uint4 lo, hi;
  bool fast;
};
__device__ __forceinline__ const int8_t* mask_at(const DecodeArgs& a, int row, int key0) {
  return a.mask + (size_t)row * (a.N + (a.N & 1)) + key0;
}
__device__ __forceinline__ MaskBytes mask_load(const DecodeArgs& a, int row, int key0) {
  MaskBytes m;
  const int8_t* p = mask_at(a, row, key0);
  m.fast = row < a.Q && key0 + 32 <= a.N && (reinterpret_cast<uintptr_t>(p) & 15) == 0;
  m.lo = m.hi = make_uint4(0u, 0u, 0u, 0u);
  if (m.fast) {
    m.lo = __ldg(reinterpret_cast<const uint4*>(p));
    m.hi = __ldg(reinterpret_cast<const uint4*>(p) + 1);
  }
  return m;
}
// the packed word: all ones for a row >= Q (never read), no bits for keys past N
__device__ __forceinline__ uint32_t mask_word(const MaskBytes& m, const DecodeArgs& a, int row, int key0) {
  if (row >= a.Q) return ~0u;
  uint32_t bits = 0u;
  if (m.fast) {
    const uint32_t w[8] = {m.lo.x, m.lo.y, m.lo.z, m.lo.w, m.hi.x, m.hi.y, m.hi.z, m.hi.w};
#pragma unroll
    for (int i = 0; i < 8; ++i) bits |= nonzero_bits4(w[i]) << (4 * i);
    return bits;
  }
  const int8_t* p = mask_at(a, row, key0);
  for (int i = 0; i < 32 && key0 + i < a.N; ++i) bits |= (uint32_t)(p[i] != 0) << i;
  return bits;
}

// Consumer warpgroup j widens its head's columns of a landed int8 chunk
// (raw: [key][G * D], swz<G * D / 16>) into its bf16 tile (dst, swizzled
// as TMA and wgmma lay bf16 tiles out): 16 int8 values a step, t the
// thread of the warpgroup.
template <int D, int G>
__device__ __forceinline__ void widen_head(const int8_t* raw, uint16_t* dst, int j, int t) {
  constexpr int kRow = G * D / 16, kHead = D / 16;  // 16-byte units a raw row, and a head's
#pragma unroll
  for (int u = t; u < kDecChunk * kHead; u += 128) {
    const int r = u / kHead, hu = u % kHead;
    const uint4 x = *reinterpret_cast<const uint4*>(raw + r * G * D + 16 * swz<kRow>(r, j * kHead + hu));
    const uint2 w0 = widen_i8x4(x.x), w1 = widen_i8x4(x.y), w2 = widen_i8x4(x.z), w3 = widen_i8x4(x.w);
    uint16_t* row = dst + r * D;
    *reinterpret_cast<uint4*>(row + 8 * swz<D / 8>(r, 2 * hu)) = make_uint4(w0.x, w0.y, w1.x, w1.y);
    *reinterpret_cast<uint4*>(row + 8 * swz<D / 8>(r, 2 * hu + 1)) = make_uint4(w2.x, w2.y, w3.x, w3.y);
  }
}

template <class Smem>
__device__ __forceinline__ Smem& dec_smem_init() {
  extern __shared__ __align__(16) uint8_t dec_raw_smem[];
  // aligned by pointer arithmetic on the shared array, so that the compiler
  // keeps shared-memory loads (LDS), not generic ones
  uint8_t* base = dec_raw_smem + ((1024 - (smem_addr(dec_raw_smem) & 1023)) & 1023);
  Smem& sm = *reinterpret_cast<Smem*>(base);
  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(&sm.q_full[i], 1);
      mbar_init(&sm.q_empty[i], 4 * Smem::kHeads);  // one arrival a consumer warp
    }
    for (int s = 0; s < Smem::kStages; ++s) {
      mbar_init(&sm.full[s], Smem::kFullArrivals);
      mbar_init(&sm.empty[s], 4 * Smem::kHeads);
    }
    mbar_fence_init();
  }
  __syncthreads();
  return sm;
}

// The rows design's producer warpgroup (see the design notes above):
// thread 0 loads (its warp copies a ragged chunk's scales), every thread
// packs one mask word a chunk.
template <int D, int G, bool kInt8>
__device__ __forceinline__ void decode_produce(DecSmem<D, G, kInt8, kDecRows>& sm, const CUtensorMap* q_map,
                                               const CUtensorMap* k_map, const CUtensorMap* v_map,
                                               const DecodeArgs& a) {
  constexpr int S = DecSmem<D, G, kInt8, kDecRows>::kStages;
  const DecWork<G, kDecRows> work(a);
  const int pt = threadIdx.x - 128 * G, pw = pt >> 5, lane = pt & 31;
  const int row = pt >> 1, half = 32 * (pt & 1);  // this thread's mask word: query row of the item, first key
  const int total = work.count() * work.chunks;     // the block's chunks, item after item
  if (pt == 0) {
    tma_prefetch_map(q_map);
    tma_prefetch_map(k_map);
    tma_prefetch_map(v_map);
  }
  DecItem it = work.item(0);
  MaskBytes bytes = mask_load(a, it.q0 + row, half);
  for (int n = 0; n < total; ++n) {
    const int c = n % work.chunks, st = n % S, key0 = c * kDecChunk;
    if (c == 0) {
      const int i = n / work.chunks, qb = i & 1;
      it = work.item(i);
      if (pt == 0) {  // the item's Q tile of each head, its 16-row parts rotated
        mbar_wait(&sm.q_empty[qb], ((i >> 1) & 1) ^ 1);
        mbar_arrive_expect_tx(&sm.q_full[qb], G * tile_bytes<D>());
#pragma unroll
        for (int j = 0; j < G; ++j)
#pragma unroll
          for (int p = 0; p < 4; ++p)
            tma_load_tile(&sm.q[qb][j][16 * p * D], q_map, (it.h0 + j) * D,
                          it.q0 + 16 * ((p - dec_rotation<G>(j)) & 3), it.b, &sm.q_full[qb]);
      }
    }
    const uint32_t word = mask_word(bytes, a, it.q0 + row, key0 + half);
    if (n + 1 < total) {  // the next chunk's mask bytes, in flight while this chunk is staged
      const int c1 = (n + 1) % work.chunks;
      const int q1 = c1 == 0 ? work.item((n + 1) / work.chunks).q0 : it.q0;
      bytes = mask_load(a, q1 + row, c1 * kDecChunk + half);
    }
    const bool dense = __all_sync(0xffffffffu, word == ~0u);
    mbar_wait(&sm.empty[st], ((n / S) & 1) ^ 1);  // the first round finds every stage free
    if (pw == 0) {
      if constexpr (kInt8) {
        // the chunk's scales: one bulk copy each where whole and aligned, else 4 bytes a lane
        const float* ksrc = a.k_scale + (size_t)it.b * a.N + key0;
        const float* vsrc = a.v_scale + (size_t)it.b * a.N + key0;
        const bool bulk = key0 + kDecChunk <= a.N &&
                          ((reinterpret_cast<uintptr_t>(ksrc) | reinterpret_cast<uintptr_t>(vsrc)) & 15) == 0;
        if (lane == 0) {
          mbar_arrive_expect_tx(&sm.full[st], 2 * kDecChunk * G * D + (bulk ? 2 * kDecChunk * 4 : 0));
          tma_load_tile(sm.tiles.k[st], k_map, it.h0 * D, key0, it.b, &sm.full[st]);
          tma_load_tile(sm.tiles.v[st], v_map, it.h0 * D, key0, it.b, &sm.full[st]);
          if (bulk) {
            bulk_load(sm.ks[st], ksrc, kDecChunk * 4, &sm.full[st]);
            bulk_load(sm.vs[st], vsrc, kDecChunk * 4, &sm.full[st]);
          }
        }
        if (!bulk) {  // zeros past N
#pragma unroll
          for (int i = lane; i < kDecChunk; i += 32) {
            const bool ok = key0 + i < a.N;
            cp_async4(&sm.ks[st][i], ok ? ksrc + i : a.k_scale, ok);
            cp_async4(&sm.vs[st][i], ok ? vsrc + i : a.v_scale, ok);
          }
          mbar_track_cp_async(&sm.full[st]);
        }
      } else if (lane == 0) {
        mbar_arrive_expect_tx(&sm.full[st], 2 * G * tile_bytes<D>());
#pragma unroll
        for (int j = 0; j < G; ++j) {
          tma_load_tile(sm.tiles.k[st][j], k_map, (it.h0 + j) * D, key0, it.b, &sm.full[st]);
          tma_load_tile(sm.tiles.v[st][j], v_map, (it.h0 + j) * D, key0, it.b, &sm.full[st]);
        }
      }
    }
    sm.mask.vis[st][row][pt & 1] = word;
    if (lane == 0) sm.mask.dense[st][pw] = dense;
    mbar_arrive(&sm.full[st]);
  }
  // the loader leaves only once the consumers released every stage it filled
  if (pt == 0)
    for (int n = total > S ? total - S : 0; n < total; ++n) mbar_wait(&sm.empty[n % S], (n / S) & 1);
}

// The keys design's producer: its warp 0 loads (lane 0 the tiles, every
// lane a ragged chunk's scales); the other three warps leave at once.
template <int D, int G, int NQ>
__device__ __forceinline__ void decode_produce_keys(DecSmem<D, G, true, NQ>& sm, const CUtensorMap* q_map,
                                                    const CUtensorMap* k_map, const CUtensorMap* v_map,
                                                    const DecodeArgs& a) {
  constexpr int S = DecSmem<D, G, true, NQ>::kStages;
  const DecWork<G, NQ> work(a);
  const int lane = threadIdx.x - 128 * G;
  if (lane >= 32) return;
  const int total = work.count() * work.chunks;
  if (lane == 0) {
    tma_prefetch_map(q_map);
    tma_prefetch_map(k_map);
    tma_prefetch_map(v_map);
  }
  DecItem it{};
  for (int n = 0; n < total; ++n) {
    const int c = n % work.chunks, st = n % S, key0 = c * kDecChunk;
    if (c == 0) {
      const int i = n / work.chunks, qb = i & 1;
      it = work.item(i);
      if (lane == 0) {  // the item's Q tile of each head
        mbar_wait(&sm.q_empty[qb], ((i >> 1) & 1) ^ 1);
        mbar_arrive_expect_tx(&sm.q_full[qb], G * NQ * D * 2);
#pragma unroll
        for (int j = 0; j < G; ++j)
#pragma unroll
          for (int p = 0; p < NQ / 16; ++p)
            tma_load_tile(&sm.q[qb][j][16 * p * D], q_map, (it.h0 + j) * D, it.q0 + 16 * p, it.b, &sm.q_full[qb]);
      }
    }
    mbar_wait(&sm.empty[st], ((n / S) & 1) ^ 1);  // the first round finds every stage free
    const float* ksrc = a.k_scale + (size_t)it.b * a.N + key0;
    const float* vsrc = a.v_scale + (size_t)it.b * a.N + key0;
    const bool bulk = key0 + kDecChunk <= a.N &&
                      ((reinterpret_cast<uintptr_t>(ksrc) | reinterpret_cast<uintptr_t>(vsrc)) & 15) == 0;
    if (!bulk) {  // zeros past N; the stage's phase waits for these copies too
#pragma unroll
      for (int x = lane; x < kDecChunk; x += 32) {
        const bool ok = key0 + x < a.N;
        cp_async4(&sm.ks[st][x], ok ? ksrc + x : a.k_scale, ok);
        cp_async4(&sm.vs[st][x], ok ? vsrc + x : a.v_scale, ok);
      }
      mbar_track_cp_async(&sm.full[st]);
      __syncwarp();
    }
    if (lane == 0) {
      mbar_arrive_expect_tx(&sm.full[st], 2 * kDecChunk * G * D + (bulk ? 2 * kDecChunk * 4 : 0));
      tma_load_tile(sm.tiles.k[st], k_map, it.h0 * D, key0, it.b, &sm.full[st]);
      tma_load_tile(sm.tiles.v[st], v_map, it.h0 * D, key0, it.b, &sm.full[st]);
      if (bulk) {
        bulk_load(sm.ks[st], ksrc, kDecChunk * 4, &sm.full[st]);
        bulk_load(sm.vs[st], vsrc, kDecChunk * 4, &sm.full[st]);
      }
    }
  }
  // the loader leaves only once the consumers released every stage it filled
  if (lane == 0)
    for (int n = total > S ? total - S : 0; n < total; ++n) mbar_wait(&sm.empty[n % S], (n / S) & 1);
}

// The rows design's consumer warpgroups: warpgroup j takes head h0 + j of
// each item.
template <int D, int G, bool kInt8>
__device__ __forceinline__ void decode_consume(DecSmem<D, G, kInt8, kDecRows>& sm, const DecodeArgs& a) {
  constexpr int S = DecSmem<D, G, kInt8, kDecRows>::kStages, NB = kDecChunk / 8;
  const DecWork<G, kDecRows> work(a);
  const int j = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31, g = lane >> 2,
            t = lane & 3;
  const int base = 16 * ((warp - dec_rotation<G>(j)) & 3);  // the item's query row of this warp's first row
  const int count = work.count(), chunks = work.chunks;
  // The tiles of the block's n-th chunk (the item's c-th) that wgmma reads:
  // over the int8 cache the widened ones, in buffer c % 2.
  auto k_tile = [&](int n, int c) -> const uint16_t* {
    if constexpr (kInt8) return sm.tiles.kw[j][c & 1];
    else return sm.tiles.k[n % S][j];
  };
  auto v_tile = [&](int n, int c) -> const uint16_t* {
    if constexpr (kInt8) return sm.tiles.vw[j][c & 1];
    else return sm.tiles.v[n % S][j];
  };
  // chunk n has landed (over the int8 cache: and is widened, by the whole warpgroup)
  auto land = [&](int n, int c) {
    mbar_wait(&sm.full[n % S], (n / S) & 1);
    if constexpr (kInt8) {
      widen_head<D, G>(sm.tiles.k[n % S], sm.tiles.kw[j][c & 1], j, threadIdx.x & 127);
      widen_head<D, G>(sm.tiles.v[n % S], sm.tiles.vw[j][c & 1], j, threadIdx.x & 127);
      fence_proxy_async();  // the widened tiles are read by wgmma
      warpgroup_sync(1 + j);
    }
  };
  for (int i = 0, n0 = 0; i < count; ++i, n0 += chunks) {
    const DecItem it = work.item(i);
    const int qb = i & 1;
    const uint16_t* q_tile = sm.q[qb][j];
    const bool active = it.q0 + base < a.Q;  // the warp holds a real row
    // running max (log2 units) and per-thread partial denominators of rows g, g + 8
    float acc[D / 8][4], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    zero(acc);
    mbar_wait(&sm.q_full[qb], (i >> 1) & 1);

    land(n0, 0);
    for (int c = 0; c < chunks; ++c) {
      const int n = n0 + c, st = n % S;
      float sc[NB][4];
      zero(sc);
      fence_regs(sc);
      wgmma_fence();
      product_ss<D>(sc, q_tile, k_tile(n, c));  // S = Q K^T
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      uint32_t pa[kDecChunk / 16][4];
      if (active) {
        if constexpr (kInt8) {
#pragma unroll
          for (int nb = 0; nb < NB; ++nb) {
            const float2 ksc = *reinterpret_cast<const float2*>(&sm.ks[st][8 * nb + 2 * t]);
            sc[nb][0] *= ksc.x, sc[nb][1] *= ksc.y, sc[nb][2] *= ksc.x, sc[nb][3] *= ksc.y;
          }
        }
        // masked: -1e30; keys past N: -inf (no weight even in a masked row); skipped
        // where every real row of the item sees every key of the chunk
        const uint32_t* flags = sm.mask.dense[st];
        if (!(flags[0] & flags[1] & flags[2] & flags[3])) {
          const int key0 = c * kDecChunk;
          uint32_t vw[2][2];  // the words of rows g, g + 8, shifted to this thread's first column
#pragma unroll
          for (int r = 0; r < 2; ++r)
#pragma unroll
            for (int w = 0; w < 2; ++w) vw[r][w] = sm.mask.vis[st][base + g + 8 * r][w] >> (2 * t);
#pragma unroll
          for (int nb = 0; nb < NB; ++nb)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const bool past = key0 + 8 * nb + 2 * t + e >= a.N;
#pragma unroll
              for (int r = 0; r < 2; ++r) {
                float& x = sc[nb][2 * r + e];
                x = past ? -INFINITY : ((vw[r][nb / 4] >> ((8 * nb + e) & 31)) & 1u) ? x : kDecMaskNeg;
              }
            }
        }
        // online softmax on the accumulators: rows g (r = 0) and g + 8 (r = 1); the max is
        // subtracted on its own, never inside an FMA with a -1e30 score, so a fully masked
        // chunk gives 2^0 = 1 against its own max and a finite, uniform row
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float v[NB];  // reductions as trees: short dependency chains
#pragma unroll
          for (int nb = 0; nb < NB; ++nb) v[nb] = fmaxf(sc[nb][2 * r], sc[nb][2 * r + 1]);
#pragma unroll
          for (int w = NB / 2; w > 0; w /= 2)
#pragma unroll
            for (int x = 0; x < w; ++x) v[x] = fmaxf(v[x], v[x + w]);
          float mx = fmaxf(m[r], v[0]);
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
          const float mu = mx == -INFINITY ? 0.f : mx;
          const float alpha = fast_exp2(m[r] - mu);
          m[r] = mx;
#pragma unroll
          for (int nb = 0; nb < NB; ++nb) {
            sc[nb][2 * r] = fast_exp2(sc[nb][2 * r] - mu);
            sc[nb][2 * r + 1] = fast_exp2(sc[nb][2 * r + 1] - mu);
            v[nb] = sc[nb][2 * r] + sc[nb][2 * r + 1];
          }
#pragma unroll
          for (int w = NB / 2; w > 0; w /= 2)
#pragma unroll
            for (int x = 0; x < w; ++x) v[x] += v[x + w];
          l[r] = l[r] * alpha + v[0];
#pragma unroll
          for (int db = 0; db < D / 8; ++db) {
            acc[db][2 * r] *= alpha;
            acc[db][2 * r + 1] *= alpha;
          }
        }
        if constexpr (kInt8) {  // rounded to bf16 below, as the TPU body rounds e * v_scale
#pragma unroll
          for (int nb = 0; nb < NB; ++nb) {
            const float2 vsc = *reinterpret_cast<const float2*>(&sm.vs[st][8 * nb + 2 * t]);
            sc[nb][0] *= vsc.x, sc[nb][1] *= vsc.y, sc[nb][2] *= vsc.x, sc[nb][3] *= vsc.y;
          }
        }
        a_frags(pa, sc);
      } else {
#pragma unroll
        for (int kk = 0; kk < kDecChunk / 16; ++kk) pa[kk][0] = pa[kk][1] = pa[kk][2] = pa[kk][3] = 0u;
      }
      fence_regs(acc);
      fence_regs(pa);
      wgmma_fence();
      product_rs<D>(acc, pa, v_tile(n, c));  // O += P V
      wgmma_commit();
      if (c + 1 < chunks) land(n + 1, c + 1);
      wgmma_wait<0>();
      fence_regs(acc);
      release(&sm.empty[st]);
    }
    release(&sm.q_empty[qb]);
    if (active) {  // the denominators (this thread's parts summed over its quad) divide the output
      float mul[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
        mul[r] = 1.f / l[r];
      }
      const int rows[2] = {it.q0 + base + g, it.q0 + base + g + 8};
      store_rows<D>(a.out + (size_t)it.b * a.Q * a.H + (size_t)(it.h0 + j) * D, acc, rows, mul, a.Q, a.H, t);
    }
  }
}


// The keys design's consumer warpgroups (int8 cache, Q <= NQ): warpgroup j
// takes head h0 + j of each item, and warp w keys 16 w to 16 w + 15 of
// every chunk, with a running max, denominator and output of its own for
// each query row; the four warps' are merged at the item's end.
template <int D, int G, int NQ>
__device__ __forceinline__ void decode_consume_keys(DecSmem<D, G, true, NQ>& sm, const DecodeArgs& a) {
  constexpr int S = DecSmem<D, G, true, NQ>::kStages, NB = NQ / 8, MT = NQ / 16, KB = D / 16, DB = D / 8;
  constexpr int kRow = G * D / 16;  // 16-byte units of a raw int8 row
  const DecWork<G, NQ> work(a);
  const int j = threadIdx.x >> 7, w = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31, g = lane >> 2,
            t = lane & 3;
  const int count = work.count(), chunks = work.chunks;
  // the lane holding column q's alpha for this thread's output rows: t = (q % 8) / 2 with q % 8 = g
  const int src = (lane & ~3) | (g >> 1);
  DecMerge<D, G, NQ>& mg = sm.merge;
  // The mask, packed once by all the consumer threads while the first chunks load (every item
  // has the same rows, Q <= NQ): word h of row q of chunk c (bit k: key 64 c + 32 h + k visible
  // to query row q; all ones for q >= Q, none past N); each chunk's flag that every row sees
  // every key; and for each chunk and consumer thread of a warpgroup the bits of its 4 NB
  // scores, bit 2 (2 nb + e) + r for query row 8 nb + 2t + e and key 16 w + g + 8 r.
  uint32_t* const vis = reinterpret_cast<uint32_t*>(&sm + 1);
  uint32_t* const dense = vis + chunks * 2 * NQ;
  uint16_t* const bits = reinterpret_cast<uint16_t*>(dense + chunks);
  for (int x = threadIdx.x; x < chunks * 2 * NQ; x += 128 * G) {
    const int key0 = (x / (2 * NQ)) * kDecChunk + 32 * (x & 1), q = (x >> 1) % NQ;
    vis[x] = mask_word(mask_load(a, q, key0), a, q, key0);
  }
  threads_sync(8, 128 * G);
  for (int c = threadIdx.x; c < chunks; c += 128 * G) {
    uint32_t all = ~0u;
    for (int x = 0; x < 2 * NQ; ++x) all &= vis[c * 2 * NQ + x];
    dense[c] = all == ~0u;
  }
  for (int x = threadIdx.x; x < chunks * 128; x += 128 * G) {
    const int c = x >> 7, xw = (x >> 5) & 3, xg = (x & 31) >> 2, xt = x & 3;
    uint32_t y = 0u;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const uint32_t word = vis[(c * NQ + 8 * nb + 2 * xt + e) * 2 + (xw >> 1)] >> (16 * (xw & 1) + xg);
        y |= (word & 1u) << (2 * (2 * nb + e)) | ((word >> 8) & 1u) << (2 * (2 * nb + e) + 1);
      }
    bits[x] = (uint16_t)y;
  }
  threads_sync(8, 128 * G);
  for (int i = 0, n0 = 0; i < count; ++i, n0 += chunks) {
    const DecItem it = work.item(i);
    const int qb = i & 1;
    const uint64_t qdesc = wgmma_desc<D>(sm.q[qb][j]);
    // per query column 8 nb + 2t + e: running max (log2 units) and this thread's part of the denominator;
    // o: the warp's output, rows 16 mt + g (+ 8), column 2t (+ 1) of block db = head column DB (2t (+ 1)) + db
    float o[MT][DB][4], m[NB][2], l[NB][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) zero(o[mt]);
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) m[nb][0] = m[nb][1] = -INFINITY, l[nb][0] = l[nb][1] = 0.f;
    mbar_wait(&sm.q_full[qb], (i >> 1) & 1);

    for (int c = 0; c < chunks; ++c) {
      const int n = n0 + c, st = n % S, key0 = c * kDecChunk;
      mbar_wait(&sm.full[st], (n / S) & 1);
      const int8_t* kraw = sm.tiles.k[st];
      const int8_t* vraw = sm.tiles.v[st];
      // K's rows 16 w + g and + 8 as wgmma's A fragments (columns 2t, 2t + 1 and 2t + 8, 2t + 9 of
      // each 16-wide block), widened exactly in registers
      uint32_t ka[KB][4];
#pragma unroll
      for (int kb = 0; kb < KB; ++kb)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int key = 16 * w + g + 8 * r;
          const int8_t* u = kraw + key * G * D + 16 * swz<kRow>(key, j * KB + kb);
          ka[kb][r] = widen_i8x2(*reinterpret_cast<const uint16_t*>(u + 2 * t));
          ka[kb][2 + r] = widen_i8x2(*reinterpret_cast<const uint16_t*>(u + 2 * t + 8));
        }
      float sc[NB][4];  // S^T: rows the warp's keys g (+ 8), columns the query rows 8 nb + 2t (+ 1)
      zero(sc);
      fence_regs(sc);
      wgmma_fence();
#pragma unroll
      for (int kb = 0; kb < KB; ++kb) wgmma_rs<NQ>(sc, ka[kb], qdesc + kb * kWgmmaKStep, kb > 0);  // S^T = K Q^T
      wgmma_commit();
      // while it runs: V's keys 16 w + 2t, + 1, + 8, + 9 as P V's B fragments, column g of block db
      // being the head's column DB g + db (its DB bytes of each key are one word)
      uint32_t vb[DB][2];
      {
        const int col = j * D + DB * g;
        uint32_t x[4][2];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const int key = 16 * w + 2 * t + (kk & 1) + 8 * (kk >> 1);
          const int8_t* p = vraw + key * G * D + 16 * swz<kRow>(key, col / 16) + col % 16;
          if constexpr (DB == 8) {
            const uint2 y = *reinterpret_cast<const uint2*>(p);
            x[kk][0] = y.x ^ 0x80808080u, x[kk][1] = y.y ^ 0x80808080u;
          } else if constexpr (DB == 4) {
            x[kk][0] = *reinterpret_cast<const uint32_t*>(p) ^ 0x80808080u, x[kk][1] = 0u;
          } else {
            x[kk][0] = *reinterpret_cast<const uint16_t*>(p) ^ 0x8080u, x[kk][1] = 0u;
          }
        }
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int db = 0; db < DB; ++db) vb[db][h] = widen_pair(x[2 * h][db / 4], x[2 * h + 1][db / 4], db % 4);
      }
      float ksc[2], vsc[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) ksc[r] = sm.ks[st][16 * w + g + 8 * r], vsc[r] = sm.vs[st][16 * w + g + 8 * r];
      release(&sm.empty[st]);  // all of the stage this warp reads is in registers
      const bool whole = dense[c];  // every row sees every key of the chunk: no mask
      const uint32_t mb = whole ? ~0u : bits[c * 128 + (threadIdx.x & 127)];
      wgmma_wait<0>();
      fence_regs(sc);
      // k_scale; masked: -1e30 (skipped where every row sees every key of the chunk); keys past
      // N (the last chunk only): -inf, no weight even in a masked row
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& x = sc[nb][2 * r + e];
            x *= ksc[r];
            if (!whole) x = (mb >> (2 * (2 * nb + e) + r)) & 1u ? x : kDecMaskNeg;
          }
      if (key0 + kDecChunk > a.N)
#pragma unroll
        for (int r = 0; r < 2; ++r)
          if (key0 + 16 * w + g + 8 * r >= a.N)
#pragma unroll
            for (int nb = 0; nb < NB; ++nb) sc[nb][2 * r] = sc[nb][2 * r + 1] = -INFINITY;
      // Online softmax per query column over the warp's 16 keys (rows g, g + 8 of the 8 lanes of
      // equal t). The running max moves only where a score of the warp lies more than
      // kDecRescale above its column's (always on the first chunk): then every column takes its
      // exact max, and the denominators and outputs their alpha. The weights 2^(s - m) stay
      // below 2^kDecRescale, rounded to bf16 with the same relative error.
      bool over = false;
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int x = 0; x < 4; ++x) over = over || sc[nb][x] > m[nb][x & 1] + kDecRescale;
      if (__any_sync(0xffffffffu, over)) {
        float alpha[NB][2];
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float y = fmaxf(sc[nb][e], sc[nb][2 + e]);
            y = fmaxf(y, __shfl_xor_sync(0xffffffffu, y, 4));
            y = fmaxf(y, __shfl_xor_sync(0xffffffffu, y, 8));
            y = fmaxf(y, __shfl_xor_sync(0xffffffffu, y, 16));
            y = fmaxf(y, m[nb][e]);
            alpha[nb][e] = fast_exp2(m[nb][e] - (y == -INFINITY ? 0.f : y));
            l[nb][e] *= alpha[nb][e];
            m[nb][e] = y;
          }
        // the output's rows 16 mt + g (h = 0) and + 8 (h = 1) take their columns' alpha
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float a0 = __shfl_sync(0xffffffffu, alpha[2 * mt + h][0], src);
            const float a1 = __shfl_sync(0xffffffffu, alpha[2 * mt + h][1], src);
            const float ar = (g & 1) ? a1 : a0;
#pragma unroll
            for (int db = 0; db < DB; ++db) o[mt][db][2 * h] *= ar, o[mt][db][2 * h + 1] *= ar;
          }
      }
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float mu = m[nb][e] == -INFINITY ? 0.f : m[nb][e];
          const float p0 = fast_exp2(sc[nb][e] - mu), p1 = fast_exp2(sc[nb][2 + e] - mu);
          l[nb][e] += p0 + p1;
          sc[nb][e] = p0 * vsc[0];  // rounded to bf16 below, as the TPU body rounds e * v_scale
          sc[nb][2 + e] = p1 * vsc[1];
        }
      // P = (S^T)^T in bf16 as the A fragments of P V: movmatrix gives thread g, t query row
      // 8 nb + g, keys 8 r + 2t, + 1
      uint32_t pa[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          pa[mt][2 * r] = movmatrix_t(pack_bf16(sc[2 * mt][2 * r], sc[2 * mt][2 * r + 1]));
          pa[mt][2 * r + 1] = movmatrix_t(pack_bf16(sc[2 * mt + 1][2 * r], sc[2 * mt + 1][2 * r + 1]));
        }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int db = 0; db < DB; ++db) mma_bf16(o[mt][db], pa[mt], vb[db][0], vb[db][1]);  // O += P V
    }
    release(&sm.q_empty[qb]);  // the item's last S^T product was waited on

    // merge the four warps: maxima and denominators first
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float s = l[nb][e];
        s += __shfl_xor_sync(0xffffffffu, s, 4);
        s += __shfl_xor_sync(0xffffffffu, s, 8);
        s += __shfl_xor_sync(0xffffffffu, s, 16);
        if (g == 0) mg.m[j][w][8 * nb + 2 * t + e] = m[nb][e], mg.l[j][w][8 * nb + 2 * t + e] = s;
      }
    warpgroup_sync(1 + j);
    // each warp's output times 2^(its max - the row's max) / the row's denominator: warps 0 and
    // 1 write theirs, then warps 2 and 3 add theirs to them
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int q = 16 * mt + 8 * h + g;
        float mx = mg.m[j][0][q];
#pragma unroll
        for (int x = 1; x < 4; ++x) mx = fmaxf(mx, mg.m[j][x][q]);
        float den = 0.f;
#pragma unroll
        for (int x = 0; x < 4; ++x) den += mg.l[j][x][q] * fast_exp2(mg.m[j][x][q] - mx);
        const float f = fast_exp2(mg.m[j][w][q] - mx) / den;
#pragma unroll
        for (int db = 0; db < DB; ++db)
#pragma unroll
          for (int e = 0; e < 2; ++e) o[mt][db][2 * h + e] *= f;
      }
#pragma unroll
    for (int round = 0; round < 2; ++round) {
      if ((w >> 1) == round)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int db = 0; db < DB; ++db)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                float& y = mg.o[j][w & 1][16 * mt + 8 * h + g][DB * (2 * t + e) + db];
                y = round ? y + o[mt][db][2 * h + e] : o[mt][db][2 * h + e];
              }
      warpgroup_sync(1 + j);
    }
    // the sum, rows < Q, in bf16
    __nv_bfloat16* out = a.out + (size_t)it.b * a.Q * a.H + (size_t)(it.h0 + j) * D;
    for (int x = threadIdx.x & 127; x < NQ * D; x += 128) {
      const int q = x / D, d = x % D;
      if (it.q0 + q < a.Q)
        out[(size_t)(it.q0 + q) * a.H + d] = __float2bfloat16_rn(mg.o[j][0][q][d] + mg.o[j][1][q][d]);
    }
  }
}

// The kernel body: G consumer warpgroups and the producer warpgroup; NQ
// query rows an item (kDecRows: the rows design; 16 or 32: the keys design,
// int8 cache only).
template <int D, int G, bool kInt8, int NQ>
__device__ __forceinline__ void decode_attention_ws(const CUtensorMap* q_map, const CUtensorMap* k_map,
                                                    const CUtensorMap* v_map, const DecodeArgs& a) {
  static_assert(G <= dec_max_heads(D), "a block holds at most dec_max_heads(D) heads");
  static_assert(NQ == kDecRows || (kInt8 && (NQ == 16 || NQ == 32)), "the keys design is the int8 cache's");
  using Smem = DecSmem<D, G, kInt8, NQ>;
  Smem& sm = dec_smem_init<Smem>();
  if (threadIdx.x >= 128 * G) {
    setmaxnreg_dec<kDecProducerRegs>();
    if constexpr (NQ == kDecRows) decode_produce<D, G, kInt8>(sm, q_map, k_map, v_map, a);
    else decode_produce_keys<D, G, NQ>(sm, q_map, k_map, v_map, a);
    return;
  }
  setmaxnreg_inc<dec_consumer_regs(G)>();
  if constexpr (NQ == kDecRows) decode_consume<D, G, kInt8>(sm, a);
  else decode_consume_keys<D, G, NQ>(sm, a);
}

// The heads a block takes: the largest of dec_max_heads(D), 2 and 1 that
// divides the heads.
inline int dec_heads(int D, int heads) {
  const int g = dec_max_heads(D);
  return heads % g == 0 ? g : (heads % 2 == 0 ? 2 : 1);
}

// Launches kernel (a __global__ wrapper of decode_attention_ws<D, G,
// kInt8, NQ>) on the tensor maps: once per device it checks that ptxas gave
// the kernel the registers that its setmaxnreg budget assumes (else the
// consumers' increase would be undefined or wait forever: cudaError_t 9),
// raises its dynamic shared memory limit to Hopper's and reads the SM
// count; the grid is persistent, the items or dec_min_blocks(G) blocks an
// SM, whichever is fewer.
template <int D, int G, bool kInt8, int NQ, typename Kernel>
cudaError_t launch_decode(Kernel kernel, const CUtensorMap& q_map, const CUtensorMap& k_map,
                          const CUtensorMap& v_map, const DecodeArgs& a, cudaStream_t stream) {
  const size_t smem = dec_smem_bytes<D, G, kInt8, NQ>(a.N);
  if (smem > kDecSmemLimit) return cudaErrorInvalidValue;
  static unsigned configured = 0;  // bit i: set on device i
  static int sms[32];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 32) return cudaErrorInvalidDevice;
  if (!((configured >> dev) & 1u)) {
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, kernel);
    if (err == cudaSuccess && attr.numRegs != dec_entry_regs(G)) err = cudaErrorInvalidConfiguration;
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kDecSmemLimit);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    configured |= 1u << dev;
  }
  const long long items = (long long)a.B * (a.heads / G) * ((a.Q + NQ - 1) / NQ);
  const int grid = (int)(items < (long long)sms[dev] * dec_min_blocks(G) ? items : sms[dev] * dec_min_blocks(G));
  kernel<<<grid, dec_threads(G), smem, stream>>>(q_map, k_map, v_map, a);
  return cudaGetLastError();
}

}  // namespace
