"""The order of operations of the bf16 tensor-core decode kernels K1 and K2
(``ctrl_sim_tpu_torch/csrc/decode_mma.cuh``), emulated here in PyTorch on
the CPU, against the JAX kernels in interpret mode, at the rollout's shapes
(Q = 32 on pass 1 and 16 on pass 2, N = 32 x 3 x 16 = 1536 keys, H = 256 =
8 heads x 32, bf16; two lanes) under ``stream_step_masks`` at steps from
t = 0 (rows that see no key, whole chunks of unwritten slots) through the
ring's wrap to the last step, and at DT's decode pass (Q = 48 over the same
1536 keys, the masks its rollout records), within the card tests' 2e-2 on
rows with a visible key.

Both designs walk the keys once for every query row, in 64-key chunks, and
round the weights (times ``v_scale`` over the int8 cache) to bf16 against a
running max; the TPU kernels round them against the row's global max.
- The rows design (K1, and K2 at Q > 32): a consumer warpgroup takes one
  (lane, head) and all the lane's query rows in one 64-row tile, multiplies
  the fp32 scores by ``k_scale`` (over the int8 cache, widened to bf16
  exactly beforehand) and keeps a running max per row.
- The keys design (K2 at Q <= 32): S^T = K Q^T puts the keys on the 64-row
  side, so each warp of the warpgroup takes 16 keys of every chunk, with a
  running max, denominator and output of its own per row; the max moves
  only when a score of the warp lies more than 8 (log2 units) above its
  row's, and then every row of the warp takes its exact max. The four
  warps are merged at the end.
This shows that the kernels' rounding points fit the tolerance; the CUDA
kernels themselves are held to the plain versions on the card
(``tests/test_torch_kernels.py``). The emulation is test-only: nothing on
the main path uses it."""

import functools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctrl_sim_tpu.ops import attention as jattn
from ctrl_sim_tpu_torch.ops import attention as tattn
from ctrl_sim_tpu_torch.ops.masks import stream_step_masks
from ctrl_sim_tpu_torch.rollout.setup import decode_masks

torch.set_num_threads(2)

CHUNK = 64  # decode_mma.cuh: kDecChunk
MASK_NEG = -1e30
KEYS_ROWS = 32  # K2 takes the keys design at Q <= 32 (16- or 32-row items)
WARP_KEYS = 16  # the keys design: keys of a chunk each warp takes
RESCALE = 8.0  # decode_mma.cuh: kDecRescale
LANES, SLOTS, WINDOW, TYPES, HEADS, H = 2, 16, 32, 3, 8, 256


def emulate_kernel_order(q, k, v, mask, heads, k_scale=None, v_scale=None):
    """The bf16 kernels' arithmetic on q [B, Q, H] bf16 and K/V [B, N, H]
    (bf16, or int8 with fp32 ``k_scale``/``v_scale`` [B, N]): every query
    row in one pass over the keys, walked in 64-key chunks with fp32 scores
    (times ``k_scale``), a running max and bf16 weights (times
    ``v_scale``); the fp32 denominator dividing the output; output in bf16.
    K2's keys design at Q <= 32 in ``_emulate_keys_order``."""
    if k_scale is not None and q.shape[1] <= KEYS_ROWS:
        return _emulate_keys_order(q, k, v, mask, heads, k_scale, v_scale)
    B, Q, _ = q.shape
    N = k.shape[1]
    d = H // heads
    qs = tattn._prescale(q, heads).float().view(B, Q, heads, d).transpose(1, 2)  # [B, h, Q, d]
    kh, vh = (x.float().view(B, N, heads, d).transpose(1, 2) for x in (k, v))  # [B, h, N, d]
    visible = mask != 0
    m = torch.full((B, heads, Q), -math.inf)
    l = torch.zeros((B, heads, Q))
    acc = torch.zeros((B, heads, Q, d))
    for c0 in range(0, N, CHUNK):
        j = slice(c0, min(N, c0 + CHUNK))
        s = qs @ kh[:, :, j].transpose(-1, -2)  # [B, h, Q, chunk]
        if k_scale is not None:
            s = s * k_scale[:, None, None, j]
        s = torch.where(visible[:, j], s, torch.tensor(MASK_NEG))
        mx = torch.maximum(m, s.amax(-1))
        mu = torch.where(mx == -math.inf, 0.0, mx)
        alpha = torch.exp2(m - mu)
        p = torch.exp2(s - mu[..., None])
        l = l * alpha + p.sum(-1)
        wts = p if v_scale is None else p * v_scale[:, None, None, j]
        acc = acc * alpha[..., None] + wts.bfloat16().float() @ vh[:, :, j]
        m = mx
    return (acc / l[..., None]).transpose(1, 2).reshape(B, Q, H).bfloat16()


def _emulate_keys_order(q, k, v, mask, heads, k_scale, v_scale):
    """K2's keys design: the query rows padded with zero rows to a 16- or
    32-row item (seeing every key); per warp w, keys 16 w to 16 w + 15 of
    each chunk with its own running max, denominator and output per row;
    the max moves, to the exact max of every row of the warp, only when a
    score of the warp (any row) lies more than ``RESCALE`` above its row's;
    the warps merged as 2^(m_w - max) / denominator."""
    B, Q, _ = q.shape
    N = k.shape[1]
    d = H // heads
    rows = 16 if Q <= 16 else KEYS_ROWS
    qs = tattn._prescale(q, heads).float().view(B, Q, heads, d).transpose(1, 2)  # [B, h, Q, d]
    qs = torch.cat([qs, torch.zeros((B, heads, rows - Q, d))], dim=2)
    kh, vh = (x.float().view(B, N, heads, d).transpose(1, 2) for x in (k, v))  # [B, h, N, d]
    visible = torch.cat([mask != 0, torch.ones((rows - Q, N), dtype=torch.bool)])
    warps = CHUNK // WARP_KEYS
    m = torch.full((warps, B, heads, rows), -math.inf)
    l = torch.zeros((warps, B, heads, rows))
    acc = torch.zeros((warps, B, heads, rows, d))
    for c0 in range(0, N, CHUNK):
        for w in range(warps):
            j = slice(c0 + WARP_KEYS * w, min(N, c0 + WARP_KEYS * (w + 1)))
            if j.start >= j.stop:  # keys past N take no weight
                continue
            s = qs @ kh[:, :, j].transpose(-1, -2) * k_scale[:, None, None, j]  # [B, h, rows, keys]
            s = torch.where(visible[:, j], s, torch.tensor(MASK_NEG))
            over = (s > (m[w] + RESCALE)[..., None]).flatten(-2).any(-1)[..., None]  # [B, h, 1]
            mx = torch.where(over, torch.maximum(m[w], s.amax(-1)), m[w])
            alpha = torch.exp2(m[w] - torch.where(mx == -math.inf, 0.0, mx))
            l[w] = torch.where(over, l[w] * alpha, l[w])
            acc[w] = torch.where(over[..., None], acc[w] * alpha[..., None], acc[w])
            m[w] = mx
            p = torch.exp2(s - torch.where(mx == -math.inf, 0.0, mx)[..., None])
            l[w] = l[w] + p.sum(-1)
            acc[w] = acc[w] + (p * v_scale[:, None, None, j]).bfloat16().float() @ vh[:, :, j]
    top = m.amax(0)
    f = torch.exp2(m - top)
    out = (acc * (f / (l * f).sum(0))[..., None]).sum(0)[:, :, :Q]
    return out.transpose(1, 2).reshape(B, Q, H).bfloat16()


def _inputs(seed, int8, rows=2 * SLOTS):
    rng = np.random.default_rng(seed)
    N = WINDOW * TYPES * SLOTS
    q = torch.as_tensor(rng.normal(size=(LANES, rows, H)).astype(np.float32)).bfloat16()
    k, v = (torch.as_tensor(rng.normal(size=(LANES, N, H)).astype(np.float32)) for _ in range(2))
    if int8:
        (k, ks), (v, vs) = tattn.quantize_rows(k), tattn.quantize_rows(v)
        return q, k, v, ks, vs
    return q, k.bfloat16(), v.bfloat16(), None, None


@functools.lru_cache(maxsize=None)
def _dt_masks():
    """The [48, 1536] masks of DT's decode pass at every step of its
    full-width rollout (``decode_masks``; about 5 s on the CPU, once)."""
    return [passes[0] for passes in decode_masks("dt", 90, "cpu")]


def _jax(x):
    return jnp.asarray(x.float().numpy()).astype(jnp.bfloat16) if x.dtype == torch.bfloat16 else jnp.asarray(x.numpy())


@pytest.mark.parametrize("cache", ["bfloat16", "int8"])
@pytest.mark.parametrize("t", [0, 1, 2, 16, 31, 32, 45, 89])
@pytest.mark.parametrize("decode_pass", [1, 2, "dt"])
def test_kernel_order_matches_jax_kernel(cache, t, decode_pass):
    int8 = cache == "int8"
    if decode_pass == "dt":  # DT's 48 query rows in one pass
        mask = _dt_masks()[t]
        q, k, v, ks, vs = _inputs(seed=10 * t + 3, int8=int8, rows=mask.shape[0])
    else:
        m1, m2 = stream_step_masks(t + 1, WINDOW, SLOTS, TYPES, 0, device="cpu")
        mask = (m1 if decode_pass == 1 else m2)[t]
        q, k, v, ks, vs = _inputs(seed=10 * t + decode_pass, int8=int8)
    q = q[:, : mask.shape[0]].contiguous()
    got = emulate_kernel_order(q, k, v, mask, HEADS, ks, vs).float()
    jm = jnp.asarray(mask.numpy())
    if int8:
        want = jattn.cached_decode_attention_q8(_jax(q), *map(_jax, (k, v, ks, vs)), jm, HEADS, interpret=True)
    else:
        want = jattn.cached_decode_attention(_jax(q), _jax(k), _jax(v), jm, HEADS, interpret=True)
    want = torch.as_tensor(np.array(want.astype(jnp.float32)))
    assert torch.isfinite(got).all()  # fully masked rows (t = 0) included
    rows = (mask != 0).any(dim=1)
    assert rows.any()
    torch.testing.assert_close(got[:, rows], want[:, rows], atol=2e-2, rtol=0)
