"""The order of operations of the bf16 tensor-core decode kernels K1 and K2
(``ctrl_sim_tpu_torch/csrc/decode_mma.cuh``), emulated here in PyTorch on
the CPU, against the JAX kernels in interpret mode, at the rollout's shapes
(Q = 32 on pass 1 and 16 on pass 2, N = 32 x 3 x 16 = 1536 keys, H = 256 =
8 heads x 32, bf16; two lanes) under ``stream_step_masks`` at steps from
t = 0 (rows that see no key, whole chunks of unwritten slots) through the
ring's wrap to the last step, within the card tests' 2e-2 on rows with a
visible key.

A warp of the kernels walks all the keys of one (lane, head) in 32-key
chunks, keeps a running max per row, and rounds each chunk's weights (times
``v_scale`` over the int8 cache) to bf16 against that running max; the TPU
kernels round the weights against the row's global max. (A layout that
split a head's keys over 4 warps was tried once on the card and dropped.)
This shows that the kernels' rounding points fit the tolerance; the CUDA
kernels themselves are held to the plain versions on the card
(``tests/test_torch_kernels.py``). The emulation is test-only: nothing on
the main path uses it."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctrl_sim_tpu.ops import attention as jattn
from ctrl_sim_tpu_torch.ops import attention as tattn
from ctrl_sim_tpu_torch.ops.masks import stream_step_masks

torch.set_num_threads(2)

CHUNK = 32  # decode_mma.cuh: kDecChunk
MASK_NEG = -1e30
LANES, SLOTS, WINDOW, TYPES, HEADS, H = 2, 16, 32, 3, 8, 256


def emulate_kernel_order(q, k, v, mask, heads, k_scale=None, v_scale=None):
    """The bf16 kernels' arithmetic on q [B, Q, H] bf16 and K/V [B, N, H]
    (bf16, or int8 with fp32 ``k_scale``/``v_scale`` [B, N]): the keys walked
    in 32-key chunks with fp32 scores, a running max and bf16 weights; the
    fp32 denominator dividing the output; output in bf16."""
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


def _inputs(seed, int8):
    rng = np.random.default_rng(seed)
    N = WINDOW * TYPES * SLOTS
    q = torch.as_tensor(rng.normal(size=(LANES, 2 * SLOTS, H)).astype(np.float32)).bfloat16()
    k, v = (torch.as_tensor(rng.normal(size=(LANES, N, H)).astype(np.float32)) for _ in range(2))
    if int8:
        (k, ks), (v, vs) = tattn.quantize_rows(k), tattn.quantize_rows(v)
        return q, k, v, ks, vs
    return q, k.bfloat16(), v.bfloat16(), None, None


def _jax(x):
    return jnp.asarray(x.float().numpy()).astype(jnp.bfloat16) if x.dtype == torch.bfloat16 else jnp.asarray(x.numpy())


@pytest.mark.parametrize("cache", ["bfloat16", "int8"])
@pytest.mark.parametrize("t", [0, 1, 2, 16, 31, 32, 45, 89])
@pytest.mark.parametrize("decode_pass", [1, 2])
def test_kernel_order_matches_jax_kernel(cache, t, decode_pass):
    int8 = cache == "int8"
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
