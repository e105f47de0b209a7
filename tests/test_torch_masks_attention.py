"""The port's attention masks (bit for bit) and kernel K1's plain version
(to 1e-5) held against the JAX package: ``stream_step_masks``, ``visible``
and ``cached_decode_attention`` as the JAX tests run it on the CPU, in
interpret mode and through the einsum path."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctrl_sim_tpu.models.layers import MultiHeadAttention as JaxMHA
from ctrl_sim_tpu.ops import masks as jmasks
from ctrl_sim_tpu.ops.attention import cached_decode_attention as jax_decode_attention
from ctrl_sim_tpu_torch.models.layers import MultiHeadAttention as TorchMHA
from ctrl_sim_tpu_torch.ops import attention as tattn
from ctrl_sim_tpu_torch.ops import masks as tmasks
from ctrl_sim_tpu_torch.params import from_flax_params
from torch_port_common import t2n

torch.set_num_threads(2)


@pytest.mark.parametrize(
    "steps,window,agents,types,own",
    [(90, 32, 16, 3, False), (20, 8, 8, 3, False), (12, 5, 3, 3, True), (10, 4, 6, 3, False)],
)
def test_stream_step_masks_bit_equal(steps, window, agents, types, own):
    j1, j2 = jmasks.stream_step_masks(steps, window, agents, types, 0, own)
    t1, t2 = tmasks.stream_step_masks(steps, window, agents, types, 0, own, device="cpu")
    assert t1.dtype == torch.int8 and t2.dtype == torch.int8
    np.testing.assert_array_equal(t2n(t1), np.asarray(j1))
    np.testing.assert_array_equal(t2n(t2), np.asarray(j2))


@pytest.mark.parametrize("own,window", [(False, None), (True, None), (False, 3)])
def test_visible_bit_equal(own, window):
    rng = np.random.default_rng(0)
    n = 400
    c = {k: rng.integers(0, 6, n) for k in ("ti", "ai", "tj", "aj", "kj")}
    c["kj"] %= 3
    c["ii"] = c["ti"] * 18 + c["ai"] * 3 + rng.integers(0, 3, n)
    c["jj"] = c["tj"] * 18 + c["aj"] * 3 + c["kj"]
    q = {k: c[k][:, None] for k in ("ti", "ai", "ii")}
    kk = {k: c[k][None, :] for k in ("tj", "aj", "kj", "jj")}
    want = np.asarray(jmasks.visible(**q, **kk, state_index=0, attend_own_return_action=own, window=window))
    got = tmasks.visible(**{k: torch.as_tensor(v) for k, v in {**q, **kk}.items()},
                         state_index=0, attend_own_return_action=own, window=window)
    np.testing.assert_array_equal(t2n(got), want)


def _case(B, Q, N, H, seed, full_rows=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, Q, H)).astype(np.float32)
    k = rng.normal(size=(B, N, H)).astype(np.float32)
    v = rng.normal(size=(B, N, H)).astype(np.float32)
    mask = rng.random((Q, N)) > 0.3
    mask[:, 0] = True
    mask[:full_rows] = False  # rows with no visible key
    return q, k, v, mask


def _einsum_reference(q, k, v, mask, heads):
    """The JAX einsum path the CPU decode takes (MultiHeadAttention._attend_impl)."""
    B, Q, H = q.shape
    mha = JaxMHA(heads, jnp.float32, 0.0, d_model=H)
    x = jnp.zeros((1, 1, H))
    params = mha.init(jax.random.PRNGKey(0), x, x, x)
    return np.asarray(mha.apply(
        params, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask)[None, None],
        None, True, method=lambda m, *a: m._attend_impl(*a),
    ))


@pytest.mark.parametrize(
    "B,Q,N,H,heads",
    [(2, 8, 48, 64, 2), (3, 12, 96, 64, 4), (2, 16, 192, 128, 4), (1, 32, 192, 256, 8)],
)
def test_decode_attention_reference_matches_jax(B, Q, N, H, heads):
    q, k, v, mask = _case(B, Q, N, H, seed=Q + N)
    got = t2n(tattn.cached_decode_attention_reference(*map(torch.as_tensor, (q, k, v, mask)), heads))
    want = np.asarray(jax_decode_attention(q, k, v, jnp.asarray(mask), heads, interpret=True))
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(got, _einsum_reference(q, k, v, mask, heads), atol=1e-5)


def test_decode_attention_fully_masked_rows_finite():
    q, k, v, mask = _case(2, 12, 96, 64, seed=4, full_rows=4)
    got = t2n(tattn.cached_decode_attention_reference(*map(torch.as_tensor, (q, k, v, mask)), 4))
    assert np.isfinite(got).all()
    want = np.asarray(jax_decode_attention(q, k, v, jnp.asarray(mask), 4, interpret=True))
    np.testing.assert_allclose(got, want, atol=1e-5)  # uniform over N on both sides
    np.testing.assert_allclose(got[:, 0], v.mean(axis=1), atol=1e-5)


def test_decode_attention_wrapper_on_cpu_uses_plain_version():
    q, k, v, mask = map(torch.as_tensor, _case(2, 8, 48, 64, seed=5))
    before = tattn.cached_decode_attention.launches
    out = tattn.cached_decode_attention(q, k, v, mask.to(torch.int8), 2)
    assert tattn.cached_decode_attention.launches == before  # no kernel launched
    torch.testing.assert_close(out, tattn.cached_decode_attention_reference(q, k, v, mask, 2))
    bf = tattn.cached_decode_attention(q.bfloat16(), k.bfloat16(), v.bfloat16(), mask, 2)
    assert bf.dtype == torch.bfloat16 and torch.isfinite(bf.float()).all()


@pytest.mark.parametrize(
    "bad",
    ["k_shape", "mask_shape", "dtype", "mixed_dtype", "head_width"],
)
def test_decode_attention_wrapper_rejects(bad):
    q, k, v, mask = map(torch.as_tensor, _case(1, 8, 48, 64, seed=6))
    heads = 2
    if bad == "k_shape":
        k = k[:, :40]
    elif bad == "mask_shape":
        mask = mask[:, :40]
    elif bad == "dtype":
        q, k, v = q.double(), k.double(), v.double()
    elif bad == "mixed_dtype":
        k = k.bfloat16()
    elif bad == "head_width":
        heads = 5  # 5 heads do not divide H = 64
    with pytest.raises((ValueError, TypeError)):
        tattn.cached_decode_attention(q, k, v, mask, heads)


@pytest.mark.parametrize("score_dtype,atol", [("float32", 1e-5), ("bfloat16", 2e-2)])
def test_attend_impl_matches_jax(score_dtype, atol):
    """The einsum attention of the cross-attention and the encoders, with
    key padding and a stored-score dtype."""
    rng = np.random.default_rng(7)
    B, Tq, Tk, H, heads = 3, 8, 20, 64, 4
    q = rng.normal(size=(B, Tq, H)).astype(np.float32)
    kv = rng.normal(size=(B, Tk, H)).astype(np.float32)
    kpm = rng.random((B, Tk)) > 0.3
    kpm[0] = False  # a fully padded row stays finite
    jm = JaxMHA(heads, jnp.float32, 0.0, d_model=H, score_dtype=jnp.dtype(score_dtype))
    params = jm.init(jax.random.PRNGKey(1), q, kv, kv)
    want = np.asarray(jm.apply(params, q, kv, kv, key_padding_mask=jnp.asarray(kpm)))
    tm = TorchMHA(H, heads, torch.float32, score_dtype=getattr(torch, score_dtype))
    tm.load_state_dict(from_flax_params(jax.tree.map(np.asarray, params)), strict=True)
    got = t2n(tm(torch.as_tensor(q), torch.as_tensor(kv), torch.as_tensor(kv),
                 key_padding_mask=torch.as_tensor(kpm)).detach())
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=atol)
