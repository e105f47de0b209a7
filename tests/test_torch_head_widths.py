"""Head widths other than the kernels' instances (16, 32, 64): the plain
versions of K1, K2, K3 and K4 through the port's wrappers on the CPU held
against the JAX kernels, which take any d that divides H, at d = 8 and
d = 48: K1 and K2 against ``cached_decode_attention(_q8)`` in interpret
mode (K2 over a cache that ``quantize_rows`` writes, bit-equal on both
sides), K3's output and lse and K4's gradients (through ``jax.vjp``) against
``flash_mha`` in interpret mode, at the tolerances of the plain versions'
tests (``test_torch_masks_attention.py``, ``test_torch_int8_cache.py``,
``test_torch_flash_attention.py``). Then the rule the wrappers follow on the
card: a head zero-padded to the next instance gives the same scores, lse
and output columns, gradients included, when the scale is that of the true
width; and widths above the widest instance are refused there."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctrl_sim_tpu.ops import attention as jattn
from ctrl_sim_tpu.ops import flash_attention as jfa
from ctrl_sim_tpu_torch.ops import attention as tattn
from ctrl_sim_tpu_torch.ops import flash_attention as tfa
from ctrl_sim_tpu_torch.ops.heads import kernel_head_dim, pad_heads, unpad_heads

torch.set_num_threads(2)

WIDTHS = [8, 48]
HEADS = 4
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _decode_case(d, seed, full_rows=0):
    rng = np.random.default_rng(seed)
    B, Q, N, H = 2, 12, 96, HEADS * d
    q, k, v = (rng.normal(size=s).astype(np.float32) for s in ((B, Q, H), (B, N, H), (B, N, H)))
    mask = rng.random((Q, N)) > 0.3
    mask[:, 0] = True
    mask[:full_rows] = False
    return q, k, v, mask


@pytest.mark.parametrize("d", WIDTHS)
def test_k1_plain_matches_jax(d):
    q, k, v, mask = _decode_case(d, seed=d, full_rows=3)
    got = tattn.cached_decode_attention(*map(torch.as_tensor, (q, k, v, mask)), HEADS).numpy()
    want = np.asarray(jattn.cached_decode_attention(q, k, v, jnp.asarray(mask), HEADS, interpret=True))
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", WIDTHS)
def test_k2_plain_matches_jax(d, dtype):
    q, k, v, mask = _decode_case(d, seed=100 + d)
    jk, jks = jattn.quantize_rows(jnp.asarray(k, JDT[dtype]))
    jv, jvs = jattn.quantize_rows(jnp.asarray(v, JDT[dtype]))
    tk, tks = tattn.quantize_rows(torch.as_tensor(k).to(getattr(torch, dtype)))
    tv, tvs = tattn.quantize_rows(torch.as_tensor(v).to(getattr(torch, dtype)))
    for a, b in ((tk, jk), (tks, jks), (tv, jv), (tvs, jvs)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    want = np.asarray(jattn.cached_decode_attention_q8(
        jnp.asarray(q, JDT[dtype]), jk, jv, jks, jvs, jnp.asarray(mask), HEADS, interpret=True).astype(jnp.float32))
    got = tattn.cached_decode_attention_q8(
        torch.as_tensor(q).to(getattr(torch, dtype)), tk, tv, tks, tvs, torch.as_tensor(mask), HEADS).float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    else:
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=2**-8)


@pytest.mark.parametrize("dropout_p", [0.0, 0.1])
@pytest.mark.parametrize("d", WIDTHS)
def test_k3_k4_plain_matches_jax(d, dropout_p):
    A, K, steps, bq = 3, 3, 4, 8
    T, D = A * K * steps, HEADS * d
    rng = np.random.default_rng(T + D)
    q, k, v, g = (rng.normal(size=(2, T, D)).astype(np.float32) for _ in range(4))
    jspec = jfa.MaskSpec(A, K, 0, False, None)
    seed = jnp.asarray([987654321], jnp.uint32)

    def f(q, k, v):
        return jfa.flash_mha(q, k, v, jspec, HEADS, dropout_p=dropout_p, seed=seed, block_q=bq, interpret=True)

    jout, vjp = jax.vjp(f, *(jnp.asarray(x) for x in (q, k, v)))
    jgrads = vjp(jnp.asarray(g))
    _, jlse = jfa._fwd_call(jspec, HEADS, dropout_p, bq, True, *(jnp.asarray(x) for x in (q, k, v)), seed)

    spec = tfa.MaskSpec(A, K, 0, False, None)
    tq, tk, tv, tg = map(torch.tensor, (q, k, v, g))
    out, lse, keep = tfa.flash_mha_fwd(tq, tk, tv, spec, HEADS, dropout_p, 987654321, keep_bits=True)
    grads = tfa.flash_mha_bwd(tq, tk, tv, out, tg, lse, spec, HEADS, dropout_p, 987654321, keep=keep)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=2e-5, rtol=0)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), atol=2e-5, rtol=0)
    for name, a, b in zip("qkv", grads, jgrads):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=5e-5, rtol=0, err_msg=f"d{name}")


@pytest.mark.parametrize("d", WIDTHS)
def test_zero_padded_heads_give_the_true_width(d):
    """What the wrappers do on the card, run through the plain versions:
    pad each head to the next instance, scale by the true width (for the
    plain versions, which scale by the width they see, q is multiplied by
    sqrt(width / d)), drop the padded columns. Outputs, lse and gradients
    equal those at the true width; the padded gradient columns are zero."""
    width = kernel_head_dim(d)
    assert width == {8: 16, 48: 64}[d]
    up = (width / d) ** 0.5
    q, k, v, mask = map(torch.as_tensor, _decode_case(d, seed=7 * d))
    want = tattn.cached_decode_attention_reference(q, k, v, mask, HEADS)
    padded = tattn.cached_decode_attention_reference(
        pad_heads(q * up, HEADS, width), pad_heads(k, HEADS, width), pad_heads(v, HEADS, width), mask, HEADS)
    torch.testing.assert_close(unpad_heads(padded, HEADS, d), want, atol=1e-5, rtol=1e-5)

    spec = tfa.MaskSpec(3, 3, 0, False, None)
    x = [torch.randn((2, 36, HEADS * d), generator=torch.Generator().manual_seed(i)) for i in range(4)]
    leaves = [t.clone().requires_grad_(True) for t in x[:3]]
    out, lse = tfa.flash_mha_reference(*leaves, spec, HEADS, 0.1, 5)
    grads = torch.autograd.grad(out, leaves, x[3])
    pleaves = [pad_heads(t, HEADS, width).clone().requires_grad_(True) for t in x[:3]]
    pout, plse = tfa.flash_mha_reference(pleaves[0] * up, *pleaves[1:], spec, HEADS, 0.1, 5)
    pgrads = torch.autograd.grad(pout, pleaves, pad_heads(x[3], HEADS, width))
    torch.testing.assert_close(unpad_heads(pout, HEADS, d), out, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(plse, lse, atol=1e-5, rtol=1e-5)
    for pg, g in zip(pgrads, grads):
        torch.testing.assert_close(unpad_heads(pg, HEADS, d), g, atol=1e-5, rtol=1e-5)
        assert not pg.reshape(2, 36, HEADS, width)[..., d:].any()


def test_widths_above_the_widest_instance_are_refused():
    """On the CPU the plain versions take d = 128; the kernels' wrappers
    refuse it before any launch, naming the limit."""
    assert kernel_head_dim(64) == 64 and kernel_head_dim(1) == 16
    with pytest.raises(ValueError, match="widest kernel instance, 64"):
        kernel_head_dim(65)
    q, k, v, mask = map(torch.as_tensor, _decode_case(128, seed=1))
    out = tattn.cached_decode_attention(q, k, v, mask, HEADS)
    torch.testing.assert_close(out, tattn.cached_decode_attention_reference(q, k, v, mask, HEADS))
    with pytest.raises(ValueError, match="do not divide"):
        tattn.cached_decode_attention(q, k, v, mask, 3)
