"""The int8 KV cache of the port (kernel K2's path) held against the JAX
package: ``quantize_rows`` bit for bit, K2's plain version against
``cached_decode_attention_q8`` in interpret mode, the int8 decode passes
against the JAX ``decode_step`` (whose CPU path dequantizes the cache and
takes the einsum attention), and ``run_streaming`` with
``model.kv_cache_dtype=int8`` against the JAX ``run_streaming`` under the
JAX rollout's replayed draws."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctrl_sim_tpu.ops import attention as jattn
from ctrl_sim_tpu_torch.ops import attention as tattn
from torch_port_common import (
    configs,
    jax_stream,
    models,
    replay_jax_rollout,
    scenes,
    stream_inputs,
    t2n,
    torch_stream,
)

torch.set_num_threads(2)

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_rows_bit_equal(dtype):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 40, 64)).astype(np.float32) * rng.uniform(0.01, 30, size=(3, 40, 1)).astype(np.float32)
    x[0, 0] = 0.0  # an all-zero row takes the 1e-12 floor
    x[0, 1, :4] = [127.0, -63.5, 0.5, 1.5]  # exact halves round to even on both sides
    jv, js = jattn.quantize_rows(jnp.asarray(x, JDT[dtype]))
    tv, ts = tattn.quantize_rows(torch.as_tensor(x).to(getattr(torch, dtype)))
    assert tv.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(t2n(tv), np.asarray(jv))
    np.testing.assert_array_equal(t2n(ts), np.asarray(js))


def _q8_case(B, Q, N, H, dtype, seed, full_rows=0):
    """Numpy q, int8 K/V with their scales (quantized by the JAX package)
    and a [Q, N] mask whose first ``full_rows`` rows see no key."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, Q, H)).astype(np.float32)
    k, ks = jattn.quantize_rows(jnp.asarray(rng.normal(size=(B, N, H)).astype(np.float32), JDT[dtype]))
    v, vs = jattn.quantize_rows(jnp.asarray(rng.normal(size=(B, N, H)).astype(np.float32), JDT[dtype]))
    mask = rng.random((Q, N)) > 0.3
    mask[:, 0] = True
    mask[:full_rows] = False
    return q, *(np.asarray(a) for a in (k, v, ks, vs)), mask


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Q,d,full_rows", [(32, 32, 0), (16, 32, 0), (12, 16, 0), (12, 16, 4), (16, 16, 3)])
def test_q8_reference_matches_jax_interpret(dtype, Q, d, full_rows):
    """The plain version copies the TPU body's roundings, so in float32 it
    agrees to 1e-5 and in bfloat16 to one bf16 step of the output (2^-8
    relative); fully masked rows come out finite (uniform over N)."""
    heads, N = 4, 96
    q, k, v, ks, vs, mask = _q8_case(2, Q, N, heads * d, dtype, seed=Q * d + full_rows, full_rows=full_rows)
    want = np.asarray(jattn.cached_decode_attention_q8(
        jnp.asarray(q, JDT[dtype]), jnp.asarray(k), jnp.asarray(v), jnp.asarray(ks), jnp.asarray(vs),
        jnp.asarray(mask), heads, interpret=True).astype(jnp.float32))
    got = tattn.cached_decode_attention_q8_reference(
        torch.as_tensor(q).to(getattr(torch, dtype)), *map(torch.as_tensor, (k, v, ks, vs, mask)), heads)
    assert got.dtype == getattr(torch, dtype)
    got = t2n(got.float())
    assert np.isfinite(got).all()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    else:
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=2**-8)


def test_q8_wrapper_on_cpu_uses_plain_version_and_rejects():
    q, k, v, ks, vs, mask = map(torch.as_tensor, _q8_case(2, 8, 48, 64, "float32", seed=5))
    before = tattn.cached_decode_attention_q8.launches
    out = tattn.cached_decode_attention_q8(q, k, v, ks, vs, mask.to(torch.int8), 2)
    assert tattn.cached_decode_attention_q8.launches == before  # no kernel launched
    torch.testing.assert_close(out, tattn.cached_decode_attention_q8_reference(q, k, v, ks, vs, mask, 2))
    bad = [
        (q, k.float(), v, ks, vs, mask, 2, TypeError),  # K not int8
        (q, k, v, ks.double(), vs, mask, 2, TypeError),  # scales not float32
        (q.double(), k, v, ks, vs, mask, 2, TypeError),
        (q, k[:, :40], v, ks, vs, mask, 2, ValueError),
        (q, k, v, ks[:, :40], vs, mask, 2, ValueError),
        (q, k, v, ks, vs, mask[:, :40], 2, ValueError),
        (q, k, v, ks, vs, mask, 8, ValueError),  # d = 8 has no kernel instance
    ]
    for *args, error in bad:
        with pytest.raises(error):
            tattn.cached_decode_attention_q8(*args)


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def stream(request):
    """Five steps of both decode passes over an int8 cache, on both sides."""
    jcfg, tcfg = configs(**{"waymo.train_context_length": 4, "model.compute_dtype": request.param,
                            "model.kv_cache_dtype": "int8"})
    jm, params, tm = models(jcfg, tcfg)
    d = stream_inputs(jcfg, B=3, A=8)
    return request.param, tcfg, jax_stream(jcfg, jm, params, d), torch_stream(tcfg, tm, d)


def test_int8_decode_passes_match_jax(stream):
    """Tolerances. float32: the port's K2 plain version folds the scales
    into scores and weights, the JAX CPU path dequantizes first; they agree
    to 1e-4, as the bf16-cache passes do (test_torch_model.py). bfloat16:
    each side rounds to bf16 at other places (and the JAX path rounds the
    dequantized K/V to bf16), so hidden states agree to 0.06 and logits to
    0.03, a few bf16 steps (2^-8 relative) of values up to 4 and 1."""
    dtype, tcfg, want, got = stream
    hidden, logits = (1e-4, 1e-4) if dtype == "float32" else (0.06, 0.03)
    for t, (ours, theirs) in enumerate(zip(got["steps"], want["steps"])):
        for name, a, b, tol in zip(("state pass", "rtg logits", "rtg pass", "action logits"), ours, theirs,
                                   (hidden, logits, hidden, logits)):
            np.testing.assert_allclose(t2n(a.float()), np.asarray(b, np.float32), atol=tol, rtol=0,
                                       err_msg=f"{name} t={t}")


def test_int8_cache_matches_jax(stream):
    """Values and scales written by quantize-on-write: the int8 values
    within one quantization step (two in bf16) of JAX's, where a projected
    value sits within rounding of a half-step; the scales (max|row| / 127)
    within float32 rounding, or a few bf16 steps of the row's largest value
    (3e-2 relative) in bf16."""
    dtype, tcfg, want, got = stream
    tc, jc = got["cache"], want["cache"]
    np.testing.assert_array_equal(np.asarray(tc.slot_t), np.asarray(jc.slot_t))
    steps, scale_rtol = (1, 1e-5) if dtype == "float32" else (2, 3e-2)
    for li in range(tcfg.model.num_decoder_layers):
        for name, tv, ts, jv, js in (("K", tc.k[li], tc.k_scale[li], jc.k[li], jc.k_scale[li]),
                                     ("V", tc.v[li], tc.v_scale[li], jc.v[li], jc.v_scale[li])):
            assert tv.dtype == torch.int8 and ts.dtype == torch.float32
            assert np.abs(t2n(tv).astype(int) - np.asarray(jv).astype(int)).max() <= steps, name
            np.testing.assert_allclose(t2n(ts), np.asarray(js), rtol=scale_rtol, atol=0,
                                       err_msg=f"cache {name} scales layer {li}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_rollout_replay_matches_jax(dtype):
    """Under the JAX rollout's draws the port's int8-cache rollout follows
    the same trajectories (1e-3, as test_torch_rollout.py's bf16-cache
    replay), its decode passes running through K2's plain version."""
    jcfg, tcfg = configs(**{"model.compute_dtype": dtype, "model.kv_cache_dtype": "int8"})
    sb = scenes(jcfg, num_scenes=4, num_agents=8)
    jm, params, tm = models(jcfg, tcfg)
    cache = tm.new_cache(2, 8)
    assert cache.k[0].dtype == torch.int8 and cache.k_scale[0].shape == (2, 8, 3, 8)
    ro, out = replay_jax_rollout(jcfg, tcfg, sb, tm, params, jm)
    assert (ro.acceleration[tcfg.sim.history_steps:][:, sb.moving & sb.agent_valid] != 0).any()
    for name in ("position", "heading", "reward8", "nearest_dist", "existence", "rtgs", "acceleration", "steering"):
        np.testing.assert_allclose(t2n(getattr(out, name)), getattr(ro, name), atol=1e-3, rtol=0, err_msg=name)
