"""The port at bf16 compute (the default, and the width the card runs)
held against the JAX package: the attention pre-scale factors bit for bit,
kernel K1's plain version against the JAX kernel in interpret mode, the
decode passes over a bf16 cache, the streaming rollout under the JAX
rollout's replayed draws, and the training forward.

Tolerances: each side rounds to bf16 at other places (XLA fuses
elementwise chains and keeps them in float32 between roundings; PyTorch
rounds after each op), so values agree to a few bf16 steps (2^-8
relative), stated per test."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctrl_sim_tpu.data.datagen import generate_offline_data as jax_replay
from ctrl_sim_tpu.data.pipeline import build_train_batch as jax_build_batch
from ctrl_sim_tpu.ops.attention import cached_decode_attention as jax_decode_attention
from ctrl_sim_tpu_torch.models.layers import score_scale
from ctrl_sim_tpu_torch.ops import attention as tattn
from torch_port_common import (
    configs,
    jax_scenario,
    jax_stream,
    models,
    replay_jax_rollout,
    scenes,
    stream_inputs,
    t2n,
    torch_stream,
)

torch.set_num_threads(2)

BF16 = {"model.compute_dtype": "bfloat16"}


@pytest.mark.parametrize("d", [16, 32, 64])
def test_prescale_factors_bit_equal_jax(d):
    """K1's and K2's q pre-scale, ``q * log2(e)/sqrt(d)`` with the factor
    rounded to q's dtype first (ctrl_sim_tpu/ops/attention.py:130, :221),
    and the einsum attention's ``1/sqrt(d)`` (models/layers.py:183)."""
    rng = np.random.default_rng(d)
    q = rng.normal(size=(2, 16, 4 * d)).astype(np.float32) * 3
    want = jnp.asarray(q, jnp.bfloat16) * jnp.asarray(1.4426950408889634 / (d ** 0.5), jnp.bfloat16)
    got = tattn._prescale(torch.as_tensor(q).bfloat16(), 4)
    np.testing.assert_array_equal(t2n(got.float()), np.asarray(want.astype(jnp.float32)))
    for tdt, jdt in ((torch.bfloat16, jnp.bfloat16), (torch.float32, jnp.float32)):
        want = jnp.asarray(1.0 / jnp.sqrt(d), jdt)
        assert score_scale(d, tdt).dtype == tdt
        assert float(score_scale(d, tdt)) == float(want)


@pytest.mark.parametrize("B,Q,N,H,heads", [(2, 16, 96, 256, 8), (2, 32, 192, 128, 4), (3, 12, 96, 64, 4)])
def test_decode_attention_reference_bf16_matches_jax(B, Q, N, H, heads):
    """Within one bf16 step of the output (2^-8 relative): the plain version
    rounds the pre-scale factor and the weights as the TPU kernel does.
    (With the factor unrounded the mean error at B=2, Q=16, N=96, H=256 was
    1.9e-3, several steps.)"""
    rng = np.random.default_rng(Q + N)
    q, k, v = (rng.normal(size=s).astype(np.float32) for s in ((B, Q, H), (B, N, H), (B, N, H)))
    mask = rng.random((Q, N)) > 0.3
    mask[:, 0] = True
    mask[:2] = False  # fully masked rows: uniform over N on both sides
    want = np.asarray(jax_decode_attention(*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)), jnp.asarray(mask),
                                           heads, interpret=True).astype(jnp.float32))
    got = tattn.cached_decode_attention_reference(*(torch.as_tensor(x).bfloat16() for x in (q, k, v)),
                                                  torch.as_tensor(mask), heads)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(t2n(got.float()), want, atol=1e-6, rtol=2**-8)


def test_decode_passes_bf16_match_jax():
    """Five steps of both decode passes over a bf16 cache: hidden states
    (up to about 4) within 0.06 and logits (up to about 1) within 0.03, a
    few bf16 steps; the cache's K/V rows within 0.06."""
    jcfg, tcfg = configs(**{"waymo.train_context_length": 4, **BF16})
    jm, params, tm = models(jcfg, tcfg)
    d = stream_inputs(jcfg, B=3, A=8)
    want, got = jax_stream(jcfg, jm, params, d), torch_stream(tcfg, tm, d)
    for t, (ours, theirs) in enumerate(zip(got["steps"], want["steps"])):
        for name, a, b, tol in zip(("state pass", "rtg logits", "rtg pass", "action logits"), ours, theirs,
                                   (0.06, 0.03, 0.06, 0.03)):
            assert a.dtype == torch.bfloat16
            np.testing.assert_allclose(t2n(a.float()), np.asarray(b, np.float32), atol=tol, rtol=0,
                                       err_msg=f"{name} t={t}")
    tc, jc = got["cache"], want["cache"]
    for li in range(tcfg.model.num_decoder_layers):
        assert tc.k[li].dtype == torch.bfloat16
        for a, b in ((tc.k[li], jc.k[li]), (tc.v[li], jc.v[li])):
            np.testing.assert_allclose(t2n(a.float()), np.asarray(b, np.float32), atol=0.06, rtol=0)


def test_rollout_bf16_replay_matches_jax():
    """Under the JAX rollout's draws the port's bf16 rollout follows the same
    trajectories (1e-3, as the float32 replay in test_torch_rollout.py)."""
    jcfg, tcfg = configs(**BF16)
    sb = scenes(jcfg, num_scenes=4, num_agents=8)
    jm, params, tm = models(jcfg, tcfg)
    ro, out = replay_jax_rollout(jcfg, tcfg, sb, tm, params, jm)
    assert (ro.acceleration[tcfg.sim.history_steps:][:, sb.moving & sb.agent_valid] != 0).any()
    for name in ("position", "heading", "reward8", "nearest_dist", "existence", "rtgs", "acceleration", "steering"):
        np.testing.assert_allclose(t2n(getattr(out, name)), getattr(ro, name), atol=1e-3, rtol=0, err_msg=name)


def test_training_forward_bf16_matches_jax():
    """The training forward's three heads at bf16 compute, dropout off, on a
    batch of the JAX pipeline: within 0.05, a few bf16 steps of values up
    to about 2.5 after two decoder layers of bf16 rounding."""
    jcfg, tcfg = configs(**{"model.dropout": 0.0, "model.goal_dropout": 0.0, **BF16})
    jm, params, tm = models(jcfg, tcfg)
    js = jax_scenario(scenes(jcfg, 3))
    jb = jax.jit(lambda k, s: jax_build_batch(jcfg, k, s, jax_replay(jcfg, s)))(jax.random.PRNGKey(0), js)
    keys = ("agent_states", "agent_types", "goals", "actions", "rtgs", "timesteps", "moving_agent_mask",
            "road_points", "road_types")
    jb = {k: jnp.asarray(jb[k]) for k in keys}
    want = jax.jit(lambda p, b: jm.apply(p, b, deterministic=True))(params, jb)
    with torch.no_grad():
        got = tm({k: torch.tensor(np.asarray(v)) for k, v in jb.items()}, deterministic=True)
    for name in want._fields:
        a, b = t2n(getattr(got, name).float()), np.asarray(getattr(want, name), np.float32)
        np.testing.assert_allclose(a, b, atol=0.05, rtol=0, err_msg=name)
