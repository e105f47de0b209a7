"""The port's CTG++ modules held against the JAX package on the same
weights (the executed reference's, ``tests/goldens/reference_ctg.npz``,
through the JAX importer and ``from_flax_params``) and inputs, in f32 at
the toy config of ``torch_port_common.CTG_TOY``: the preset and config
sections, the DiT's modules and forward (with and without RTG
conditioning), the diffusion schedule (equal), the sampler under its noise
stream (unguided and guided), ``validation_mse`` and the guidance costs,
within 1e-5 absolute / 1e-4 relative. ``tests/test_torch_ctg_loss.py``
holds the losses, ``tests/test_torch_ctg_goldens.py`` the port against the
executed reference itself."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctrl_sim_tpu.config import preset as jax_preset
from ctrl_sim_tpu.models.ctg import dit as jdit
from ctrl_sim_tpu.models.ctg import guidance as jguide
from ctrl_sim_tpu.models.ctg.diffusion import DiffusionSchedule as JaxSchedule
from ctrl_sim_tpu_torch import config as tconfig
from ctrl_sim_tpu_torch.models.ctg import dit as tdit
from ctrl_sim_tpu_torch.models.ctg import guidance as tguide
from ctrl_sim_tpu_torch.models.ctg.diffusion import DiffusionSchedule
from torch_port_common import (
    ctg_configs,
    ctg_golden,
    ctg_golden_cond,
    ctg_models,
    jax_sample_noise,
    t2n,
)

torch.set_num_threads(2)
TOL = {"atol": 1e-5, "rtol": 1e-4}


def _T(d: dict) -> dict:
    return {k: torch.as_tensor(v) for k, v in d.items()}


def _J(d: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in d.items()}


@pytest.fixture(scope="module")
def golden():
    return ctg_golden()


@pytest.fixture(scope="module", params=[False, True], ids=["no-rtg", "rtg"])
def setup(request, golden):
    jcfg, tcfg = ctg_configs(**{"model.use_rtg": request.param})
    jm, params, tm = ctg_models(jcfg, tcfg, golden)
    return jcfg, tcfg, jm, params, tm


def _batch(golden, seed: int = 0) -> dict:
    """The golden's conditioning with ground-truth futures drawn from a seed
    (some agent-steps missing, one agent still)."""
    rng = np.random.default_rng(seed)
    B, N = golden["in_goals"].shape[:2]
    fut = rng.normal(size=(B, N, 3, 6)).astype(np.float32)
    fut[..., -1] = rng.random((B, N, 3)) > 0.2
    return {**ctg_golden_cond(golden), "agent_future_states": fut,
            "agent_future_actions": rng.uniform(-1, 1, size=(B, N, 3, 2)).astype(np.float32)}


def test_preset_and_sections_equal_jax():
    """The ctg_plus_plus preset equals the JAX package's in every section,
    and a JAX CTG++ config snapshot reads whole, its diffusion section
    included."""
    ours, ref = tconfig.preset("ctg_plus_plus"), jax_preset("ctg_plus_plus")
    assert ours.train.lr == 2e-4 and ours.train.accum_steps == 2 and ours.model.ctg_plus_plus
    for f in dataclasses.fields(ref):
        assert dataclasses.asdict(getattr(ours, f.name)) == dataclasses.asdict(getattr(ref, f.name)), f.name
    snap = dataclasses.replace(ref, diffusion=dataclasses.replace(ref.diffusion, future_len=7)).to_dict()
    assert tconfig.config_from_dict(snap).to_dict() == snap
    with pytest.raises(TypeError):
        tconfig.config_from_dict({"diffusion": {"no_such_field": 1}})


def test_embeddings_match_jax():
    """The diffusion-step sinusoid (denominator half - 1) and the 100-row
    positional table."""
    steps = np.array([0, 1, 7, 99], np.float32)
    np.testing.assert_allclose(t2n(tdit.sinusoidal_pos_emb(torch.as_tensor(steps), 32)),
                               np.asarray(jdit.sinusoidal_pos_emb(jnp.asarray(steps), 32)), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(t2n(tdit.positional_encoding_table(100, 32)),
                               np.asarray(jdit.positional_encoding_table(100, 32)), atol=1e-6, rtol=1e-6)


def _sub(params, *path):
    tree = params["params"]
    for p in path:
        tree = tree[p]
    return {"params": tree}


def test_single_input_embedding_and_social_layer_match_jax(setup, golden):
    """The edge embedding of the golden's relative encodings, and the
    social layer on it with one row and one time step that see no valid
    key (alpha 0, not NaN)."""
    jcfg, tcfg, _, params, tm = setup
    H, heads, ff = 32, 2, 64
    rel = golden["in_agent_past_rel_encodings"]
    dit = tm.diffusion.model
    want = jdit.SingleInputEmbedding(H, jnp.float32).apply(
        _sub(params, "diffusion", "model", "relative_encodings_encoder"), jnp.asarray(rel))
    with torch.no_grad():
        got = dit.relative_encodings_encoder(torch.as_tensor(rel))
    np.testing.assert_allclose(t2n(got), np.asarray(want), **TOL)

    rng = np.random.default_rng(1)
    B, N = 3, 4
    x = rng.normal(size=(B, N, H)).astype(np.float32)
    edge = rng.normal(size=(B, N, N, H)).astype(np.float32)
    valid = rng.random((B, N)) > 0.3
    valid[0] = False  # a time step with no agent
    valid[1, 2] = False
    layer = jdit.RelativeSocialAttention(heads, ff, 0.1, jnp.float32)
    want = jax.jit(lambda p, *a: layer.apply(p, *a, True))(
        _sub(params, "diffusion", "model", "trunk", "social_0"), x, edge, valid)
    with torch.no_grad():
        got = dit.trunk.social_0(torch.as_tensor(x), torch.as_tensor(edge), torch.as_tensor(valid))
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(t2n(got), np.asarray(want), **TOL)


def test_map_encoder_matches_jax(setup, golden):
    """The pooled road features and segment validity, with an empty
    segment and an agent with no road at all (both NaN guards), and 8
    pooling heads whatever model.num_heads is (here 2)."""
    jcfg, tcfg, _, params, tm = setup
    rp = golden["in_road_points"].copy()
    rp[0, 1, 2, :, -1] = 0.0  # a segment without a valid point
    rp[1, 3, :, :, -1] = 0.0  # an agent without a valid segment
    rt = golden["in_road_types"]
    enc = jdit.MapEncoderPtsMA(jcfg)
    wf, wv = jax.jit(lambda p, a, b: enc.apply(p, a, b, True))(_sub(params, "diffusion", "model", "map_encoder"), rp, rt)
    with torch.no_grad():
        gf, gv = tm.diffusion.model.map_encoder(torch.as_tensor(rp), torch.as_tensor(rt))
    assert tm.diffusion.model.map_encoder.road_pts_attn_layer.num_heads == 8
    np.testing.assert_array_equal(t2n(gv), np.asarray(wv))
    np.testing.assert_allclose(t2n(gf), np.asarray(wf), **TOL)


def test_dit_forward_matches_jax(setup, golden):
    """The denoiser on the golden's conditioning, with a fully missing
    agent (its last step unmasked) and an agent with no road."""
    jcfg, tcfg, jm, params, tm = setup
    cond = ctg_golden_cond(golden)
    cond["agent_past_states"] = cond["agent_past_states"].copy()
    cond["agent_past_states"][0, 2, :, -1] = 0.0
    cond["road_points"] = cond["road_points"].copy()
    cond["road_points"][1, 0, :, :, -1] = 0.0
    x, step = golden["in_future_k"], golden["in_diff_step"]
    want = jax.jit(lambda p, *a: jm.apply(p, *a, True, method=lambda m, *b: m.diffusion.model(*b)))(
        params, x, _J(cond), step)
    with torch.no_grad():
        got = tm.diffusion.model(torch.as_tensor(x), _T(cond), torch.as_tensor(step))
    np.testing.assert_allclose(t2n(got), np.asarray(want), **TOL)


def test_hoisted_context_equals_the_denoisers_own(setup, golden):
    """The map and edge encodings computed once (``DiT.encode_context``, as
    the sampler does for its denoiser calls) give the forward that encodes
    them itself, bit for bit."""
    tm = setup[-1]
    dit, cond = tm.diffusion.model, _T(ctg_golden_cond(golden))
    x, step = torch.as_tensor(golden["in_future_k"]), torch.as_tensor(golden["in_diff_step"])
    with torch.no_grad():
        hoisted = dit(x, cond, step, context=dit.encode_context(cond))
        assert torch.equal(hoisted, dit(x, cond, step))


def test_schedule_and_loss_weights_equal_jax():
    """The schedule constants are computed by the same numpy code, so equal."""
    for n in (20, 100):
        ours, ref = DiffusionSchedule.create(n), JaxSchedule.create(n)
        for name in JaxSchedule._fields:
            np.testing.assert_array_equal(t2n(getattr(ours, name)), np.asarray(getattr(ref, name)), err_msg=name)


def test_sample_and_validation_mse_match_jax(golden):
    """The strided sampler and ``validation_mse`` under the noise stream
    the JAX sampler draws from its key, and a guided sample (goal and
    collision guidance, 2 steps of scale 0.1) under the same stream."""
    jcfg, tcfg = ctg_configs()
    jm, params, tm = ctg_models(jcfg, tcfg, golden)
    batch = _batch(golden, seed=3)
    cond = ctg_golden_cond(golden)
    key = jax.random.PRNGKey(9)
    shape = batch["agent_future_states"].shape[:3] + (7,)
    noise = jax_sample_noise(key, shape, tcfg.model.n_eval_diffusion_step)
    anchor = np.random.default_rng(4).normal(size=(2, 4, 8)).astype(np.float32) * 3
    jfn = jguide.combine(jguide.goal_guide(1.0), jguide.collision_guide(jnp.asarray(anchor), 100.0, radius=4.0))
    tfn = tguide.combine(tguide.goal_guide(1.0), tguide.collision_guide(torch.as_tensor(anchor), 100.0, radius=4.0))

    @jax.jit
    def reference(p, b, k):
        def run(m, b, k):
            c = {name: b[name] for name in cond}
            return m.sample_from_cond(c, k), m.validation_mse(b, k), m.sample_from_cond(c, k, guidance_fn=jfn)
        return jm.apply(p, b, k, method=run)

    want, want_mse, guided = reference(params, _J(batch), key)
    with torch.no_grad():
        got = tm.sample_from_cond(_T(cond), noise_override=noise)
        got_mse = tm.validation_mse(_T(batch), noise_override=noise)
        got_guided = tm.sample_from_cond(_T(cond), guidance_fn=tfn, noise_override=noise)
    np.testing.assert_allclose(t2n(got), np.asarray(want), **TOL)
    for name in ("state_mse", "action_mse"):
        np.testing.assert_allclose(t2n(got_mse[name]), np.asarray(want_mse[name]), err_msg=name, **TOL)
    assert np.abs(np.asarray(guided) - np.asarray(want)).max() > 1e-2  # the guidance moved the samples
    np.testing.assert_allclose(t2n(got_guided), np.asarray(guided), **TOL)


def test_guidance_costs_and_gradients_match_jax():
    rng = np.random.default_rng(2)
    B, N, T = 2, 4, 5
    x = rng.normal(size=(B, N, T, 7)).astype(np.float32) * 0.05
    anchor = rng.normal(size=(B, N, 8)).astype(np.float32) * 3
    anchor[..., -1] = 1.0
    past = rng.normal(size=(B, N, 3, 8)).astype(np.float32)
    past[..., -1] = rng.random((B, N, 3)) > 0.3
    cond = {"agent_past_states": past, "goals": rng.normal(size=(B, N, 5)).astype(np.float32) * 0.05,
            "moving_agent_mask": (rng.random((B, N)) > 0.2).astype(np.float32)}
    np.testing.assert_allclose(
        t2n(tguide.local_to_global(torch.as_tensor(x[..., :2]), torch.as_tensor(anchor), 100.0)),
        np.asarray(jguide.local_to_global(jnp.asarray(x[..., :2]), jnp.asarray(anchor), 100.0)), **TOL)
    pairs = (
        (jguide.goal_guide(2.0), tguide.goal_guide(2.0)),
        (jguide.collision_guide(jnp.asarray(anchor), 100.0, radius=8.0),
         tguide.collision_guide(torch.as_tensor(anchor), 100.0, radius=8.0)),
    )
    pairs += ((jguide.combine(*(p[0] for p in pairs)), tguide.combine(*(p[1] for p in pairs))),)
    for jfn, tfn in pairs:
        jv, jg = jax.jit(jax.value_and_grad(jfn))(jnp.asarray(x), _J(cond))
        xt = torch.as_tensor(x).requires_grad_(True)
        tv = tfn(xt, _T(cond))
        (tg,) = torch.autograd.grad(tv, xt)
        np.testing.assert_allclose(t2n(tv), np.asarray(jv), **TOL)
        np.testing.assert_allclose(t2n(tg), np.asarray(jg), **TOL)
    # the moving mask is optional (all ones by default)
    del cond["moving_agent_mask"]
    np.testing.assert_allclose(t2n(tguide.goal_guide()(torch.as_tensor(x), _T(cond))),
                               np.asarray(jguide.goal_guide()(jnp.asarray(x), _J(cond))), **TOL)
