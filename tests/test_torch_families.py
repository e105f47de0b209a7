"""The DT, IL and trajeglish families and the default family's sequential
3-pass decode, held against the JAX package on the same numpy params
(``from_flax_params``) and inputs, in f32 at the toy config of
``torch_port_common``:

- the training forward and ``compute_loss`` of each family within 1e-4;
- the mask of every decode pass of every step of ``run_streaming`` (built
  by ``Decoder._mask`` from the ring's slot labels) equal to the JAX
  rollout's bit for bit, across the ring's wrap;
- ``decode_step``, ``stream_state``, ``stream_prev_action``,
  ``stream_rtg`` and ``stream_action`` on one cache within 1e-4.

``tests/test_torch_families_rollout.py`` holds their rollouts.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctrl_sim_tpu.models import layers as jlayers
from ctrl_sim_tpu.models.ctrl_sim import compute_loss as jax_compute_loss
from ctrl_sim_tpu.models.decoder import KVCache as JaxKVCache
from ctrl_sim_tpu.rollout.streaming import run_streaming as jax_run_streaming
from ctrl_sim_tpu_torch.models.ctrl_sim import compute_loss
from ctrl_sim_tpu_torch.rollout.setup import recorded_masks
from torch_port_common import family_configs, jax_scenario, models, scenes, stream_inputs, t2n, torch_scenario

torch.set_num_threads(2)

FAMILIES = ["dt", "il", "trajeglish"]
MASK_CASES = {  # name: (preset, overrides); the default family's decode here is the 3-pass one
    "dt": ("dt", {}),
    "il": ("il", {}),
    "trajeglish": ("trajeglish", {}),
    "3-pass": ("ctrl_sim", {"eval.streaming_passes": 3}),
}
ATOL = 1e-4


def _batch(cfg, B: int = 2, seed: int = 0) -> dict:
    """A random training batch in numpy: some agents absent at some steps,
    RTG bins as the CtRL-Sim batch holds them (DT reads them as floats)."""
    wc = cfg.waymo
    A, T = wc.max_num_agents, wc.train_context_length
    P, L = wc.max_num_road_polylines, wc.max_num_road_pts_per_polyline
    rng = np.random.default_rng(seed)
    states = rng.normal(size=(B, A, T, 8)).astype(np.float32)
    states[..., -1] = rng.random((B, A, T)) > 0.2
    road = rng.normal(size=(B, P, L, 3)).astype(np.float32) * 10
    road[..., 2] = rng.random((B, P, L)) > 0.3
    return {
        "agent_states": states,
        "agent_types": np.eye(5, dtype=np.float32)[rng.integers(0, 5, size=(B, A))],
        "goals": rng.normal(size=(B, A, 5)).astype(np.float32),
        "actions": rng.integers(0, wc.action_dim, size=(B, A, T)).astype(np.float32),
        "rtgs": rng.integers(0, wc.rtg_discretization, size=(B, A, T, 3)).astype(np.float32),
        "timesteps": np.broadcast_to(np.arange(T), (B, T)).astype(np.int32),
        "moving_agent_mask": (rng.random((B, A)) > 0.3).astype(np.float32),
        "road_points": road,
        "road_types": np.eye(8, dtype=np.float32)[rng.integers(0, 8, size=(B, P))],
    }


@pytest.mark.parametrize("family", FAMILIES)
def test_forward_and_loss_match_jax(family):
    jcfg, tcfg = family_configs(family, **{"model.dropout": 0.0, "model.goal_dropout": 0.0})
    jm, params, tm = models(jcfg, tcfg)
    b = _batch(jcfg)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    tb = {k: torch.as_tensor(v) for k, v in b.items()}
    want = jax.jit(lambda p, x: jm.apply(p, x, deterministic=True))(params, jb)
    want_loss = jax_compute_loss(jcfg, jb, want)
    with torch.no_grad():
        got = tm(tb, deterministic=True)
        got_loss = compute_loss(tcfg, tb, got)
    assert got.rtg_preds is None and got.state_preds is None and want.rtg_preds is None
    np.testing.assert_allclose(t2n(got.action_preds), np.asarray(want.action_preds), atol=ATOL, rtol=ATOL)
    for name in want_loss._fields:
        np.testing.assert_allclose(float(getattr(got_loss, name)), float(getattr(want_loss, name)),
                                   atol=ATOL, rtol=ATOL, err_msg=name)
    assert float(got_loss.total) > 0


def test_decode_masks_bit_equal_jax(monkeypatch):
    """The mask of every decode pass of every step of ``run_streaming``, as
    the JAX rollout and the port's give it to their decoder layer, equal
    bit for bit, for each family and the 3-pass decode: 16 steps over a
    window of 8, so steps 0, 1, window - 1 and window + 3 are among them
    and the ring wraps twice. The port's masks are recorded by
    ``rollout/setup.py:recorded_masks``, the JAX rollout's by a host
    callback in a stand-in for its layer that passes the tokens and the
    cache through."""
    seen = []

    def jax_layer(self, x, memory, k_buf, v_buf, writes, mask, *args, k_scale_buf=None, v_scale_buf=None, **kw):
        jax.debug.callback(lambda m: seen.append(np.asarray(m)[0]), mask, ordered=True)
        return x, k_buf, v_buf, k_scale_buf, v_scale_buf

    monkeypatch.setattr(jlayers.TransformerDecoderLayer, "decode_step", jax_layer)
    for case, (family, over) in MASK_CASES.items():
        jcfg, tcfg = family_configs(family, **over, **{"model.num_decoder_layers": 1})
        sb = scenes(jcfg, num_scenes=2, num_agents=8)
        controlled = sb.moving & sb.agent_valid
        jm, params, tm = models(jcfg, tcfg)
        seen.clear()
        jax.jit(lambda s, p, c, r: jax_run_streaming(jcfg, jm, p, s, c, r))(
            jax_scenario(sb), params, jnp.asarray(controlled), jax.random.PRNGKey(0))
        jax.effects_barrier()
        got = recorded_masks(tcfg, tm, torch_scenario(sb), torch.as_tensor(controlled))
        window, steps = tcfg.waymo.train_context_length, tcfg.sim.steps
        passes = 3 if case == "3-pass" else 1
        assert window + 3 < steps
        assert len(got) == steps and len(seen) == steps * passes, case
        for t, masks in enumerate(got):
            assert len(masks) == passes, case
            for p, mask in enumerate(masks):
                want = seen[t * passes + p]
                assert mask.shape == want.shape, case
                np.testing.assert_array_equal(t2n(mask) != 0, want, err_msg=f"{case} t={t} pass {p}")


@pytest.mark.parametrize("family", ["ctrl_sim", "dt"])
def test_single_decode_steps_match_jax(family):
    """On one cache: per step, ``stream_prev_action``, ``stream_state`` and
    ``stream_rtg`` (the 3-pass order; DT's returns continuous), then
    ``stream_action`` and a bare ``decode_step`` of the last step; each
    output and the cache within 1e-4. The window is 4, so the ring wraps."""
    jcfg, tcfg = family_configs(family, **{"waymo.train_context_length": 4})
    jm, params, tm = models(jcfg, tcfg)
    mc, window = jcfg.model, jcfg.waymo.train_context_length
    d = stream_inputs(jcfg, B=3, A=8)
    steps, (B, A) = len(d["states"]), d["goals"].shape[:2]
    rtgs = d["rtgs"] / jcfg.waymo.rtg_discretization if mc.decision_transformer else d["rtgs"]
    jd = {k: jnp.asarray(v) for k, v in d.items()}

    @jax.jit
    def jax_memory(p):
        mem, valid = jm.apply(p, method=lambda m: m.encode_rollout_memory(
            jd["road_points"], jd["road_types"], jd["states"][0], jd["goals"], jd["exist"][0],
            jnp.asarray(0, jnp.int32)))
        return mem, valid, jm.apply(p, method=lambda m: m.precompute_memory_kv(mem))

    @jax.jit
    def jax_step(p, pa, pe, s, e, r, t, cache, mem, valid, kv):
        def body(m):
            _, c = m.stream_prev_action(pa, pe, t, cache, mem, valid, window, memory_kv=kv)
            x, c = m.stream_state(s, jd["goals"], e, t, c, mem, valid, window, memory_kv=kv)
            y, c = m.stream_rtg(r, e, t, c, mem, valid, window, memory_kv=kv)
            return x, y, c
        return jm.apply(p, method=body)

    @jax.jit
    def jax_last(p, a, e, x, t, cache, mem, valid, kv):
        def body(m):
            z, c = m.stream_action(a, e, t, cache, mem, valid, window, memory_kv=kv)
            w, c = m.decoder.decode_step(x, 0, t, c, mem, valid, window, memory_kv=kv)
            return z, w, c
        return jm.apply(p, method=body)

    mem, valid, kv = jax_memory(params)
    cache = JaxKVCache.create(mc.num_decoder_layers, B, window, A, mc.num_token_types, mc.hidden_dim, jnp.float32)
    T = torch.as_tensor
    with torch.no_grad():
        tmem, tvalid = tm.encode_rollout_memory(T(d["road_points"]), T(d["road_types"]), T(d["states"][0]),
                                                T(d["goals"]), T(d["exist"][0]), 0)
        tkv = tm.precompute_memory_kv(tmem)
        tcache = tm.new_cache(B, A)
        pa, pe = np.zeros((B, A), np.int64), np.zeros((B, A), np.float32)
        for t in range(steps):
            x, y, cache = jax_step(params, jnp.asarray(pa), jnp.asarray(pe), jd["states"][t], jd["exist"][t],
                                   jnp.asarray(rtgs[t]), jnp.asarray(t, jnp.int32), cache, mem, valid, kv)
            _, tcache = tm.stream_prev_action(T(pa), T(pe), t, tcache, tvalid, tkv)
            tx, tcache = tm.stream_state(T(d["states"][t]), T(d["goals"]), T(d["exist"][t]), t, tcache, tvalid, tkv)
            ty, tcache = tm.stream_rtg(T(rtgs[t]), T(d["exist"][t]), t, tcache, tvalid, tkv)
            for name, a, b in (("stream_state", tx, x), ("stream_rtg", ty, y)):
                np.testing.assert_allclose(t2n(a), np.asarray(b), atol=ATOL, rtol=ATOL, err_msg=f"{name} t={t}")
            pa, pe = d["actions"][t], d["exist"][t]
        last = steps - 1
        z, w, cache = jax_last(params, jnp.asarray(pa), jnp.asarray(pe), x, jnp.asarray(last, jnp.int32),
                               cache, mem, valid, kv)
        tz, tcache = tm.stream_action(T(pa), T(pe), last, tcache, tvalid, tkv)
        tw, tcache = tm.decoder.decode_step(tx, 0, last, tcache, tvalid, window, tkv)
    np.testing.assert_allclose(t2n(tz), np.asarray(z), atol=ATOL, rtol=ATOL, err_msg="stream_action")
    np.testing.assert_allclose(t2n(tw), np.asarray(w), atol=ATOL, rtol=ATOL, err_msg="decode_step")
    np.testing.assert_array_equal(np.asarray(tcache.slot_t), np.asarray(cache.slot_t))
    for li in range(mc.num_decoder_layers):
        np.testing.assert_allclose(t2n(tcache.k[li]), np.asarray(cache.k[li]), atol=ATOL, rtol=ATOL)
        np.testing.assert_allclose(t2n(tcache.v[li]), np.asarray(cache.v[li]), atol=ATOL, rtol=ATOL)


def test_train_step_matches_jax_and_decays_unused_params():
    """One AdamW update of IL, whose layout leaves the RTG embeddings
    unused: every parameter within 1e-4 of the JAX trainer's (lr 5e-5 past
    the warmup, so a sign flip of a near-zero gradient moves a weight by at
    most about 1e-4), and the unused ones exactly as optax moves them: the
    embeddings not at all, the decayed ``embed_rtg`` weight by lr x decay."""
    from ctrl_sim_tpu.training import trainer as jtrainer
    from ctrl_sim_tpu_torch.params import from_flax_params
    from ctrl_sim_tpu_torch.training import Trainer

    over = {"model.dropout": 0.0, "model.goal_dropout": 0.0, "train.lr": 5e-5, "train.warmup_steps": 0,
            "train.max_steps": 10, "train.weight_decay": 0.5}
    jcfg, tcfg = family_configs("il", **over)
    jm, params, tm = models(jcfg, tcfg)
    b = _batch(jcfg, B=2, seed=3)
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    jstate = jtrainer.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                                 opt_state=jtrainer.make_optimizer(jcfg, params).init(params))
    jstate, _ = jtrainer.Trainer(jcfg).make_train_step()(
        jstate, {k: jnp.asarray(v) for k, v in b.items()}, jax.random.PRNGKey(0))
    want = from_flax_params(jax.tree.map(np.asarray, jstate.params))
    trainer = Trainer(tcfg, device="cpu")
    state, _ = trainer.make_train_step()(trainer.state_from_model(tm), {k: torch.as_tensor(v) for k, v in b.items()},
                                          torch.Generator().manual_seed(0))
    got = state.model.state_dict()
    for name, value in want.items():
        np.testing.assert_allclose(t2n(got[name]), t2n(value), atol=1e-4, rtol=0, err_msg=name)
    unused = [n for n in got if n.startswith("encoder.embed_rtg")]
    assert len(unused) == 5  # three embeddings, the Dense weight and bias
    for name in unused:
        np.testing.assert_allclose(t2n(got[name]), t2n(want[name]), atol=0, rtol=1e-6, err_msg=name)
    assert torch.equal(got["encoder.embed_rtg_goal.weight"], before["encoder.embed_rtg_goal.weight"])
    assert not torch.equal(got["encoder.embed_rtg.weight"], before["encoder.embed_rtg.weight"])
