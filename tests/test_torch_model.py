"""The port's CtRL-Sim streaming interface held against ``model.apply`` of
the JAX model, with the weights carried over by ``from_flax_params``:
memory, cross-attention K/V, both decode passes and both heads over five
consecutive steps on one cache (the window is 4, so the ring wraps)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctrl_sim_tpu.models.decoder import KVCache as JaxKVCache
from ctrl_sim_tpu_torch.models.ctrl_sim import CtRLSim as TorchCtRLSim
from ctrl_sim_tpu_torch.ops.masks import stream_step_masks
from ctrl_sim_tpu_torch.params import from_flax_params, init_params
from torch_port_common import configs, models, t2n

torch.set_num_threads(2)

STEPS = 5
RTOL, ATOL = 1e-4, 1e-4


def _inputs(cfg, B, A, seed=0):
    wc = cfg.waymo
    rng = np.random.default_rng(seed)
    P, L = wc.max_num_road_polylines, wc.max_num_road_pts_per_polyline
    road = rng.normal(size=(B, P, L, 3)).astype(np.float32) * 20
    road[..., 2] = rng.random((B, P, L)) > 0.2
    road[:, -2:] = 0.0  # empty polylines
    types12 = np.eye(5)[rng.integers(0, 5, size=(B, A))].astype(np.float32)
    states = rng.normal(size=(STEPS, B, A, 12)).astype(np.float32)
    states[..., 7:] = types12
    exist = (rng.random((STEPS, B, A)) > 0.15).astype(np.float32)
    return {
        "road_points": road,
        "road_types": np.eye(8)[rng.integers(0, 8, size=(B, P))].astype(np.float32),
        "states": states,
        "goals": rng.normal(size=(B, A, 5)).astype(np.float32),
        "exist": exist,
        "actions": rng.integers(0, wc.action_dim, size=(STEPS, B, A)),
        "rtgs": rng.integers(0, wc.rtg_discretization, size=(STEPS, B, A, 3)),
    }


@pytest.fixture(scope="module")
def setup():
    """Both models, the inputs, and the JAX side's outputs over STEPS steps
    (computed once, jitted)."""
    jcfg, tcfg = configs(**{"waymo.train_context_length": 4})
    jm, params, tm = models(jcfg, tcfg)
    mc, wc = jcfg.model, jcfg.waymo
    B, A, window = 3, 8, wc.train_context_length
    d = _inputs(jcfg, B, A)
    jd = {k: jnp.asarray(v) for k, v in d.items()}

    @jax.jit
    def memory(p, rp, rt, s0, g, e0):
        mem, valid = jm.apply(p, method=lambda m: m.encode_rollout_memory(
            rp, rt, s0, g, e0, jnp.asarray(0, jnp.int32)))
        return mem, valid, jm.apply(p, method=lambda m: m.precompute_memory_kv(mem))

    @jax.jit
    def step(p, pa, pe, s, g, e, r, t, cache, mem, valid, kv):
        def body(m):
            x, c = m.stream_action_state(pa, pe, s, g, e, t, cache, mem, valid, window, memory_kv=kv)
            y, c = m.stream_rtg(r, e, t, c, mem, valid, window, memory_kv=kv)
            return x, m.rtg_head(x), y, m.action_head(y), c
        return jm.apply(p, method=body)

    mem, valid, kv = memory(params, jd["road_points"], jd["road_types"], jd["states"][0], jd["goals"], jd["exist"][0])
    cache = JaxKVCache.create(mc.num_decoder_layers, B, window, A, mc.num_token_types, mc.hidden_dim, jnp.float32)
    prev_a, prev_e = jnp.zeros((B, A), jnp.int32), jnp.zeros((B, A))
    per_step = []
    for t in range(STEPS):
        *outs, cache = step(params, prev_a, prev_e, jd["states"][t], jd["goals"], jd["exist"][t],
                            jd["rtgs"][t], jnp.asarray(t, jnp.int32), cache, mem, valid, kv)
        per_step.append(outs)
        prev_a, prev_e = jd["actions"][t], jd["exist"][t]
    want = {"memory": (mem, valid, kv), "steps": per_step, "cache": cache}
    return jcfg, tcfg, params, tm, d, want


def _check(got, want, what):
    np.testing.assert_allclose(t2n(got), np.asarray(want), rtol=RTOL, atol=ATOL, err_msg=what)


@pytest.mark.parametrize("premask", [False, True])
def test_streaming_interface_matches_jax(setup, premask):
    """``premask`` feeds the precomputed per-step masks of the rollout
    instead of the masks built from the ring labels."""
    jcfg, _, _, tm, d, want = setup
    mc = jcfg.model
    B, A = d["goals"].shape[:2]
    window = jcfg.waymo.train_context_length
    T = torch.as_tensor

    jmem, jvalid, jkv = want["memory"]
    tmem, tvalid = tm.encode_rollout_memory(
        T(d["road_points"]), T(d["road_types"]), T(d["states"][0]), T(d["goals"]), T(d["exist"][0]), 0)
    _check(tmem, jmem, "memory")
    np.testing.assert_array_equal(t2n(tvalid), np.asarray(jvalid))
    tkv = tm.precompute_memory_kv(tmem)
    for (tk, tv), (jk, jv) in zip(tkv, jkv):
        _check(tk, jk, "memory K")
        _check(tv, jv, "memory V")

    tcache = tm.new_cache(B, A)
    m1, m2 = stream_step_masks(STEPS, window, A, mc.num_token_types, 0, device="cpu")
    prev_a = torch.zeros((B, A), dtype=torch.long)
    prev_e = torch.zeros((B, A))
    for t, (jx, jrtg, jy, jact) in enumerate(want["steps"]):
        tx, tcache = tm.stream_action_state(
            prev_a, prev_e, T(d["states"][t]), T(d["goals"]), T(d["exist"][t]), t, tcache,
            tvalid, tkv, mask_override=m1[t] if premask else None)
        _check(tx, jx, f"state pass t={t}")
        _check(tm.rtg_head(tx), jrtg, f"rtg logits t={t}")
        ty, tcache = tm.stream_rtg(
            T(d["rtgs"][t]), T(d["exist"][t]), t, tcache, tvalid, tkv,
            mask_override=m2[t] if premask else None)
        _check(ty, jy, f"rtg pass t={t}")
        _check(tm.action_head(ty), jact, f"action logits t={t}")
        prev_a, prev_e = T(d["actions"][t]), T(d["exist"][t])
    jcache = want["cache"]
    np.testing.assert_array_equal(np.asarray(tcache.slot_t), np.asarray(jcache.slot_t))
    for li in range(mc.num_decoder_layers):
        _check(tcache.k[li], jcache.k[li], f"cache K layer {li}")
        _check(tcache.v[li], jcache.v[li], f"cache V layer {li}")


def test_params_map_every_leaf_and_init_is_seeded(setup):
    _, tcfg, params, tm, *_ = setup
    sd = from_flax_params(jax.tree.map(np.asarray, params))
    assert set(sd) == set(tm.state_dict())
    k = params["params"]["decoder"]["decoder_layer_0"]["linear1"]["kernel"]
    np.testing.assert_array_equal(t2n(tm.decoder.layers[0].linear1.weight), np.asarray(k).T)
    a, b = TorchCtRLSim(tcfg, device="cpu"), TorchCtRLSim(tcfg, device="cpu")
    init_params(a, torch.Generator().manual_seed(3))
    init_params(b, torch.Generator().manual_seed(3))
    for (n, x), y in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(x, y), n
    w = a.decoder.layers[0].linear1.weight
    bound = (6.0 / sum(w.shape)) ** 0.5
    assert w.abs().max() <= bound and w.std() > bound / 3


def test_model_refuses_unported_options():
    for over in ({"model.il": True}, {"model.decision_transformer": True}, {"model.trajeglish": True}):
        with pytest.raises(NotImplementedError):
            TorchCtRLSim(configs(**over)[1], device="cpu")
    m = TorchCtRLSim(configs(**{"model.kv_cache_dtype": "int8"})[1], device="cpu")
    with pytest.raises(NotImplementedError):
        m.new_cache(1, 8)
