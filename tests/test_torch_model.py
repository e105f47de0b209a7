"""The port's CtRL-Sim streaming interface held against ``model.apply`` of
the JAX model, with the weights carried over by ``from_flax_params``:
memory, cross-attention K/V, both decode passes and both heads over five
consecutive steps on one cache (the window is 4, so the ring wraps)."""

import jax
import numpy as np
import pytest
import torch

from ctrl_sim_tpu_torch.models.ctrl_sim import CtRLSim as TorchCtRLSim
from ctrl_sim_tpu_torch.params import from_flax_params, init_params
from torch_port_common import configs, jax_stream, models, stream_inputs, t2n, torch_stream

torch.set_num_threads(2)

RTOL, ATOL = 1e-4, 1e-4


@pytest.fixture(scope="module")
def setup():
    """Both models, the inputs, and the JAX side's outputs over
    STREAM_STEPS steps (computed once, jitted)."""
    jcfg, tcfg = configs(**{"waymo.train_context_length": 4})
    jm, params, tm = models(jcfg, tcfg)
    d = stream_inputs(jcfg, B=3, A=8)
    return jcfg, tcfg, params, tm, d, jax_stream(jcfg, jm, params, d)


def _check(got, want, what):
    np.testing.assert_allclose(t2n(got), np.asarray(want), rtol=RTOL, atol=ATOL, err_msg=what)


@pytest.mark.parametrize("premask", [False, True])
def test_streaming_interface_matches_jax(setup, premask):
    """``premask`` feeds the precomputed per-step masks of the rollout
    instead of the masks built from the ring labels."""
    jcfg, tcfg, _, tm, d, want = setup
    got = torch_stream(tcfg, tm, d, premask)
    (jmem, jvalid, jkv), (tmem, tvalid, tkv) = want["memory"], got["memory"]
    _check(tmem, jmem, "memory")
    np.testing.assert_array_equal(t2n(tvalid), np.asarray(jvalid))
    for (tk, tv), (jk, jv) in zip(tkv, jkv):
        _check(tk, jk, "memory K")
        _check(tv, jv, "memory V")
    for t, (ours, theirs) in enumerate(zip(got["steps"], want["steps"])):
        for name, a, b in zip(("state pass", "rtg logits", "rtg pass", "action logits"), ours, theirs):
            _check(a, b, f"{name} t={t}")
    tcache, jcache = got["cache"], want["cache"]
    np.testing.assert_array_equal(np.asarray(tcache.slot_t), np.asarray(jcache.slot_t))
    for li in range(jcfg.model.num_decoder_layers):
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
    """The DT, IL and trajeglish layouts, refused until they were ported,
    build: the port's parameters are the JAX model's param tree, name for
    name and shape for shape; so do CTG++'s, refused until it was ported."""
    from ctrl_sim_tpu.models.ctrl_sim import CtRLSim as JaxCtRLSim
    from torch_port_common import init_batch

    for over in ({"model.il": True}, {"model.decision_transformer": True}, {"model.trajeglish": True}):
        jcfg, tcfg = configs(**over)
        tree = jax.eval_shape(lambda: JaxCtRLSim(jcfg).init({"params": jax.random.PRNGKey(0)}, init_batch(jcfg)))
        want = from_flax_params(jax.tree.map(lambda x: np.zeros(x.shape, np.float32), tree))
        got = TorchCtRLSim(tcfg, device="cpu").state_dict()
        assert {k: tuple(v.shape) for k, v in got.items()} == {k: tuple(v.shape) for k, v in want.items()}, over
    # the CTG++ family, refused until it was ported, is a model of its own:
    # CTGPlusPlus's parameters are the JAX CTGPlusPlus param tree
    import jax.numpy as jnp

    from ctrl_sim_tpu.models.ctg_plus_plus import CTGPlusPlus as JaxCTG
    from ctrl_sim_tpu_torch.models.ctg_plus_plus import CTGPlusPlus
    from torch_port_common import ctg_configs, ctg_golden, ctg_golden_cond

    for use_rtg in (False, True):
        jcfg, tcfg = ctg_configs(**{"model.use_rtg": use_rtg})
        cond = {k: jnp.asarray(v) for k, v in ctg_golden_cond(ctg_golden()).items()}
        batch = {**cond, "agent_future_states": jnp.zeros((2, 4, 3, 6)), "agent_future_actions": jnp.zeros((2, 4, 3, 2))}
        tree = jax.eval_shape(lambda: JaxCTG(jcfg).init(
            {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)}, batch, jax.random.PRNGKey(2),
            method=JaxCTG.loss))
        want = from_flax_params(jax.tree.map(lambda x: np.zeros(x.shape, np.float32), tree))
        got = CTGPlusPlus(tcfg, device="cpu").state_dict()
        assert {k: tuple(v.shape) for k, v in got.items()} == {k: tuple(v.shape) for k, v in want.items()}, use_rtg
