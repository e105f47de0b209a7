"""The port's CTG++ training losses held against the JAX package on the
executed reference's weights (``torch_port_common.ctg_models``) at the toy
config: ``CTGPlusPlus.loss`` (the weighted L2 of the x0 prediction, the
first action's loss and, with the RTG head, its cross entropies) under
the JAX loss's own draws of diffusion steps and noise, within 1e-5
absolute / 1e-4 relative; and the denoiser's dropout paths (attention,
feedforward, social, map and goal dropout) in distribution, in the pattern of ``tests/test_sampling.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctrl_sim_tpu.models.ctg.rtg_model import rtg_model_loss as jax_rtg_loss
from ctrl_sim_tpu.models.ctg_plus_plus import CTGPlusPlus as JaxCTG
from ctrl_sim_tpu_torch.models.ctg.rtg_model import rtg_model_loss
from torch_port_common import ctg_configs, ctg_golden, ctg_golden_cond, ctg_models, jax_loss_draws, t2n

torch.set_num_threads(2)
TOL = {"atol": 1e-5, "rtol": 1e-4}


def _T(d: dict) -> dict:
    return {k: torch.as_tensor(v) for k, v in d.items()}


def _J(d: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in d.items()}


@pytest.fixture(scope="module")
def golden():
    return ctg_golden()


def _batch(golden, seed: int = 0) -> dict:
    """The golden's conditioning with ground-truth futures drawn from a seed
    (some agent-steps missing)."""
    rng = np.random.default_rng(seed)
    B, N = golden["in_goals"].shape[:2]
    fut = rng.normal(size=(B, N, 3, 6)).astype(np.float32)
    fut[..., -1] = rng.random((B, N, 3)) > 0.2
    return {**ctg_golden_cond(golden), "agent_future_states": fut,
            "agent_future_actions": rng.uniform(-1, 1, size=(B, N, 3, 2)).astype(np.float32)}


def test_loss_matches_jax_under_its_draws(golden):
    """``CTGPlusPlus.loss`` with the RTG head (dropout and goal dropout 0)
    under the diffusion steps and noise the JAX loss draws from its key,
    and the head's cross entropies on the RTG model's logits alone (the
    loss without the head: ``tests/test_torch_ctg_training.py``)."""
    jcfg, tcfg = ctg_configs(**{"model.use_rtg": True, "model.dropout": 0.0, "model.goal_dropout": 0.0})
    jm, params, tm = ctg_models(jcfg, tcfg, golden)
    batch = _batch(golden)
    key = jax.random.PRNGKey(5)

    @jax.jit
    def reference(p, b, k):
        def run(m, b, k):
            return m.loss(b, k), jax_rtg_loss(jcfg, b, m.rtg_model(b, True))
        return jm.apply(p, b, k, method=run, rngs={"dropout": k})

    want, want_rtg = reference(params, _J(batch), key)
    x_shape = batch["agent_future_states"].shape[:3] + (7,)
    tb = _T(batch)
    with torch.no_grad():
        got = tm.loss(tb, draws=jax_loss_draws(key, x_shape, tcfg.model.n_diffusion_steps))
        got_rtg = rtg_model_loss(tcfg, tb, tm.rtg_model(tb))
    assert got._fields == want._fields
    for name in want._fields:
        np.testing.assert_allclose(t2n(getattr(got, name)), np.asarray(getattr(want, name)), err_msg=name, **TOL)
    for a, b in zip(got_rtg, want_rtg):
        np.testing.assert_allclose(t2n(a), np.asarray(b), **TOL)


def _same_mean(a: np.ndarray, b: np.ndarray) -> bool:
    """Two samples' means within 5 standard errors of their difference."""
    se = np.sqrt(a.var() / a.size + b.var() / b.size)
    return abs(a.mean() - b.mean()) <= 5 * se + 1e-9


def test_dropout_paths_in_distribution(golden):
    """With dropout 0.1 and goal dropout 0.5 (the denoiser's attention,
    feedforward, social, map and goal dropout; the RTG head runs the same
    modules), under one fixed draw of diffusion steps and noise: the losses
    over many dropout draws of the port and of the JAX package agree in
    mean and in spread."""
    jcfg, tcfg = ctg_configs(**{"model.goal_dropout": 0.5})
    jm, params, tm = ctg_models(jcfg, tcfg, golden)
    batch = _batch(golden, seed=5)
    key = jax.random.PRNGKey(11)
    x_shape = batch["agent_future_states"].shape[:3] + (7,)
    draws = jax_loss_draws(key, x_shape, tcfg.model.n_diffusion_steps)
    n = 100
    fn = jax.jit(lambda p, b, k: jm.apply(p, b, key, method=JaxCTG.loss, rngs={"dropout": k}).total)
    jb = _J(batch)
    want = np.array([float(fn(params, jb, k)) for k in jax.random.split(jax.random.PRNGKey(12), n)])
    gen = torch.Generator().manual_seed(13)
    tb = _T(batch)
    with torch.no_grad():
        got = np.array([float(tm.loss(tb, gen, draws).total) for _ in range(n)])
    assert want.std() > 1e-3
    assert _same_mean(got, want), (got.mean(), want.mean())
    assert 0.7 < got.std() / want.std() < 1.4, (got.std(), want.std())
