"""The port's ``utils/profiling.py`` held against the JAX package's:
``StepMeter``'s phases, counts and rates, ``trace_annotation`` as a
profiler span, and ``grad_global_norms``' keys and values on the same model
and batch (the JAX model's param paths, through ``params.flax_path``,
within 1e-5); ``data/native_loader.native_available``."""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctrl_sim_tpu.data.datagen import generate_offline_data as jax_replay
from ctrl_sim_tpu.data.pipeline import build_train_batch as jax_build_batch
from ctrl_sim_tpu.models.ctrl_sim import compute_loss as jax_compute_loss
from ctrl_sim_tpu.utils import profiling as jprof
from ctrl_sim_tpu_torch.data import native_loader
from ctrl_sim_tpu_torch.models.ctrl_sim import compute_loss
from ctrl_sim_tpu_torch.params import flax_path
from ctrl_sim_tpu_torch.utils import StepMeter, trace_annotation
from ctrl_sim_tpu_torch.utils.profiling import grad_global_norms
from torch_port_common import configs, jax_scenario, models, scenes

torch.set_num_threads(2)

MODEL_KEYS = ("agent_states", "agent_types", "goals", "actions", "rtgs", "timesteps",
              "moving_agent_mask", "road_points", "road_types")


def test_step_meter_phases_and_rates():
    ours, ref = StepMeter(), jprof.StepMeter()
    for meter in (ours, ref):
        for _ in range(3):
            with meter.phase("rollout", materialize={"x": [torch.ones(2)]} if meter is ours else None):
                time.sleep(0.01)
        with meter.phase("idle"):
            pass
    assert set(ours.summary()) == set(ref.summary()) == {"rollout", "idle"}
    assert ours.counts == ref.counts == {"rollout": 3, "idle": 1}
    assert ours.totals["rollout"] >= 0.03
    assert ours.rate("rollout", 90) == pytest.approx(3 * 90 / ours.totals["rollout"])
    assert ours.rate("never", 90) == ref.rate("never", 90) == 0.0
    assert set(ours.summary()["rollout"]) == set(ref.summary()["rollout"])


def test_trace_annotation_names_a_profiler_span():
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with trace_annotation("observe-step"):
            torch.ones(4).sum()
    assert "observe-step" in {e.key for e in prof.key_averages()}


def test_grad_global_norms_equal_jax():
    jcfg, tcfg = configs(**{"model.dropout": 0.0, "model.goal_dropout": 0.0})
    jm, params, tm = models(jcfg, tcfg)
    js = jax_scenario(scenes(jcfg, 2))
    jb = jax.jit(lambda k, s: jax_build_batch(jcfg, k, s, jax_replay(jcfg, s)))(jax.random.PRNGKey(0), js)
    jb = {k: jnp.asarray(jb[k]) for k in MODEL_KEYS}
    tb = {k: torch.tensor(np.asarray(v)) for k, v in jb.items()}

    grads = jax.jit(jax.grad(lambda p: jax_compute_loss(jcfg, jb, jm.apply(p, jb, deterministic=True)).total))(params)
    want = jprof.grad_global_norms(grads)
    tm.zero_grad()
    compute_loss(tcfg, tb, tm(tb, deterministic=True)).total.backward()
    got = grad_global_norms(tm)
    assert set(got) == set(want) and len(want) > 10
    for key in want:
        assert got[key] == pytest.approx(want[key], rel=1e-5, abs=1e-7), key

    # every parameter's path is a leaf of the JAX params, and the paths are distinct
    leaves = {tuple(k.key for k in path) for path, _ in jax.tree_util.tree_flatten_with_path(params)[0]}
    paths = [flax_path(tm, n) for n, _ in tm.named_parameters()]
    assert set(paths) == leaves and len(paths) == len(leaves)


def test_native_available_without_building():
    before = native_loader.library_path().exists()
    assert native_loader.native_available() == (before or native_loader.SOURCE.exists())
    assert native_loader.library_path().exists() == before
