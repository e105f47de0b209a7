"""The trained checkpoints converted for the port
(``artifacts/torch/{r05_s0,r05_s1,ckpt_c}``, written by
``tools/convert_checkpoints_to_torch.py``) held against the orbax
checkpoints they come from, restored here with the JAX package: every
weight and both AdamW moments equal tensor for tensor, the step equal to
optax's count, the config the JAX one. Then, on r05_s0 (f32, hidden 64,
4 heads of d = 16, 8 agents): the port's training forward against the JAX
forward on the artifacts' held-out scenes (every head within 1e-4), one
``run_streaming`` chunk against the JAX rollout under its replayed draws
(the logits drawn from within 1e-4 at every step, trajectories within
1e-3), and one AdamW update after the restore against optax's (params and
moments within 1e-6)."""

import dataclasses
import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctrl_sim_tpu.data import stack_scenarios as jax_stack, synthetic_scenario as jax_synth
from ctrl_sim_tpu.data.datagen import generate_offline_data as jax_replay
from ctrl_sim_tpu.data.pipeline import build_train_batch as jax_build_batch
from ctrl_sim_tpu.models.ctrl_sim import CtRLSim as JaxCtRLSim
from ctrl_sim_tpu.training import trainer as jtrainer
from ctrl_sim_tpu_torch.config import config_from_dict
from ctrl_sim_tpu_torch.models.ctrl_sim import CtRLSim
from ctrl_sim_tpu_torch.params import from_flax_params
from ctrl_sim_tpu_torch.training import Trainer
from ctrl_sim_tpu_torch.training.checkpoint import CheckpointManager
from ctrl_sim_tpu_torch.training.trainer import clip_by_global_norm, lr_schedule
from torch_port_common import jax_scenario, patch_jax_contact_tie_rule, replay_jax_rollout, t2n

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL_KEYS = ("agent_states", "agent_types", "goals", "actions", "rtgs", "timesteps",
              "moving_agent_mask", "road_points", "road_types")


def _tool():
    spec = importlib.util.spec_from_file_location(
        "convert_checkpoints_to_torch", os.path.join(REPO, "tools", "convert_checkpoints_to_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


TOOL = _tool()


@pytest.fixture(scope="module")
def restored():
    """name -> (JAX config, restored JAX state, the port's config, the committed .pt)."""
    out = {}
    for name, (directory, step) in TOOL.CHECKPOINTS.items():
        jcfg, state = TOOL.restore_jax(directory, step)
        torch_dir = os.path.join(TOOL.OUT, name)
        with open(os.path.join(torch_dir, "config.json")) as f:
            tcfg = config_from_dict(json.load(f))
        saved = torch.load(os.path.join(torch_dir, f"step_{step}.pt"), weights_only=True)
        out[name] = (jcfg, state, tcfg, saved)
    return out


@pytest.mark.parametrize("name", ["r05_s0", "r05_s1", "ckpt_c"])
def test_committed_checkpoint_equals_orbax(restored, name):
    jcfg, state, tcfg, saved = restored[name]
    assert saved["step"] == int(state.step) == TOOL.CHECKPOINTS[name][1]
    for section in ("sim", "waymo", "model", "train", "policy", "eval"):
        assert dataclasses.asdict(getattr(tcfg, section)) == dataclasses.asdict(getattr(jcfg, section)), section
    assert (tcfg.model.compute_dtype, tcfg.model.kv_cache_dtype, tcfg.model.hidden_dim,
            tcfg.model.dim_feedforward, tcfg.model.num_heads) == ("float32", "bfloat16", 64, 128, 4)
    assert tcfg.sim.max_agents == (16 if name == "ckpt_c" else 8) and tcfg.sim.steps == 40
    weights = from_flax_params(state.params)
    assert saved["model"].keys() == weights.keys()
    for key, value in weights.items():
        assert torch.equal(saved["model"][key], value), key
    adam = TOOL.adam_state(state.opt_state)
    mu, nu = from_flax_params(adam.mu), from_flax_params(adam.nu)
    # the optimizer state is keyed by the parameter's index in the port's groups
    model = CtRLSim(tcfg, device="cpu")
    opt = Trainer(tcfg, device="cpu").state_from_model(model).optimizer
    names = {id(p): n for n, p in model.named_parameters()}
    order = [names[id(p)] for g in opt.param_groups for p in g["params"]]
    assert sorted(order) == sorted(weights)
    for index, pname in enumerate(order):
        entry = saved["optimizer"]["state"][index]
        assert entry["step"].item() == int(adam.count) == saved["step"]
        assert torch.equal(entry["exp_avg"], mu[pname]), pname
        assert torch.equal(entry["exp_avg_sq"], nu[pname]), pname
    groups = saved["optimizer"]["param_groups"]
    assert [g["weight_decay"] for g in groups] == [tcfg.train.weight_decay, 0.0]


def _held_out_scenes(cfg, n=4, conflict=1):
    """The artifacts' scene recipe (tools/make_r05_artifacts.py): held-out
    seeds from 1000, 8 agents, one crossing pair a scene."""
    return jax_stack([jax_synth(cfg, seed=1000 + s, num_agents=8, conflict_pairs=conflict) for s in range(n)], cfg)


def _r05_models(restored):
    jcfg, state, tcfg, saved = restored["r05_s0"]
    tm = CtRLSim(tcfg, device="cpu")
    tm.load_state_dict(saved["model"], strict=True)
    tm.eval()
    return jcfg, state, tcfg, JaxCtRLSim(jcfg), tm


def test_r05_forward_matches_jax(restored):
    jcfg, state, tcfg, jm, tm = _r05_models(restored)
    js = jax_scenario(_held_out_scenes(jcfg))
    jb = jax.jit(lambda k, s: jax_build_batch(jcfg, k, s, jax_replay(jcfg, s)))(jax.random.PRNGKey(0), js)
    jb = {k: jnp.asarray(jb[k]) for k in MODEL_KEYS}
    want = jax.jit(lambda p, b: jm.apply(p, b, deterministic=True))(state.params, jb)
    with torch.no_grad():
        got = tm({k: torch.tensor(np.asarray(v)) for k, v in jb.items()})
    for head in ("action_preds", "rtg_preds", "state_preds"):
        np.testing.assert_allclose(t2n(getattr(got, head)), np.asarray(getattr(want, head)), atol=1e-4, rtol=0,
                                   err_msg=head)


def test_r05_streaming_rollout_matches_jax(restored, monkeypatch):
    """r05 trains and rolls out with contacts on, and the held-out scenes
    collide: the JAX contact geometry gets the port's tie rule for tied
    incident-edge corners, as in the contact tests (a stated difference)."""
    patch_jax_contact_tie_rule(monkeypatch)
    jcfg, state, tcfg, jm, tm = _r05_models(restored)
    jcfg, tcfg = (dataclasses.replace(c, eval=dataclasses.replace(c.eval, rollout_mode="streaming"))
                  for c in (jcfg, tcfg))
    sb = _held_out_scenes(jcfg)
    logits = {}
    ro, out = replay_jax_rollout(jcfg, tcfg, sb, tm, state.params, jm, logits=logits)
    assert len(logits["actions"]) == len(logits["jax_actions"]) == tcfg.sim.steps
    assert len(logits["rtgs"]) == len(logits["jax_rtgs"]) == tcfg.sim.steps
    for name in ("actions", "rtgs"):
        for t, (got, want) in enumerate(zip(logits[name], logits[f"jax_{name}"])):
            np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4, err_msg=f"{name} logits t={t}")
    assert (ro.acceleration[tcfg.sim.history_steps:][:, sb.moving & sb.agent_valid] != 0).any()
    for name in ("position", "heading", "reward8", "nearest_dist", "existence", "rtgs", "acceleration", "steering"):
        np.testing.assert_allclose(t2n(getattr(out, name)), getattr(ro, name), atol=1e-3, rtol=0, err_msg=name)


def test_adamw_update_after_restore_matches_optax(restored, tmp_path):
    """One update from the restored moments and step with the same
    gradients on both sides. ``train.max_steps`` is raised past the
    checkpoint's step so the schedule's lr is not 0 there."""
    jcfg, state, tcfg, saved = restored["r05_s0"]
    jcfg, tcfg = (dataclasses.replace(c, train=dataclasses.replace(c.train, max_steps=52000)) for c in (jcfg, tcfg))
    rng = np.random.default_rng(0)
    grads = jax.tree.map(lambda p: (rng.normal(size=p.shape) * 0.05).astype(np.float32), state.params)
    tx = jtrainer.make_optimizer(jcfg, state.params)
    updates, new_opt = tx.update(jax.tree.map(jnp.asarray, grads), state.opt_state, state.params)
    want_params = from_flax_params(jax.tree.map(np.asarray, jax.tree.map(jnp.add, state.params, updates)))
    adam = TOOL.adam_state(jax.tree.map(np.asarray, new_opt))
    want_mu, want_nu = from_flax_params(adam.mu), from_flax_params(adam.nu)

    directory = os.path.join(TOOL.OUT, "r05_s0")
    trainer = Trainer(tcfg, device="cpu")
    tstate = trainer.state_from_model(CtRLSim(tcfg, device="cpu"))
    tstate = CheckpointManager(tcfg, directory).restore(tstate)
    assert tstate.step == 26000 and lr_schedule(tcfg)(tstate.step) > 0
    tgrads = from_flax_params(grads)
    params = dict(tstate.model.named_parameters())
    for name, p in params.items():
        p.grad = tgrads[name].clone()
    clip_by_global_norm([p.grad for p in params.values()], tcfg.train.gradient_clip_val)
    for group in tstate.optimizer.param_groups:
        group["lr"] = lr_schedule(tcfg)(tstate.step)
    tstate.optimizer.step()
    for name, p in params.items():
        st = tstate.optimizer.state[p]
        assert st["step"].item() == int(adam.count) == 26001
        torch.testing.assert_close(p.detach(), want_params[name], atol=1e-6, rtol=0, msg=name)
        torch.testing.assert_close(st["exp_avg"], want_mu[name], atol=1e-6, rtol=0, msg=name)
        torch.testing.assert_close(st["exp_avg_sq"], want_nu[name], atol=1e-6, rtol=0, msg=name)
        assert not torch.equal(p.detach(), saved["model"][name]), name


def test_eval_sim_reads_the_converted_checkpoint(capsys):
    """``eval_sim --ckpt artifacts/torch/r05_s0`` takes the checkpoint's
    shapes from its config.json (no width override), restores step 26000
    and evaluates."""
    from ctrl_sim_tpu_torch import eval_sim

    metrics = eval_sim.main(["--device", "cpu", "--synthetic", "2", "--synthetic_agents", "8",
                             "--ckpt", os.path.join(TOOL.OUT, "r05_s0"), "-o", "eval.rollout_mode=streaming"])
    assert "[eval] restored step 26000" in capsys.readouterr().out
    assert metrics and all(np.isfinite(v) for v in metrics.values())
