"""The reference against the port at a toy size on the CPU, the control,
and runs of the harness with the timed path broken underneath, which have
to come out not correct.

A toy size: hidden 32, 4 heads, 1 + 2 layers, 8 agent slots, 4 scenes of 4
agents, 20 steps, train windows of 8 steps; the port's kernels run their
plain versions on the CPU. The cells' limits are set at their own sizes on
the card (``PERF.md``); here each number is held to that limit, the faults
must break one, and the control must read above the port.
"""

from __future__ import annotations

import copy

import pytest
import torch

from benchmark import harness
from benchmark.calibrate import calibrate, plant
from benchmark.run import execute

BENCH = harness.manifest()
CELLS = [w["name"] for w in BENCH["workloads"]]
TOY = {"model.hidden_dim": 32, "model.num_heads": 4, "model.dim_feedforward": 64,
       "model.num_transformer_encoder_layers": 1, "model.num_decoder_layers": 2,
       "waymo.max_num_agents": 8, "sim.max_agents": 8, "waymo.train_context_length": 8, "sim.steps": 20,
       "eval.agent_slots": 8}
SEED = 2**31 + 977  # past 32 signed bits: the command takes any whole seed


def toy(name: str):
    cell = harness.cell(BENCH, name)
    config = {**harness.config_file(BENCH, cell["config"]), "agents_per_scene": 4}
    traffic = harness.traffic_file(cell["traffic"])
    if traffic["kind"] == "train":
        traffic.update(scenes=4, global_batch=4, accum_steps=2, check={"row_block": 1})
        return cell, config, traffic, {**TOY, "train.global_batch_size": 4, "train.accum_steps": 2}
    traffic.update(scenes=4, check={"lanes": 2, "among_first": 3})
    return cell, config, traffic, TOY


def run_toy(name: str) -> dict:
    cell, config, traffic, extra = toy(name)
    return execute(BENCH, cell, SEED, 0.05, False, "cpu", config, traffic, extra)


# at a toy size the bf16 model's rounding reaches the gradients' and the
# changes' norms more than at the full width (CPU: 0.012-0.044 and
# 0.017-0.043 over seeds; in the window's last steps 0.026-0.066 and
# 0.007-0.020); every other number is held to the cell's limit
TOY_LIMITS = {"grad_gap": 0.05, "change_gap": 0.05, "window_grad_gap": 0.1, "window_change_gap": 0.05}


@pytest.mark.parametrize("name", CELLS)
def test_port_agrees_with_the_reference_at_a_toy_size(name):
    out = run_toy(name)
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert set(out["checks"]) == set(harness.limits_file(name))
    for key, c in out["checks"].items():
        assert c["value"] <= max(c["limit"], TOY_LIMITS.get(key, 0.0)), (key, c)
    assert "setup_s" in out["metrics"]


@pytest.mark.parametrize("name", CELLS)
def test_control_reads_above_the_port(name):
    cell, config, traffic, extra = toy(name)
    row = calibrate(name, SEED, True, 0.05, "cpu", config, traffic, extra)
    assert any(row["control"][k] > row["numbers"][k] for k in row["numbers"]), row


def test_fault_state_left_unchanged(monkeypatch):
    from ctrl_sim_tpu_torch.training import trainer

    def make_train_step(self):
        def step(state, batch, generator, draws=None):
            state.model.train()
            micro = {k: v[: len(v) // max(self.cfg.train.accum_steps, 1)] for k, v in batch.items()}
            with torch.no_grad():
                losses = self.microbatch_losses(state.model, micro, generator)
            return state, losses

        return step

    monkeypatch.setattr(trainer.Trainer, "make_train_step", make_train_step)
    out = run_toy("train.ctrl_sim")
    assert not out["correct"]
    assert out["checks"]["change_gap"]["value"] >= 0.99
    assert out["checks"]["window_change_gap"]["value"] >= 0.99


@pytest.mark.parametrize("name", [c for c in CELLS if c.startswith("train.")])
def test_fault_after_the_first_steps_is_caught_in_the_window(monkeypatch, name):
    # the step is sound for the set-up's first steps, then returns its state unchanged, as a step
    # replaced after warm-up (a captured graph, a stale buffer) could: the first steps' check passes,
    # the window's first steps fail it
    from ctrl_sim_tpu_torch.training import trainer

    real = trainer.Trainer.make_train_step

    def make_train_step(self):
        step, calls = real(self), []

        def faulty(state, batch, generator, draws=None):
            calls.append(1)
            if len(calls) <= 3:
                return step(state, batch, generator, draws)
            _, losses = step(copy.deepcopy(state), batch, generator, draws)
            return state, losses

        return faulty

    monkeypatch.setattr(trainer.Trainer, "make_train_step", make_train_step)
    out = run_toy(name)
    checks = out["checks"]
    assert not out["correct"]
    assert all(c["value"] <= max(c["limit"], TOY_LIMITS.get(k, 0.0))
               for k, c in checks.items() if not k.startswith("window_")), checks
    assert checks["window_change_gap"]["value"] >= 0.99


def test_fault_half_of_the_batch_left_out(monkeypatch):
    from ctrl_sim_tpu_torch.training import trainer

    monkeypatch.setattr(trainer.Trainer, "make_train_step", trainer.Trainer.make_train_step)  # restored after
    plant("half_batch")
    out = run_toy("train.ctrl_sim")
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("name", [c for c in CELLS if c.startswith("rollout.")])
def test_fault_token_altered_where_it_is_drawn(monkeypatch, name):
    from ctrl_sim_tpu_torch.rollout import policy

    real = policy.PolicySampler.actions

    def actions(self, t, logits):
        return (real(self, t, logits) + 1) % logits.shape[-1]

    monkeypatch.setattr(policy.PolicySampler, "actions", actions)
    out = run_toy(name)
    assert not out["correct"]
    assert out["checks"]["action_gap"]["value"] > out["checks"]["action_gap"]["limit"]


@pytest.mark.parametrize("name", [c for c in CELLS if c.startswith("rollout.")])
def test_fault_env_step_returns_its_state_unchanged(monkeypatch, name):
    from ctrl_sim_tpu_torch.env.env import WaymoEnv

    monkeypatch.setattr(WaymoEnv, "step", WaymoEnv.step)  # restored after
    plant("env_unchanged")
    out = run_toy(name)
    assert not out["correct"]
    assert out["checks"]["position_gap_m"]["value"] > out["checks"]["position_gap_m"]["limit"]
