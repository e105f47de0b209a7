"""Worker of tests/test_torch_distributed.py: one gloo rank on the CPU.

Launched as 2 processes with torchrun's environment variables (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``). Every rank
builds the same toy scenes, batches and weights from seeds and runs, data
parallel over the 2-rank mesh:

- one CtRL-Sim train step at ``accum_steps`` 2 with dropout and goal
  dropout on, then the eval step and the grad-norm function; the same
  with ``model.remat`` (the backward recomputes the layers' dropout);
- one CTG++ train step (diffusion draws from the generator, accumulation
  2), then its validation step;
- ``run_closed_loop`` sharded over the env axis, each rank drawing from its
  own generator, the outputs and the draws gathered.

Rank 0 then runs the same on one process (the trainer without a mesh; the
rollout replaying the gathered draws) and writes the largest differences to
the JSON file named by the first argument.
"""

import json
import os
import sys

import numpy as np
import torch

torch.set_num_threads(1)

from ctrl_sim_tpu_torch.config import _set_dotted, load_config, preset  # noqa: E402
from ctrl_sim_tpu_torch.data import stack_scenarios, synthetic_scenario, to_torch  # noqa: E402
from ctrl_sim_tpu_torch.data.store import ScenarioStore  # noqa: E402
from ctrl_sim_tpu_torch.models.ctrl_sim import CtRLSim  # noqa: E402
from ctrl_sim_tpu_torch.parallel import MeshSpec, init_distributed, make_mesh  # noqa: E402
from ctrl_sim_tpu_torch.parallel.mesh import run_sharded  # noqa: E402
from ctrl_sim_tpu_torch.params import init_params  # noqa: E402
from ctrl_sim_tpu_torch.rollout.policy import PolicySampler  # noqa: E402
from ctrl_sim_tpu_torch.rollout.rollout import run_closed_loop  # noqa: E402
from ctrl_sim_tpu_torch.training import trainer_for  # noqa: E402

TOY = {
    "model.hidden_dim": 32, "model.num_heads": 2, "model.dim_feedforward": 64,
    "model.num_decoder_layers": 1, "model.num_transformer_encoder_layers": 1,
    "model.compute_dtype": "float32", "waymo.train_context_length": 4, "waymo.max_num_agents": 6,
    "waymo.max_num_road_polylines": 8, "waymo.max_num_road_pts_per_polyline": 10, "sim.max_agents": 6,
    "sim.steps": 10, "train.warmup_steps": 0,
}
CTG = {
    "model.hidden_dim": 32, "model.num_heads": 2, "model.dim_feedforward": 64,
    "model.num_transformer_encoder_layers": 1, "model.compute_dtype": "float32",
    "model.n_diffusion_steps": 8, "model.n_eval_diffusion_step": 4, "waymo.train_context_length": 6,
    "waymo.input_horizon": 3, "waymo.max_num_agents": 4, "waymo.rtg_discretization": 20,
    "waymo.max_num_road_polylines": 5, "waymo.max_num_road_pts_per_polyline": 6, "sim.max_agents": 4,
    "sim.steps": 10, "train.warmup_steps": 0,
}


def configure(cfg, over):
    for key, value in over.items():
        cfg = _set_dotted(cfg, key, value)
    return cfg


def rel_diff(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| / max(1, |b|), elementwise."""
    a, b = a.detach().double(), b.detach().double()
    return float(((a - b).abs() / b.abs().clamp(min=1.0)).max()) if a.numel() else 0.0


def train_case(mesh: MeshSpec, cfg, family: str, batch_size: int) -> dict:
    agents = cfg.waymo.max_num_agents - 1
    scenes = [synthetic_scenario(cfg, seed=s, num_agents=agents, arena_half=60.0, num_lanes=2) for s in range(6)]
    store = ScenarioStore.from_scenes(cfg, scenes, device="cpu")
    batch = store.sample_batch(torch.Generator().manual_seed(1), batch_size, family=family)

    def run(m: MeshSpec) -> dict:
        trainer = trainer_for(cfg, device="cpu", mesh=m)
        state = trainer.init_state(torch.Generator().manual_seed(0))
        state, losses = trainer.make_train_step()(state, batch, torch.Generator().manual_seed(2))
        out = {"losses": torch.stack(list(losses)), "grad_norm": state.grad_norm.reshape(1),
               "grads": torch.cat([p.grad.reshape(-1) for p in state.model.parameters()]),
               "params": torch.cat([p.detach().reshape(-1) for p in state.model.parameters()])}
        if family == "ctg_plus_plus":
            ev = trainer.make_eval_step()(state, batch, torch.Generator().manual_seed(3))
            out["eval"] = torch.stack([ev["state_mse"], ev["action_mse"]])
        else:
            out["eval"] = torch.stack(list(trainer.make_eval_step()(state, batch)))
            gn = trainer.make_grad_norm_fn()(state, batch, torch.Generator().manual_seed(4))
            out["grad_norms"] = torch.stack([gn[k] for k in sorted(gn)])
        return out

    got = run(mesh)
    if mesh.rank != 0:
        return {}
    want = run(MeshSpec())
    grads = want.pop("grads")
    g, dg = grads.abs(), (got["grads"] - grads).abs()
    report = {k: rel_diff(got[k], want[k]) for k in want if k != "params"}
    report["grads"] = float(dg.max() / g.max())
    # Adam's first update is lr g / (|g| + eps): a gradient that vanishes to
    # rounding noise updates by anything up to lr, so the update is held
    # where the gradient is more than twice the runs' largest gradient
    # difference and well above eps
    kept = g > 2 * dg.max() + 1e-6
    report["params"] = rel_diff(got["params"][kept], want["params"][kept])
    report["params_held"] = float(kept.double().mean())
    report["loss"] = float(want["losses"][0])
    return report


class Recording:
    def __init__(self, inner):
        self.inner, self.rtg, self.act = inner, [], []

    def rtgs(self, t, logits, tilt):
        self.rtg.append(self.inner.rtgs(t, logits, tilt))
        return self.rtg[-1]

    def actions(self, t, logits):
        self.act.append(self.inner.actions(t, logits))
        return self.act[-1]


class Replay:
    def __init__(self, rtg, act):
        self.rtg, self.act = rtg, act

    def rtgs(self, t, logits, tilt):
        return self.rtg[t]

    def actions(self, t, logits):
        return self.act[t]


def rollout_case(mesh: MeshSpec) -> dict:
    cfg = configure(load_config(), {**TOY, "sim.history_steps": 3})
    scenes = [synthetic_scenario(cfg, seed=10 + s, num_agents=5, arena_half=60.0, num_lanes=2) for s in range(4)]
    sc = to_torch(stack_scenarios(scenes, cfg), "cpu")
    controlled = sc.moving & sc.agent_valid
    model = CtRLSim(cfg, device="cpu")
    init_params(model, torch.Generator().manual_seed(0))
    model.eval()
    rec = Recording(PolicySampler(cfg, torch.Generator().manual_seed(100 + mesh.rank)))
    out = run_sharded(mesh, run_closed_loop, cfg, model, sc, controlled, None, sampler=rec)
    rtg = mesh.gather(torch.stack(rec.rtg), axis=1) if rec.rtg else None
    act = mesh.gather(torch.stack(rec.act), axis=1)
    if mesh.rank != 0:
        return {}
    want = run_closed_loop(cfg, model, sc, controlled, None, sampler=Replay(rtg, act))
    report = {name: rel_diff(getattr(out, name).float(), getattr(want, name).float()) for name in want._fields}
    report["distinct_rank_draws"] = bool((act[:, :2] != act[:, 2:]).any())
    return report


def main() -> None:
    init_distributed(device="cpu")
    mesh = make_mesh()
    assert mesh.world == 2, mesh
    ctrl = configure(load_config(), {**TOY, "train.accum_steps": 2, "model.dropout": 0.1, "model.goal_dropout": 0.2})
    ctg = configure(preset("ctg_plus_plus"), {**CTG, "model.use_rtg": True})
    report = {
        "ctrl_sim": train_case(mesh, ctrl, "ctrl_sim", 8),
        "ctrl_sim_remat": train_case(mesh, configure(ctrl, {"model.remat": True}), "ctrl_sim", 8),
        "ctg_plus_plus": train_case(mesh, ctg, "ctg_plus_plus", 8),
        "closed_loop": rollout_case(mesh),
    }
    if mesh.rank == 0:
        with open(sys.argv[1], "w") as f:
            json.dump(report, f)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    np.set_printoptions(precision=3)
    main()
