"""The rollout cells' check: the reference, teacher-forced with the port's
tokens, judges the tokens and the trajectories of one chunk.

The port's rollout samples its tokens by the Gumbel-max rule: each draw is
the arg max of the (tilted, for the returns) logits minus the log of
standard exponential noise that the chunk's generator draws, step by step,
at the shapes of all of the chunk's agents. The reference replays that
noise from a generator seeded alike, so a draw is a greedy choice over
perturbed logits, and judges each of the port's draws by its gap: how far
the reference's perturbed logit of the port's token lies below the
reference's best. The reference runs its frozen copy of the rollout
(``sim``: model, sampling, env, contact solver, rewards) in float32 over a
sample of the chunk's scenes, feeds every draw that the port applied back
in (the return bins of every agent in the model, the actions of the
controlled agents past the history), and steps its own physics.

Compared:
- ``action_gap``: the widest gap of an applied action draw;
- ``rtg_gap``: the widest gap of a return draw (families that sample them);
- ``position_gap_m``: the largest distance between the port's and the
  reference's position of an agent alive on both sides, over every step.
"""

from __future__ import annotations

import torch

from benchmark import harness
from benchmark.reference import weights
from benchmark.reference.check_train import fp8_round


class ReplaySampler:
    """The rollout's sampler on the reference's side: draws the noise of
    the port's chunk, records the gap of the port's tokens (and of
    ``candidates``, another run's tokens, where given) and returns the
    port's tokens where the port used them, its own greedy choice
    elsewhere."""

    def __init__(self, cfg, noise_gen: torch.Generator, full: int, lanes: torch.Tensor, port_out,
                 candidates: dict | None = None):
        self.cfg, self.gen, self.full, self.lanes, self.port = cfg, noise_gen, full, lanes, port_out
        self.candidates = candidates
        self.gaps = {"action_gap": 0.0, "rtg_gap": 0.0, "candidate_action_gap": 0.0, "candidate_rtg_gap": 0.0}
        self.judged = {"actions": 0, "rtgs": 0}
        self.own = {"actions": [], "rtgs": []}

    def _noise(self, shape) -> torch.Tensor:
        noise = torch.empty((self.full,) + tuple(shape[1:]), dtype=torch.float32, device=self.lanes.device)
        noise.exponential_(generator=self.gen)
        return noise[self.lanes]

    def _judge(self, kind: str, t: int, perturbed: torch.Tensor, port: torch.Tensor, used: torch.Tensor):
        best = perturbed.amax(dim=-1)
        own = perturbed.argmax(dim=-1)
        self.own[kind].append(own)

        def gap(tokens):
            g = best - torch.gather(perturbed, -1, tokens.long()[..., None])[..., 0]
            return float(g[used].max()) if used.any() else 0.0

        key = "action_gap" if kind == "actions" else "rtg_gap"
        self.judged[kind] += int(used.sum())
        self.gaps[key] = max(self.gaps[key], gap(port))
        if self.candidates is not None:
            self.gaps[f"candidate_{key}"] = max(self.gaps[f"candidate_{key}"], gap(self.candidates[kind][t]))
        while used.dim() < port.dim():
            used = used[..., None]
        return torch.where(used, port.long(), own)

    def rtgs(self, t: int, logits: torch.Tensor, tilt: torch.Tensor, used: torch.Tensor) -> torch.Tensor:
        from benchmark.reference.sim.data.transforms import _rtg_bounds

        perturbed = (logits.float() + tilt).transpose(-1, -2)  # [E, A, 3, bins]
        perturbed = perturbed - torch.log(self._noise(perturbed.shape))
        wc = self.cfg.waymo
        values = self.port.rtgs[t]
        port = torch.stack([torch.round((values[..., i] - lo) / (hi - lo) * (wc.rtg_discretization - 1))
                            for i, (lo, hi) in enumerate(_rtg_bounds(wc))], dim=-1)
        return self._judge("rtgs", t, perturbed, port, used[..., None].expand(port.shape))

    def actions(self, t: int, logits: torch.Tensor, used: torch.Tensor) -> torch.Tensor:
        from benchmark.reference.sim.data import transforms as tf
        from benchmark.reference.sim.rollout.policy import nucleus_filter

        pc = self.cfg.policy
        scaled = logits.float() / pc.action_temperature
        if pc.nucleus_sampling:
            scaled = nucleus_filter(scaled, pc.nucleus_threshold)
        perturbed = scaled - torch.log(self._noise(scaled.shape))
        port = tf.discretize_actions(torch.stack([self.port.acceleration[t], self.port.steering[t]], dim=-1),
                                     self.cfg.waymo)
        return self._judge("actions", t, perturbed, port, used)


def teacher_forced(config: dict, traffic: dict, seed: int, scenes: list, lanes, chunk_seed: int, port_out,
                   device, quantize: bool = False, candidates: dict | None = None, extra: dict | None = None):
    """(reference output, sampler) of the reference's rollout of the scenes
    ``lanes`` of the chunk seeded ``chunk_seed``, teacher-forced with
    ``port_out`` (the port's output at those lanes); ``quantize`` rounds
    every dense layer's operands to float8 (the control)."""
    from benchmark.reference.sim import config as ref_config
    from benchmark.reference.sim.data import stack_scenarios, to_torch
    from benchmark.reference.sim.data.transforms import get_tilt_logits
    from benchmark.reference.sim.models.ctrl_sim import CtRLSim
    from benchmark.reference.sim.models.layers import Dense
    from benchmark.reference.sim.rollout.streaming import run_streaming

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = harness.build_config(ref_config, config, traffic, {**(extra or {}), **harness.REFERENCE_PRECISION})
    scenario = to_torch(stack_scenarios([scenes[i] for i in lanes], cfg), device)
    model = CtRLSim(cfg, device=device)
    weights.load(model, weights.make(model, seed, device))
    model.eval()
    if quantize:
        for module in model.modules():
            if isinstance(module, Dense):
                module.round_operands = fp8_round
    tilt = get_tilt_logits(*traffic["tilt"], cfg.waymo, device=device)
    sampler = ReplaySampler(cfg, torch.Generator(device=device).manual_seed(chunk_seed), len(scenes),
                            torch.as_tensor(lanes, device=device), port_out, candidates)
    out = run_streaming(cfg, model, scenario, scenario.moving & scenario.agent_valid, None, tilt, sampler=sampler)
    return out, sampler


def position_gap(ref_out, port_out) -> float:
    both = (ref_out.existence > 0) & (port_out.existence > 0)
    dist = torch.linalg.vector_norm(ref_out.position - port_out.position, dim=-1)
    return float(dist[both].max()) if both.any() else 0.0


def compare(ref, port_out, limits: dict) -> dict:
    """Each compared number beside its limit."""
    ref_out, sampler = ref
    numbers = {"action_gap": sampler.gaps["action_gap"], "position_gap_m": position_gap(ref_out, port_out)}
    if "rtg_gap" in limits:
        numbers["rtg_gap"] = sampler.gaps["rtg_gap"]
    return {name: {"value": value, "limit": limits[name]} for name, value in numbers.items()}
