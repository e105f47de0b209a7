"""Rollout-time sampling (port of ``ctrl_sim_tpu/rollout/policy.py``):
exponentially tilted RTG sampling (reference policies/policy.py:108-142) and
temperature / nucleus action sampling (autoregressive_policy.py:209-240),
batched over every lane and agent, drawing from an explicit
``torch.Generator``. The JAX package draws from ``jax.random`` keys, so the
two agree in distribution, not draw for draw."""

from __future__ import annotations

import torch

from benchmark.reference.sim.config import Config

Tensor = torch.Tensor


def sample_categorical(generator: torch.Generator, logits: Tensor) -> Tensor:
    """One draw per row over the last axis, P(i) = softmax(logits)_i, by the
    Gumbel-max trick in its exponential form: argmax(logits - log E),
    E ~ Exp(1)."""
    noise = torch.empty(logits.shape, dtype=torch.float32, device=logits.device)
    noise.exponential_(generator=generator)
    return torch.argmax(logits.float() - torch.log(noise), dim=-1)


def categorical_invcdf(generator: torch.Generator, logits: Tensor) -> Tensor:
    """One draw per row over the last axis by the inverse CDF: one uniform u
    per row and the count of cumulative weights below u times their total,
    P(i) = softmax(logits)_i (the JAX package's ``categorical_invcdf``,
    kept there for CPU tooling and as the samplers' distributional test
    oracle). A row with every logit at the same floor (fully masked)
    samples uniformly."""
    m = logits.float().amax(dim=-1, keepdim=True)
    cum = torch.cumsum(torch.exp2((logits.float() - m) * 1.4426950408889634), dim=-1)
    u = torch.rand(logits.shape[:-1] + (1,), generator=generator, device=logits.device)
    return (cum < u * cum[..., -1:]).sum(dim=-1)


def sample_tilted_rtgs(generator: torch.Generator, rtg_logits: Tensor, tilt_logits: Tensor) -> Tensor:
    """Add tilt logits per component and sample one bin per component
    (policy.py:117-129). rtg_logits [..., num_bins, 3], tilt broadcastable;
    returns integer bins [..., 3]."""
    tilted = rtg_logits.float() + tilt_logits
    return sample_categorical(generator, tilted.transpose(-1, -2))


def nucleus_filter(logits: Tensor, threshold: float) -> Tensor:
    """Top-p filtering (autoregressive_policy.py:217-231): keep the smallest
    prefix of descending-probability tokens whose cumulative mass reaches
    ``threshold`` (the crossing token included); ties with the last kept
    probability are kept too, as in the JAX version."""
    probs = torch.softmax(logits, dim=-1)
    sorted_probs = torch.sort(probs, dim=-1, descending=True).values
    cum = torch.cumsum(sorted_probs, dim=-1)
    prev_cum = torch.cat([torch.zeros_like(cum[..., :1]), cum[..., :-1]], dim=-1)
    num_keep = (prev_cum < threshold).sum(dim=-1, keepdim=True)
    kth = torch.gather(sorted_probs, -1, num_keep - 1)
    return torch.where(probs >= kth, logits, torch.finfo(logits.dtype).min)


def sample_actions(
    generator: torch.Generator,
    logits: Tensor,  # [..., num_actions]
    temperature: float = 1.0,
    nucleus: bool = False,
    nucleus_threshold: float = 0.8,
) -> Tensor:
    """Temperature + optional nucleus sampling -> action ids [...]."""
    scaled = logits.float() / temperature
    if nucleus:
        scaled = nucleus_filter(scaled, nucleus_threshold)
    return sample_categorical(generator, scaled)


class PolicySampler:
    """Draws the rollout's RTG bins and action ids with the policy config
    from one ``torch.Generator``. Both rollouts call
    ``rtgs(t, table_logits [E, A, bins, 3], tilt)`` and
    ``actions(t, table_logits [E, A, num_actions])`` (``rtgs`` only where
    the policy samples returns, ``policy.predict_rtgs``); a test can pass
    another object with these two methods to replay given draws."""

    def __init__(self, cfg: Config, generator: torch.Generator):
        self.pc = cfg.policy
        self.generator = generator

    def rtgs(self, t: int, logits: Tensor, tilt: Tensor, used: Tensor | None = None) -> Tensor:
        return sample_tilted_rtgs(self.generator, logits, tilt)

    def actions(self, t: int, logits: Tensor, used: Tensor | None = None) -> Tensor:
        pc = self.pc
        return sample_actions(
            self.generator, logits, pc.action_temperature, pc.nucleus_sampling,
            pc.nucleus_threshold,
        )
