"""CTG++ model: the diffusion training loss and validation sampling MSE
(port of ``ctrl_sim_tpu/models/ctg_plus_plus.py``; reference
models/ctg_plus_plus.py).

Training: the weighted-L2 diffusion loss over joint [state (5) || action
(2)] futures, plus the optional RTG head's cross entropies (``model.use_rtg``).
Validation: the action and state MSE of sampled futures against the ground
truth (models/ctg_plus_plus.py:79-107).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch
from torch import nn

from ctrl_sim_tpu_torch.config import Config
from ctrl_sim_tpu_torch.device import resolve_device
from ctrl_sim_tpu_torch.models.ctg.diffusion import GaussianDiffusion, GuidanceFn
from ctrl_sim_tpu_torch.models.ctg.rtg_model import RTGModel, rtg_model_loss

Tensor = torch.Tensor

COND_KEYS = (
    "agent_past_states",
    "agent_past_actions",
    "past_relative_encodings",
    "future_relative_encodings",
    "agent_types",
    "goals",
    "timesteps",
    "rtgs",
    "road_points",
    "road_types",
    "moving_agent_mask",
)


class CTGLossDict(NamedTuple):
    total: Tensor
    diffusion_loss: Tensor
    a0_loss: Tensor
    rtg_goal: Tensor
    rtg_veh: Tensor
    rtg_road: Tensor


class CTGPlusPlus(nn.Module):
    """Parameters are fp32 on ``device`` (the card unless the caller passes
    ``device="cpu"``); activations run in ``model.compute_dtype``."""

    def __init__(self, cfg: Config, device: torch.device | str | None = None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.compute_dtype = getattr(torch, cfg.model.compute_dtype)
        self.diffusion = GaussianDiffusion(cfg, self.compute_dtype, device)
        if cfg.model.use_rtg:
            self.rtg_model = RTGModel(cfg, self.compute_dtype, device)

    def forward(self, batch: dict, generator: torch.Generator | None = None,
                noise_override: tuple[Tensor, Tensor] | None = None) -> Tensor:
        """Sampled futures [B, N, T_out, 7]."""
        return self.diffusion.sample({k: batch[k] for k in COND_KEYS}, generator, noise_override=noise_override)

    def sample_from_cond(self, cond: dict, generator: torch.Generator | None = None,
                         guidance_fn: GuidanceFn | None = None,
                         noise_override: tuple[Tensor, Tensor] | None = None) -> Tensor:
        """Sampled futures from a conditioning dict built by the rollout, with
        an optional guidance cost (``models/ctg/guidance.py``)."""
        return self.diffusion.sample(cond, generator, guidance_fn=guidance_fn, noise_override=noise_override)

    def loss(self, batch: dict, generator: torch.Generator | None = None,
             draws: tuple[Tensor, Tensor] | None = None,
             den_reduce: Callable[[Tensor], Tensor] | None = None) -> CTGLossDict:
        """The training losses of a batch; ``draws`` = (diffusion steps [B],
        noise) replaces those draws of ``generator``, which dropout uses.
        ``den_reduce`` (data parallelism) makes them this rank's shares of
        the global batch's losses."""
        cond = {k: batch[k] for k in COND_KEYS}
        t, noise = draws if draws is not None else (None, None)
        dloss, info = self.diffusion.loss(cond, batch["agent_future_states"], batch["agent_future_actions"],
                                          generator, t=t, noise=noise, den_reduce=den_reduce)
        rtg = [torch.zeros((), device=dloss.device)] * 3
        if self.cfg.model.use_rtg:
            logits = self.rtg_model(cond, deterministic=False, generator=generator)
            rtg = list(rtg_model_loss(self.cfg, cond, logits, den_reduce))
        return CTGLossDict(dloss + rtg[0] + rtg[1] + rtg[2], dloss, info["a0_loss"], *rtg)

    def validation_mse(self, batch: dict, generator: torch.Generator | None = None,
                       noise_override: tuple[Tensor, Tensor] | None = None,
                       den_reduce: Callable[[Tensor], Tensor] | None = None) -> dict:
        """Sampled-future state and action MSE (models/ctg_plus_plus.py:79-107);
        with ``den_reduce``, this rank's shares of the global batch's."""
        samples = self(batch, generator, noise_override)
        tgt_k = self.cfg.waymo.k_attr - 2
        future = batch["agent_future_states"]
        exist = future[..., -1:]
        denom = exist.sum()
        if den_reduce is not None:
            denom = den_reduce(denom.reshape(1))[0]
        denom = denom.clamp(min=1.0)
        state_mse = (((samples[..., :tgt_k] - future[..., :tgt_k]) ** 2) * exist).sum() / (denom * tgt_k)
        action_mse = (((samples[..., tgt_k:] - batch["agent_future_actions"]) ** 2) * exist).sum() / (denom * 2)
        return {"state_mse": state_mse, "action_mse": action_mse}
