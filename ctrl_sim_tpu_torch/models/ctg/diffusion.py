"""Gaussian diffusion for CTG++ (port of
``ctrl_sim_tpu/models/ctg/diffusion.py``; reference modules/diffusion.py and
utils/diffusion_helpers.py).

DDPM with a cosine beta schedule (100 train steps), x0 prediction, a
weighted L2 loss with the first future action up-weighted x10, diffusing
joint [local state (5) || action (2)] futures, and the strided 50-step
sampling loop. ``sample`` takes an optional ``guidance_fn(x, cond) ->
scalar cost`` whose gradient with respect to the posterior mean nudges it
(``models/ctg/guidance.py``).

Random draws come from a ``torch.Generator``; ``loss`` also takes its
diffusion steps and noise, and ``sample`` its whole noise stream
(``noise_override``), so that a test can feed the draws of another
program.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch
from torch import nn

from ctrl_sim_tpu_torch.config import Config
from ctrl_sim_tpu_torch.models.ctg.dit import DiT
from ctrl_sim_tpu_torch.models.draws import randint_rows, randn_rows

Tensor = torch.Tensor
GuidanceFn = Callable[[Tensor, dict], Tensor]
# the guided sampler's steps on the posterior mean (the JAX sample's
# defaults, ctrl_sim_tpu/models/ctg/diffusion.py:172-173)
GUIDE_SCALE = 0.1
N_GUIDE_STEPS = 2


def cosine_beta_schedule(timesteps: int, s: float = 0.008) -> np.ndarray:
    """diffusion_helpers.py:80-91, in float64 numpy, returned as float32."""
    steps = timesteps + 1
    x = np.linspace(0, steps, steps)
    alphas_cumprod = np.cos(((x / steps) + s) / (1 + s) * np.pi * 0.5) ** 2
    alphas_cumprod = alphas_cumprod / alphas_cumprod[0]
    betas = 1 - (alphas_cumprod[1:] / alphas_cumprod[:-1])
    return np.clip(betas, 0, 0.999).astype(np.float32)


class DiffusionSchedule(NamedTuple):
    betas: Tensor
    alphas_cumprod: Tensor
    alphas_cumprod_prev: Tensor
    sqrt_alphas_cumprod: Tensor
    sqrt_one_minus_alphas_cumprod: Tensor
    sqrt_recip_alphas_cumprod: Tensor
    sqrt_recipm1_alphas_cumprod: Tensor
    posterior_variance: Tensor
    posterior_log_variance_clipped: Tensor
    posterior_mean_coef1: Tensor
    posterior_mean_coef2: Tensor

    @staticmethod
    def create(n_timesteps: int, device=None) -> "DiffusionSchedule":
        """The constants computed in numpy, with the JAX package's dtypes
        (float32 betas, float64 where its numpy promotes), then float32."""
        betas = cosine_beta_schedule(n_timesteps)
        alphas = 1.0 - betas
        ac = np.cumprod(alphas)
        ac_prev = np.concatenate([[1.0], ac[:-1]])
        post_var = betas * (1.0 - ac_prev) / (1.0 - ac)
        arrays = DiffusionSchedule(
            betas=betas,
            alphas_cumprod=ac,
            alphas_cumprod_prev=ac_prev,
            sqrt_alphas_cumprod=np.sqrt(ac),
            sqrt_one_minus_alphas_cumprod=np.sqrt(1.0 - ac),
            sqrt_recip_alphas_cumprod=np.sqrt(1.0 / ac),
            sqrt_recipm1_alphas_cumprod=np.sqrt(1.0 / ac - 1.0),
            posterior_variance=post_var,
            posterior_log_variance_clipped=np.log(np.clip(post_var, 1e-20, None)),
            posterior_mean_coef1=betas * np.sqrt(ac_prev) / (1.0 - ac),
            posterior_mean_coef2=(1.0 - ac_prev) * np.sqrt(alphas) / (1.0 - ac),
        )
        return DiffusionSchedule(*(torch.tensor(np.asarray(a, np.float32), device=device) for a in arrays))


def _extract(a: Tensor, t: Tensor, ndim: int) -> Tensor:
    return a[t].reshape(t.shape + (1,) * (ndim - t.dim()))


class GaussianDiffusion(nn.Module):
    """Owns the DiT denoiser; gives the training loss and the sampler."""

    def __init__(self, cfg: Config, dtype, device=None):
        super().__init__()
        wc, mc = cfg.waymo, cfg.model
        self.cfg = cfg
        self.model = DiT(cfg, dtype, device)
        self.horizon = wc.train_context_length - wc.input_horizon
        self.action_dim = wc.ctg_action_dim
        self.transition_dim = (wc.k_attr - 2) + self.action_dim
        self.n_timesteps = mc.n_diffusion_steps
        self.schedule = DiffusionSchedule.create(self.n_timesteps, device)
        self.loss_weights = self._loss_weights().to(device)

    def _loss_weights(self) -> Tensor:
        """get_loss_weights (diffusion.py:82-110): uniform dim weights with
        discount**t over the horizon (normalized), the first action's
        weights ``action_weight``; [1, horizon, transition_dim]."""
        mc = self.cfg.model
        dim_weights = np.ones(self.transition_dim, np.float32)
        discounts = mc.loss_discount ** np.arange(self.horizon, dtype=np.float32)
        discounts = discounts / discounts.mean()
        w = np.einsum("h,t->ht", discounts, dim_weights)[None]
        w[:, 0, -self.action_dim:] = mc.action_weight
        return torch.tensor(w, dtype=torch.float32)

    def q_sample(self, x_start: Tensor, t: Tensor, noise: Tensor) -> Tensor:
        s = self.schedule
        return (_extract(s.sqrt_alphas_cumprod, t, x_start.dim()) * x_start
                + _extract(s.sqrt_one_minus_alphas_cumprod, t, x_start.dim()) * noise)

    def loss(self, cond: dict, x_states: Tensor, x_actions: Tensor, generator: torch.Generator | None = None,
             t: Tensor | None = None, noise: Tensor | None = None,
             den_reduce: Callable[[Tensor], Tensor] | None = None) -> tuple[Tensor, dict]:
        """p_losses (diffusion.py:256-285): weighted L2 of the x0 prediction,
        masked by existence (times the moving mask under
        ``model.supervise_moving``). x_states [B, N, T_out, 6] (local state
        5 + existence), x_actions [B, N, T_out, 2]. The diffusion steps
        ``t`` [B] and ``noise`` (x's shape) are drawn from ``generator``
        unless given; dropout draws from it. ``den_reduce`` maps this
        rank's counts (samples, elements) to the global batch's (data
        parallelism): the losses are then this rank's shares."""
        mc = self.cfg.model
        x = torch.cat([x_states[..., :-1], x_actions], dim=-1)
        existence = x_states[..., -1]
        if mc.supervise_moving:
            existence = existence * cond["moving_agent_mask"][..., None]
        B, dev = x.shape[0], x.device
        gdev = generator.device if generator is not None else dev
        if t is None:
            t = randint_rows(0, self.n_timesteps, (B,), generator, gdev).to(dev)
        if noise is None:
            noise = randn_rows(x.shape, generator, gdev).to(dev)
        x_noisy = self.q_sample(x, t.long(), noise)
        x_recon = self.model(x_noisy, cond, t, deterministic=False, generator=generator)

        w = self.loss_weights[None]  # [1, 1, horizon, transition]
        err = (x_recon.float() - x.float()) ** 2
        weighted = (err * w * existence[..., None]).mean(-1)
        denom = existence.sum(dim=(1, 2)).clamp(min=1.0)
        a = self.action_dim
        a0 = err[:, :, 0, -a:] * existence[:, :, :1] / w[:, :, 0, -a:]
        counts = torch.tensor([float(B), float(a0.numel())], device=dev)
        if den_reduce is not None:
            counts = den_reduce(counts)
        weighted_loss = (weighted.sum(dim=(1, 2)) / denom).sum() / counts[0]
        return weighted_loss, {"a0_loss": a0.sum() / counts[1]}

    def sample(
        self,
        cond: dict,
        generator: torch.Generator | None = None,
        guidance_fn: GuidanceFn | None = None,
        noise_override: tuple[Tensor, Tensor] | None = None,
    ) -> Tensor:
        """Strided p_sample_loop (diffusion.py:154-186): x starts at
        0.5 N(0, I), ``n_eval_diffusion_step`` steps strided over the train
        steps, noise scale 0.5 and none at step 0, the posterior step from
        the x0 prediction. ``noise_override = (x0_noise, step_noises
        [n_eval, ...])`` replaces the unit-normal draws. The map and edge
        encodings are computed once for every denoiser call (they depend on
        ``cond`` alone). A guidance cost takes ``N_GUIDE_STEPS`` gradient
        steps of ``GUIDE_SCALE`` on the posterior mean."""
        mc = self.cfg.model
        s = self.schedule
        B, N = cond["agent_past_states"].shape[:2]
        dev = cond["agent_past_states"].device
        gdev = generator.device if generator is not None else dev
        shape = (B, N, self.horizon, self.transition_dim)

        def unit_normal() -> Tensor:
            return randn_rows(shape, generator, gdev).to(dev)

        x = 0.5 * (noise_override[0].to(dev) if noise_override is not None else unit_normal())
        stride = self.n_timesteps // mc.n_eval_diffusion_step
        ts = list(range(0, self.n_timesteps, stride))[::-1]
        context = self.model.encode_context(cond)
        for k, i in enumerate(ts):
            t = torch.full((B,), i, dtype=torch.long, device=dev)
            x_recon = self.model(x, cond, t, context=context)
            mean = (_extract(s.posterior_mean_coef1, t, x.dim()) * x_recon
                    + _extract(s.posterior_mean_coef2, t, x.dim()) * x)
            if guidance_fn is not None:
                for _ in range(N_GUIDE_STEPS):
                    with torch.enable_grad():
                        m = mean.detach().requires_grad_(True)
                        (g,) = torch.autograd.grad(guidance_fn(m, cond), m)
                    mean = mean - GUIDE_SCALE * g
            log_var = _extract(s.posterior_log_variance_clipped, t, x.dim())
            step_noise = noise_override[1][k].to(dev) if noise_override is not None else unit_normal()
            nonzero = float(i != 0)
            x = mean + nonzero * torch.exp(0.5 * log_var) * (0.5 * step_noise)
        return x
