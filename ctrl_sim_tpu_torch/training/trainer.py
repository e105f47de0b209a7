"""Trainer of the CtRL-Sim model (port of ``ctrl_sim_tpu/training/trainer.py``).

The reference's optimization recipe (models/ctrl_sim.py:242-282 +
cfgs/train/base.yaml): AdamW lr 5e-4, weight decay 1e-4 on the linear and
attention weights only (embeddings, LayerNorms, biases and the map seed
excluded), 500-step linear warmup then linear decay to 0 at ``max_steps``,
gradient clipping at global norm 10, gradients averaged over
``accum_steps`` microbatches. Three details follow optax, as the JAX
trainer does:

- the schedule is read at the update count *before* the update, so the
  first update has lr 0;
- clipping scales by ``max_norm / norm`` when ``norm > max_norm``
  (``clip_grad_norm_`` would add 1e-6 to the norm);
- the decay partition is by module type (``Dense`` weights): in a
  ``state_dict`` LayerNorm scales and embeddings are ``weight`` too.

The model, the optimizer and the step count live in a ``TrainState`` that
the train step updates in place and returns. ``CTGTrainer`` trains the CTG++
model with the same recipe.

With a ``mesh`` of more than one rank (``parallel/mesh.py``, one process per
card), a step is the single-process step on the global batch, which every
rank holds: microbatch i is split over the data ranks (rank r takes its
part of global microbatch i, as GSPMD splits it), each loss's mask sums are
all-reduced before the backward so that each rank's loss is its share of
the global masked mean, every random draw is made at the global
microbatch's shape and cut to the rank's rows (``models/draws.py``; the flash
kernels key dropout on the global row), and the gradients are all-reduced
before the global-norm clip. The logged losses are the global ones.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ctrl_sim_tpu_torch.config import Config
from ctrl_sim_tpu_torch.device import resolve_device
from ctrl_sim_tpu_torch.models.ctrl_sim import CtRLSim, LossDict, compute_loss
from ctrl_sim_tpu_torch.models.draws import RowGenerator
from ctrl_sim_tpu_torch.models.layers import Dense
from ctrl_sim_tpu_torch.parallel.mesh import MeshSpec
from ctrl_sim_tpu_torch.params import init_params
from ctrl_sim_tpu_torch.utils.logging import grad_norms

Tensor = torch.Tensor


@dataclass
class TrainState:
    step: int
    model: CtRLSim
    optimizer: torch.optim.Optimizer
    grad_norm: Tensor | None = None  # global gradient norm of the last update, before clipping


def lr_schedule(cfg: Config):
    """Linear warmup then linear decay (utils/train_utils.py:5-12)."""
    warmup, max_steps, lr = cfg.train.warmup_steps, cfg.train.max_steps, cfg.train.lr

    def schedule(step: int) -> float:
        if step < warmup:
            return lr * step / warmup
        return lr * max(0.0, (max_steps - step) / (max_steps - warmup))

    return schedule


def decay_names(model: torch.nn.Module) -> set[str]:
    """Names of the parameters that receive weight decay: the weights of
    ``Dense`` modules (linear layers and attention projections), which are
    the leaves the JAX mask picks by the name ``kernel``."""
    return {f"{name}.weight" for name, module in model.named_modules() if isinstance(module, Dense)}


def make_optimizer(cfg: Config, model: torch.nn.Module) -> torch.optim.AdamW:
    """AdamW over two groups, decayed and not; the learning rate is set
    from ``lr_schedule`` before each update by the train step."""
    decay = decay_names(model)
    params = dict(model.named_parameters())
    groups = [
        {"params": [p for n, p in params.items() if n in decay], "weight_decay": cfg.train.weight_decay},
        {"params": [p for n, p in params.items() if n not in decay], "weight_decay": 0.0},
    ]
    return torch.optim.AdamW(groups, lr=0.0, betas=(0.9, 0.999), eps=1e-8)


@torch.no_grad()
def clip_by_global_norm(grads: list[Tensor], max_norm: float) -> Tensor:
    """optax.clip_by_global_norm: scale every gradient by max_norm / norm
    when the global norm exceeds max_norm. Returns the norm before
    clipping; nothing leaves the device."""
    norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g.float()) for g in grads]))
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    for g in grads:
        g.mul_(scale)
    return norm


def _split(batch: dict, accum: int) -> list[dict]:
    """``accum`` equal microbatches; a batch that ``accum`` does not divide
    raises, as the JAX step's reshape does (uneven chunks would be
    mis-weighted by the 1/accum average)."""
    n = len(next(iter(batch.values())))
    if n % accum:
        raise ValueError(f"a batch of {n} does not split into {accum} equal microbatches (train.accum_steps)")
    return [dict(zip(batch, parts)) for parts in zip(*(v.chunk(accum) for v in batch.values()))]


DATA_STREAM, DROPOUT_STREAM, GRAD_NORM_STREAM, VAL_STREAM = 0, 1, 2, 3


def step_generator(seed: int, step: int, stream: int, device: torch.device | str) -> torch.Generator:
    """A generator seeded by (seed, step, stream) alone, the counterpart of
    the JAX trainer's ``fold_in(key, step)``: a run resumed at step k draws
    what an uninterrupted run draws at step k, and one stream's use does not
    move another's."""
    mixed = np.random.SeedSequence([seed, step, stream]).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(mixed))


class Trainer:
    """Builds the train, eval and grad-norm steps of one model on one
    device (the card unless the caller passes ``device="cpu"``), data
    parallel over ``mesh`` when it has more than one rank. Dropout and the
    flash seeds draw from the ``torch.Generator`` each step is given, the
    same on every rank."""

    def __init__(self, cfg: Config, device: torch.device | str | None = None, mesh: MeshSpec | None = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.mesh = mesh if mesh is not None else MeshSpec()

    def new_model(self) -> torch.nn.Module:
        """The trainer's model, uninitialized, on its device."""
        return CtRLSim(self.cfg, device=self.device)

    def init_state(self, generator: torch.Generator) -> TrainState:
        """A freshly initialized model (``params.init_params``), the same on
        every rank, and its optimizer."""
        model = self.new_model()
        init_params(model, generator)
        return self.state_from_model(self.mesh.replicate(model))

    def microbatch_losses(self, model: torch.nn.Module, micro: dict, generator: torch.Generator | None,
                          draws=None, den_reduce=None):
        """The training losses of one microbatch (dropout on). Only the
        diffusion loss takes replayed draws (``CTGTrainer``)."""
        if draws is not None:
            raise ValueError("this trainer's loss draws from its generator alone: draws are CTGTrainer's")
        return compute_loss(self.cfg, micro, model(micro, deterministic=False, generator=generator), den_reduce)

    def state_from_model(self, model: CtRLSim, step: int = 0) -> TrainState:
        return TrainState(step=step, model=model, optimizer=make_optimizer(self.cfg, model))

    # ------------------------------------------------------------------
    # data parallelism: every rank holds the global batch

    @property
    def _sharded(self) -> bool:
        return self.mesh.world > 1

    def _local(self, batch, generator=None, draws=None):
        """This rank's rows of a global (micro)batch, the generator its
        forward draws from (a ``RowGenerator`` of its rows; None stands for
        the device's default generator), its draws and the denominator
        reduction; the arguments themselves on one rank."""
        if not self._sharded:
            return batch, generator, draws, None
        n = len(next(iter(batch.values())))
        rows = self.mesh.rows(n)
        if generator is None and self.device.type == "cpu":
            generator = torch.default_generator
        elif generator is None:
            generator = torch.cuda.default_generators[torch.cuda.current_device() if self.device.index is None
                                                      else self.device.index]
        draws = None if draws is None else self.mesh.shard_batch(draws)
        return (self.mesh.shard_batch(batch), RowGenerator(generator, rows.start, rows.stop - rows.start, n), draws,
                self._all_reduced)

    def _all_reduced(self, x: torch.Tensor) -> torch.Tensor:
        return self.mesh.all_reduce(x.detach().clone())

    def _global(self, losses):
        """The ranks' shares of a loss tuple (or dict), summed: the global losses."""
        if not self._sharded:
            return losses
        if isinstance(losses, dict):
            return dict(zip(losses, self._all_reduced(torch.stack(list(losses.values())))))
        return type(losses)(*self._all_reduced(torch.stack(list(losses))))

    def _reduce_grads(self, grads: list[torch.Tensor]) -> None:
        """The gradients summed over the ranks, in place (one flat buffer)."""
        if not self._sharded:
            return
        flat = torch.cat([g.reshape(-1) for g in grads])
        self.mesh.all_reduce(flat)
        for g, part in zip(grads, flat.split([g.numel() for g in grads])):
            g.copy_(part.view_as(g))

    # ------------------------------------------------------------------

    def make_train_step(self):
        cfg = self.cfg
        accum = max(cfg.train.accum_steps, 1)
        schedule = lr_schedule(cfg)

        def train_step(state: TrainState, batch: dict, generator: torch.Generator | None, draws=None):
            """One optimizer update from the (global) batch, split into
            ``accum`` microbatches whose gradients are averaged; returns the
            state and the losses of the last microbatch. ``draws[i]``, where
            given, are microbatch i's draws (``CTGTrainer``)."""
            model, opt = state.model, state.optimizer
            model.train()
            opt.zero_grad(set_to_none=True)
            for i, micro in enumerate(_split(batch, accum)):
                local, gen, d, den_reduce = self._local(micro, generator, None if draws is None else draws[i])
                losses = self.microbatch_losses(model, local, gen, d, den_reduce)
                (losses.total / accum).backward()
            # a parameter the family's layout leaves unused (IL's and
            # trajeglish's RTG embeddings) gets a zero gradient, so AdamW
            # decays it as optax does instead of skipping it
            for p in model.parameters():
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            grads = [p.grad for p in model.parameters()]
            self._reduce_grads(grads)
            state.grad_norm = clip_by_global_norm(grads, cfg.train.gradient_clip_val)
            for group in opt.param_groups:
                group["lr"] = schedule(state.step)
            opt.step()
            state.step += 1
            return state, self._global(type(losses)(*(x.detach() for x in losses)))

        return train_step

    def make_grad_norm_fn(self):
        """Per-parameter gradient 2-norms and the global norm of one
        batch's loss (the reference's on_before_optimizer_step payload);
        the parameters' own gradients are left as they were."""

        def fn(state: TrainState, batch: dict, generator: torch.Generator | None) -> dict:
            model = state.model
            named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
            local, gen, _, den_reduce = self._local(batch, generator)
            loss = self.microbatch_losses(model, local, gen, den_reduce=den_reduce).total
            grads = torch.autograd.grad(loss, [p for _, p in named], allow_unused=True)
            kept = [(n, g) for (n, _), g in zip(named, grads) if g is not None]
            self._reduce_grads([g for _, g in kept])
            return grad_norms(dict(kept))

        return fn

    def make_eval_step(self):
        cfg = self.cfg

        @torch.no_grad()
        def eval_step(state: TrainState, batch: dict) -> LossDict:
            state.model.eval()
            local, _, _, den_reduce = self._local(batch)
            return self._global(compute_loss(cfg, local, state.model(local, deterministic=True), den_reduce))

        return eval_step


class CTGTrainer(Trainer):
    """Trainer of the CTG++ diffusion baseline (counterpart of the JAX
    package's ``CTGTrainer``; reference models/ctg_plus_plus.py:117-158 +
    cfgs/train/ctg_plus_plus.yaml): the AdamW partition, schedule and
    clipping of ``Trainer``, lr 2e-4 and accumulation 2 from the
    ``ctg_plus_plus`` preset. The loss is the diffusion loss (plus the RTG
    head's when ``model.use_rtg``); a step reports its last microbatch's
    losses, as the JAX step's scan carry does. Each microbatch's diffusion
    steps and noise come from the generator, or from ``draws[i]`` =
    (steps [b], noise) given to the train step."""

    def new_model(self) -> torch.nn.Module:
        from ctrl_sim_tpu_torch.models.ctg_plus_plus import CTGPlusPlus

        return CTGPlusPlus(self.cfg, device=self.device)

    def microbatch_losses(self, model, micro, generator, draws=None, den_reduce=None):
        return model.loss(micro, generator, draws, den_reduce)

    def make_eval_step(self):
        """Validation: the sampled futures' state and action MSE, the
        reference's checkpoint-selection metric (models/ctg_plus_plus.py:79-107)."""

        @torch.no_grad()
        def eval_step(state: TrainState, batch: dict, generator: torch.Generator | None,
                      noise_override=None) -> dict:
            state.model.eval()
            local, gen, _, den_reduce = self._local(batch, generator)
            noise = noise_override
            if noise is not None and self._sharded:  # (x0 noise [B, ...], step noises [n_eval, B, ...])
                rows = self.mesh.rows(noise[0].shape[0])
                noise = (noise[0][rows], noise[1][:, rows])
            return self._global(state.model.validation_mse(local, gen, noise, den_reduce))

        return eval_step


def trainer_for(cfg: Config, device: torch.device | str | None = None, mesh: MeshSpec | None = None) -> Trainer:
    """The trainer of the config's model family."""
    return (CTGTrainer if cfg.model.ctg_plus_plus else Trainer)(cfg, device=device, mesh=mesh)
