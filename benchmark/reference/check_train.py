"""The train cell's check: the reference's steps against the port's.

The reference is the benchmark's frozen copy of the model, losses and data
pipeline (``sim``), in float32 with plain attention. It replays the same
scenes through its own physics into its own store, loads the same seeded
weights, draws batches and dropout from generators seeded as the port's
were, and takes the same optimizer recipe (AdamW over the decayed and the
other leaves, clipping at the global norm, the warm-up schedule read
before each update). A microbatch runs in blocks of rows, each drawing its
dropout at the microbatch's shape and keeping its rows, with the losses'
denominators those of the whole microbatch, so the blocks add up to the
microbatch's gradient.

Two stretches are followed: the first steps of set-up, from the seed; and
the window's first steps, from the state that began them (the port's
parameters, AdamW's moments, the step index and the generators' states, as
the train driver copied them at the end of set-up): that stretch starts
from the program's own state, and the first one checks the start.

Compared, by the worst leaf where a number is per leaf (``window_`` before
the names of the second stretch):
- ``loss_gap``: each step's loss, |port - reference| / |reference|;
- ``grad_gap``: the first gradient's norm as the optimizer got it, the gap
  between the two norms against the larger of the reference leaf's norm
  and the median leaf's;
- ``change_gap``: the parameters' change over the checked steps, the same.
Leaves whose reference gradient lies under a thousandth of the median
leaf's are left out of the last two: Adam moves them by round-off alone.
"""

from __future__ import annotations

import torch

from benchmark import harness
from benchmark.reference import weights

BETAS, EPS = (0.9, 0.999), 1e-8
NEGLIGIBLE_GRAD = 1e-3  # of the median leaf's gradient norm


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under one scale a tensor (its largest
    magnitude at 448), back in x's dtype: the control's precision. The
    gradient passes the rounding unchanged, as in training with float8
    products over float32 master weights."""
    scale = x.detach().abs().amax().clamp_min(1e-30) / 448.0
    rounded = (x.detach() / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale
    return x + (rounded - x.detach())


def _model(cfg, seed: int, device, quantize: bool):
    from benchmark.reference.sim.models.ctrl_sim import CtRLSim
    from benchmark.reference.sim.models.layers import Dense

    model = CtRLSim(cfg, device=device)
    weights.load(model, weights.make(model, seed, device))
    if quantize:
        for module in model.modules():
            if isinstance(module, Dense):
                module.round_operands = fp8_round
    return model


def _optimizer(cfg, model):
    from benchmark.reference.sim.models.layers import Dense

    decay = {f"{n}.weight" for n, m in model.named_modules() if isinstance(m, Dense)}
    named = list(model.named_parameters())
    groups = [{"params": [p for n, p in named if n in decay], "weight_decay": cfg.train.weight_decay},
              {"params": [p for n, p in named if n not in decay], "weight_decay": 0.0}]
    return torch.optim.AdamW(groups, lr=0.0, betas=BETAS, eps=EPS)


def _lr(cfg, step: int) -> float:
    warmup, max_steps, lr = cfg.train.warmup_steps, cfg.train.max_steps, cfg.train.lr
    if step < warmup:
        return lr * step / warmup
    return lr * max(0.0, (max_steps - step) / (max_steps - warmup))


def _microbatch(cfg, model, micro: dict, generator: torch.Generator, block: int, accum: int) -> torch.Tensor:
    """Loss of one microbatch, its gradient added to the parameters', in
    blocks of ``block`` rows."""
    from benchmark.reference.sim.models.ctrl_sim import DecoderOutput, compute_loss
    from benchmark.reference.sim.models.draws import RowGenerator

    agent_states = micro["agent_states"]
    B, A, T, _ = agent_states.shape
    wc, mc = cfg.waymo, cfg.model
    zeros = lambda *s: torch.zeros((B, A, T) + s, device=agent_states.device)  # noqa: E731
    dens = []
    compute_loss(cfg, micro, DecoderOutput(zeros(wc.action_dim),
                                           zeros(wc.rtg_discretization * 3) if mc.predict_rtg else None,
                                           zeros(wc.train_context_length * 2) if mc.predict_future_states else None),
                 den_reduce=lambda d: dens.append(d) or d)
    before = generator.get_state()
    total = torch.zeros((), device=agent_states.device)
    for lo in range(0, B, block):
        rows = min(block, B - lo)
        generator.set_state(before)
        local = {k: v[lo:lo + rows] for k, v in micro.items()}
        gen = RowGenerator(generator, lo, rows, B)
        losses = compute_loss(cfg, local, model(local, deterministic=False, generator=gen),
                              den_reduce=lambda d: dens[0])
        (losses.total / accum).backward()
        total = total + losses.total.detach()
    return total


def reference_store(config: dict, traffic: dict, scenes: list, device, extra: dict | None = None):
    """The reference's store: the cell's scenes replayed through its own
    physics."""
    from benchmark.reference.sim import config as ref_config
    from benchmark.reference.sim.data.store import ScenarioStore

    cfg = harness.build_config(ref_config, config, traffic, {**(extra or {}), **harness.REFERENCE_PRECISION})
    return ScenarioStore.from_scenes(cfg, scenes, device=device)


def reference_steps(config: dict, traffic: dict, seed: int, scenes: list, device, steps: int,
                    quantize: bool = False, extra: dict | None = None, store=None, start: dict | None = None) -> dict:
    """The reference's ``steps`` train steps on the cell's scenes and seed:
    each step's loss, the first clipped gradient's norms and the
    parameters' change, by leaf. From the seed's weights and fresh
    generators, or from ``start`` (parameters, AdamW's moments, the step
    index and the data and dropout generators' states); ``quantize`` rounds
    every dense layer's operands to float8 (the control)."""
    from benchmark.reference.sim import config as ref_config

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = harness.build_config(ref_config, config, traffic, {**(extra or {}), **harness.REFERENCE_PRECISION})
    store = store or reference_store(config, traffic, scenes, device, extra)
    model = _model(cfg, seed, device, quantize)
    opt = _optimizer(cfg, model)
    named = list(model.named_parameters())
    data_gen = torch.Generator(device=device).manual_seed(weights.derive(seed, "data"))
    dropout_gen = torch.Generator(device=device).manual_seed(weights.derive(seed, "dropout"))
    first = 0
    if start is not None:
        if start["names"] != [n for n, _ in named]:
            raise ValueError("the port's and the reference's parameters differ")
        first = start["step"]
        with torch.no_grad():
            for (_, p), value, m, v in zip(named, start["param"], start["exp_avg"], start["exp_avg_sq"]):
                p.copy_(value)
                opt.state[p] = {"step": torch.tensor(float(first)), "exp_avg": m.clone(), "exp_avg_sq": v.clone()}
        data_gen.set_state(start["generators"][0])
        dropout_gen.set_state(start["generators"][1])
    begin = [p.detach().clone() for _, p in named]
    accum, block = max(cfg.train.accum_steps, 1), traffic["check"]["row_block"]
    losses, grads = [], None
    model.train()
    for step in range(first, first + steps):
        batch = store.sample_batch(data_gen, cfg.train.global_batch_size)
        opt.zero_grad(set_to_none=True)
        for part in zip(*(v.chunk(accum) for v in batch.values())):
            total = _microbatch(cfg, model, dict(zip(batch, part)), dropout_gen, block, accum)
        for _, p in named:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        with torch.no_grad():
            gs = [p.grad for _, p in named]
            norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in gs]))
            scale = torch.where(norm < cfg.train.gradient_clip_val, torch.ones_like(norm),
                                cfg.train.gradient_clip_val / norm)
            for g in gs:
                g.mul_(scale)
            if step == first:
                grads = torch.stack([torch.linalg.vector_norm(g) for g in gs])
        for group in opt.param_groups:
            group["lr"] = _lr(cfg, step)
        opt.step()
        losses.append(total)
    change = torch.stack([torch.linalg.vector_norm(p.detach() - p0) for (_, p), p0 in zip(named, begin)])
    return {"names": [n for n, _ in named], "loss": torch.stack(losses).cpu(), "grad": grads.cpu(),
            "change": change.cpu()}


def left_out(want: dict) -> int:
    """Leaves whose reference gradient lies under ``NEGLIGIBLE_GRAD`` of
    the median leaf's: their change is Adam's round-off alone."""
    return int((want["grad"] < NEGLIGIBLE_GRAD * want["grad"].median()).sum())


def _leaf_gap(got: torch.Tensor, want: torch.Tensor, kept: torch.Tensor) -> float:
    floor = want[kept].median()
    return float(((got - want).abs() / torch.maximum(want, floor))[kept].max())


def compare(got: dict, want: dict, limits: dict, prefix: str = "") -> dict:
    """Each compared number, named with ``prefix``, beside its limit; a
    number that the cell's limits leave out is not compared."""
    if got["names"] != want["names"]:
        raise ValueError("the port's and the reference's parameters differ")
    kept = want["grad"] >= NEGLIGIBLE_GRAD * want["grad"].median()  # the complement of left_out
    numbers = {
        "loss_gap": float(((got["loss"] - want["loss"]).abs() / want["loss"].abs()).max()),
        "grad_gap": _leaf_gap(got["grad"], want["grad"], kept),
        "change_gap": _leaf_gap(got["change"], want["change"], kept),
    }
    return {prefix + name: {"value": value, "limit": limits[prefix + name]} for name, value in numbers.items()
            if prefix + name in limits}
