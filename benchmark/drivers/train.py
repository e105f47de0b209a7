"""Traffic of kind ``train``: the port's training step on batches that its
scenario store samples.

Set-up replays the cell's scenes through physics into the store, builds the
trainer's model with the benchmark's seeded weights and its optimizer, and
drives that same train step through its first ``checked_steps`` steps: they
warm up every shape and kernel, and their losses, the first gradient (as
AdamW holds it after one step) and the parameters' change are kept for the
check. The window then runs steps back to back until ``--seconds`` have
passed, each a fresh batch, and at least ``checked_steps`` of them. The
check follows the window's first ``checked_steps`` steps as well: set-up
copies the train state that begins them (parameters, AdamW's moments, the
step and the generators' states), and the window copies AdamW's first
moment after its first step and the parameters after its last checked one,
two copies in all; their losses, the first one's gradient (from the change
of the first moment over it) and the parameters' change are kept.
"""

from __future__ import annotations

import contextlib
import gc
import time

import torch

from benchmark import harness
from benchmark.reference import check_train, weights


class Run:
    def __init__(self, config: dict, traffic: dict, seed: int, device: str = "cuda", extra: dict | None = None):
        from ctrl_sim_tpu_torch import config as program_config
        from ctrl_sim_tpu_torch.data.store import ScenarioStore
        from ctrl_sim_tpu_torch.training import Trainer

        self.config, self.traffic, self.seed, self.device, self.extra = config, traffic, seed, device, extra
        self.cfg = harness.build_config(program_config, config, traffic, extra)
        if extra is None:
            harness.check_sizes(self.cfg, config["sizes"])
        self.scenes = harness.scenes(config, traffic, seed, extra)
        self.store = ScenarioStore.from_scenes(self.cfg, [harness.to_program(s) for s in self.scenes],
                                               device=device)
        trainer = Trainer(self.cfg, device=device)
        model = trainer.new_model()
        weights.load(model, weights.make(model, seed, device))
        self.state = trainer.state_from_model(model)
        self.train_step = trainer.make_train_step()
        self.data_gen = torch.Generator(device=device).manual_seed(weights.derive(seed, "data"))
        self.dropout_gen = torch.Generator(device=device).manual_seed(weights.derive(seed, "dropout"))
        self.checked = self._first_steps(traffic["checked_steps"])
        self.outputs: list[torch.Tensor] = []
        self.window_start = self._snapshot()
        self.moment_after_first = [torch.empty_like(p) for p in self.window_start["param"]]
        self.param_after_checked = [torch.empty_like(p) for p in self.window_start["param"]]

    def step(self, spans=None):
        """One step on a fresh batch; returns its loss (the last
        microbatch's, as the train step reports it)."""
        with spans.span("bench.batch") if spans else contextlib.nullcontext():
            batch = self.store.sample_batch(self.data_gen, self.cfg.train.global_batch_size)
        with spans.span("bench.train_step") if spans else contextlib.nullcontext():
            self.state, losses = self.train_step(self.state, batch, self.dropout_gen)
        return losses.total

    def _first_steps(self, n: int) -> dict:
        """Steps 1..n of the one train state, with what the check compares."""
        params = list(self.state.model.named_parameters())
        start = [p.detach().clone() for _, p in params]
        losses, grads = [], None
        for i in range(n):
            losses.append(self.step().detach().float())
            if i == 0:
                opt = self.state.optimizer
                beta1 = opt.param_groups[0]["betas"][0]
                grads = torch.stack([torch.linalg.vector_norm(opt.state[p]["exp_avg"]) / (1.0 - beta1)
                                     if "exp_avg" in opt.state.get(p, {}) else torch.zeros((), device=p.device)
                                     for _, p in params])
        change = torch.stack([torch.linalg.vector_norm(p.detach() - p0) for (_, p), p0 in zip(params, start)])
        return {"names": [n for n, _ in params], "loss": torch.stack(losses).cpu(), "grad": grads.cpu(),
                "change": change.cpu()}

    def _snapshot(self) -> dict:
        """A copy of the train state: the parameters, AdamW's two moments
        (zeros before a first update), the step index and the states of the
        data and dropout generators."""
        params = [p for _, p in self.state.model.named_parameters()]
        opt = self.state.optimizer
        return {"names": [n for n, _ in self.state.model.named_parameters()],
                "param": [p.detach().clone() for p in params],
                "exp_avg": [_moment(opt, p, "exp_avg").clone() for p in params],
                "exp_avg_sq": [_moment(opt, p, "exp_avg_sq").clone() for p in params],
                "step": self.state.step, "generators": [self.data_gen.get_state(), self.dropout_gen.get_state()]}

    def measure(self, seconds: float, spans, trace=None) -> dict:
        """Steps back to back for ``seconds``, and at least as many as the
        check follows; each step's time from CUDA events read after the
        window, the rate from all of its time."""
        harness.sync(self.device)
        if trace is not None:
            trace.start()
        marks = harness.Marks(self.device)
        checked = self.traffic["checked_steps"]
        params = list(self.state.model.parameters())
        values = [p.detach() for p in params]
        start = time.perf_counter()
        marks.mark()
        with spans.span("bench.window"):
            while time.perf_counter() - start < seconds or len(self.outputs) < checked:
                self.outputs.append(self.step(spans).detach())
                if len(self.outputs) == 1:
                    opt = self.state.optimizer
                    torch._foreach_copy_(self.moment_after_first, [_moment(opt, p, "exp_avg") for p in params])
                if len(self.outputs) == checked:
                    torch._foreach_copy_(self.param_after_checked, values)
                marks.mark()
            harness.sync(self.device)
        wall = time.perf_counter() - start
        if trace is not None:
            trace.stop()
        steps = len(self.outputs)
        step_ms = marks.intervals_ms()
        failed = int((~torch.isfinite(torch.stack(self.outputs))).sum())
        self.window_checked = self._window_steps(checked)
        return {"attempted": steps, "failed": failed, "counts": {"steps": steps},
                "metrics": {"train_step_ms": wall * 1e3 / steps, "train_step_ms_p90": harness.p90(step_ms)},
                "step_ms": step_ms}

    def _window_steps(self, n: int) -> dict:
        """The window's first ``n`` steps as the check compares them."""
        start = self.window_start
        beta1 = self.state.optimizer.param_groups[0]["betas"][0]
        grads = torch.stack([torch.linalg.vector_norm((m1 - beta1 * m0) / (1.0 - beta1))
                             for m0, m1 in zip(start["exp_avg"], self.moment_after_first)])
        change = torch.stack([torch.linalg.vector_norm(p1 - p0)
                              for p0, p1 in zip(start["param"], self.param_after_checked)])
        return {"names": start["names"], "loss": torch.stack(self.outputs[:n]).float().cpu(), "grad": grads.cpu(),
                "change": change.cpu()}

    def release(self) -> None:
        """Frees the port's train state before the reference runs."""
        del self.state, self.train_step, self.store, self.outputs, self.moment_after_first, self.param_after_checked
        gc.collect()
        if self.device == "cuda":
            torch.cuda.empty_cache()

    def check(self, limits: dict) -> dict:
        """The reference's first steps from the seed, and its steps from the
        state that began the window, against the program's: each number
        with its limit."""
        store = check_train.reference_store(self.config, self.traffic, self.scenes, self.device, self.extra)
        self.reference = check_train.reference_steps(self.config, self.traffic, self.seed, self.scenes,
                                                     self.device, self.traffic["checked_steps"], extra=self.extra,
                                                     store=store)
        self.window_reference = check_train.reference_steps(
            self.config, self.traffic, self.seed, self.scenes, self.device, self.traffic["checked_steps"],
            extra=self.extra, store=store, start=self.window_start)
        return {**check_train.compare(self.checked, self.reference, limits),
                **check_train.compare(self.window_checked, self.window_reference, limits, prefix="window_")}


def _moment(opt, p, key: str) -> torch.Tensor:
    """AdamW's moment ``key`` of ``p``: zeros before a first update."""
    state = opt.state.get(p, {})
    return state[key] if key in state else torch.zeros_like(p)
