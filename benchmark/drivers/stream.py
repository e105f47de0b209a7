"""Traffic of kind ``stream``: the port's streaming closed-loop rollout
(``rollout/streaming.py:run_streaming``), one chunk of the cell's scenes
after another.

Set-up builds the scenes on the host, moves them to the card, builds the
model with the benchmark's seeded weights and runs one chunk to warm up
every shape and kernel. The window runs chunks back to back until
``--seconds`` have passed; chunk i samples from a generator seeded by (run
seed, i). The check judges one of the window's first ``check.among_first``
chunks, drawn from the seed: only those outputs are kept, so every run
holds the same memory whatever number of chunks its window completes.
"""

from __future__ import annotations

import gc
import sys
import time

import numpy as np
import torch

from benchmark import harness
from benchmark.reference import check_stream, weights


class Run:
    def __init__(self, config: dict, traffic: dict, seed: int, device: str = "cuda", extra: dict | None = None):
        from ctrl_sim_tpu_torch import config as program_config
        from ctrl_sim_tpu_torch.data import stack_scenarios, to_torch
        from ctrl_sim_tpu_torch.data.transforms import get_tilt_logits
        from ctrl_sim_tpu_torch.models.ctrl_sim import CtRLSim

        self.config, self.traffic, self.seed, self.device, self.extra = config, traffic, seed, device, extra
        self.cfg = harness.build_config(program_config, config, traffic, extra)
        if extra is None:
            harness.check_sizes(self.cfg, config["sizes"])
        self.scenes = harness.scenes(config, traffic, seed, extra)
        self.scenario = to_torch(stack_scenarios([harness.to_program(s) for s in self.scenes], self.cfg), device)
        self.controlled = self.scenario.moving & self.scenario.agent_valid
        self.model = CtRLSim(self.cfg, device=device)
        weights.load(self.model, weights.make(self.model, seed, device))
        self.model.eval()
        self.tilt = get_tilt_logits(*traffic["tilt"], self.cfg.waymo, device=device)
        self.outputs: list = []  # the first ``among_first`` chunks' outputs
        self.finite: list = []  # each chunk's positions all finite (device booleans)
        self.chunk(weights.derive(seed, "warmup"))

    def chunk(self, chunk_seed: int):
        from ctrl_sim_tpu_torch.rollout.streaming import run_streaming

        gen = torch.Generator(device=self.device).manual_seed(chunk_seed)
        return run_streaming(self.cfg, self.model, self.scenario, self.controlled, gen, self.tilt)

    def measure(self, seconds: float, spans, trace=None) -> dict:
        """Chunks back to back for ``seconds``. The counts hold the env-steps
        of every chunk and the time from the window's start to the end of
        the last; their rate closes the window's line on standard error."""
        harness.sync(self.device)
        if trace is not None:
            trace.start()
        start = time.perf_counter()
        with spans.span("bench.window"):
            while time.perf_counter() - start < seconds:
                with spans.span("bench.chunk"):
                    out = self.chunk(weights.derive(self.seed, "chunks", len(self.finite)))
                self.finite.append(torch.isfinite(out.position).all())
                if len(self.outputs) < self.traffic["check"]["among_first"]:
                    self.outputs.append(out)
                del out
            harness.sync(self.device)
        wall = time.perf_counter() - start
        if trace is not None:
            trace.stop()
        chunks = len(self.finite)
        env_steps = chunks * len(self.scenes) * self.cfg.sim.steps
        failed = chunks - int(torch.stack(self.finite).sum())
        print(f"window chunks {chunks} env_steps {env_steps} seconds {wall!r} env_steps_per_s {env_steps / wall!r}",
              file=sys.stderr)
        return {"attempted": chunks, "failed": failed,
                "counts": {"chunks": chunks, "env_steps": env_steps, "window_s": wall},
                "metrics": {"env_steps_per_s": env_steps / wall}}

    def release(self) -> None:
        """Keeps the chunk that the check judges and frees the rest of the
        port's state."""
        rng = np.random.default_rng(np.random.SeedSequence([int(self.seed), weights.STREAMS["check"]]))
        self.judged = int(rng.integers(len(self.outputs)))
        self.lanes = np.sort(rng.choice(len(self.scenes), size=self.traffic["check"]["lanes"], replace=False))
        lanes = torch.as_tensor(self.lanes, device=self.device)
        self.judged_out = type(self.outputs[self.judged])(
            *(x[:, lanes] if x.dim() > 2 else x[lanes] for x in self.outputs[self.judged]))
        del self.model, self.scenario, self.outputs, self.finite
        gc.collect()
        if self.device == "cuda":
            torch.cuda.empty_cache()

    def check(self, limits: dict) -> dict:
        ref = check_stream.teacher_forced(self.config, self.traffic, self.seed, self.scenes, self.lanes,
                                          weights.derive(self.seed, "chunks", self.judged), self.judged_out,
                                          self.device, extra=self.extra)
        return check_stream.compare(ref, self.judged_out, limits)
