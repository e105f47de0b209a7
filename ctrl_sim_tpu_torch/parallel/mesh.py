"""Process meshes over ``torch.distributed`` (port of
``ctrl_sim_tpu/parallel/mesh.py``).

The JAX package shards over one GSPMD mesh with a ``data`` axis for the
batch / env axis and a ``model`` axis that only replicates (the 256-d
model needs no tensor parallelism). Here each rank is one process, on one
card, and the same grid holds: a rank's data index is ``rank // model``,
the ranks of one data index hold the same rows, and the collectives sum
over every rank. JAX runs one process across all local chips; the port
runs one process per card, started by ``torchrun``.

- ``init_distributed`` joins the process group that torchrun's ``env://``
  variables describe (NCCL on a card, gloo on the CPU) and pins the rank's
  device.
- ``make_mesh`` builds the (data, model) grid over the world; without an
  initialised process group it is a 1 x 1 mesh whose methods do nothing.
- ``MeshSpec.shard_batch`` takes the rank's rows of a leading axis,
  ``replicate`` broadcasts from rank 0, ``gather`` all-gathers an axis and
  ``all_reduce`` sums. Only ``broadcast`` and ``all_reduce`` are used, the
  two collectives that gloo also runs on CUDA tensors, so two ranks can
  share one card.

A data-parallel train step draws every random number at the global
batch's shape and keeps the rank's rows (``models/draws.py``).
"""

from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist

from ctrl_sim_tpu_torch.device import resolve_device

Tensor = torch.Tensor


def init_distributed(backend: str | None = None, device: torch.device | str | None = None) -> torch.device:
    """Join the process group of torchrun's environment (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``) and
    return the rank's device: ``cuda:LOCAL_RANK`` unless ``device`` names
    another (``"cpu"``, or ``"cuda:0"`` for ranks that share one card).
    ``backend`` defaults to NCCL on a card and gloo on the CPU."""
    missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT") if k not in os.environ]
    if missing:
        raise RuntimeError(f"distributed runs are started by torchrun, which sets {', '.join(missing)}: "
                           "torchrun --nproc_per_node N -m ctrl_sim_tpu_torch.train --distributed ...")
    local = int(os.environ.get("LOCAL_RANK", "0"))
    if device is None or str(device) == "cuda":
        device = f"cuda:{local}"
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group(backend or ("nccl" if dev.type == "cuda" else "gloo"), init_method="env://",
                                rank=int(os.environ["RANK"]), world_size=int(os.environ["WORLD_SIZE"]))
    return dev


def _map(tree, fn):
    """``fn`` on every tensor of a tensor, dict, list, tuple (named too)
    or dataclass (a ``Scenario``); other leaves unchanged."""
    if isinstance(tree, Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map(v, fn) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn) for v in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{f.name: _map(getattr(tree, f.name), fn)
                                            for f in dataclasses.fields(tree)})
    return tree


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """A (data, model) grid of ``data * model`` ranks; this process is
    ``rank``."""

    data: int = 1
    model: int = 1
    rank: int = 0

    @property
    def world(self) -> int:
        return self.data * self.model

    @property
    def data_index(self) -> int:
        return self.rank // self.model

    def rows(self, n: int) -> slice:
        """This rank's rows of a leading axis of ``n``, which ``data`` must
        divide (as a GSPMD data sharding requires)."""
        if n % self.data:
            raise ValueError(f"a leading axis of {n} does not split over {self.data} data ranks")
        per = n // self.data
        return slice(self.data_index * per, (self.data_index + 1) * per)

    def shard_batch(self, tree):
        """The rank's rows of every tensor's leading axis (a dict, a tuple,
        a ``Scenario``...)."""
        return _map(tree, lambda x: x[self.rows(x.shape[0])] if x.dim() else x)

    def replicate(self, tree):
        """Every tensor as rank 0 has it (in place); a module's parameters
        and buffers too. Returns ``tree``."""
        if self.world == 1:
            return tree
        if isinstance(tree, torch.nn.Module):
            for t in [*tree.parameters(), *tree.buffers()]:
                dist.broadcast(t.data, src=0)
            return tree
        _map(tree, lambda x: dist.broadcast(x, src=0))
        return tree

    def all_reduce(self, x: Tensor) -> Tensor:
        """The sum over every rank, in place; returns ``x``."""
        if self.world > 1:
            dist.all_reduce(x, op=dist.ReduceOp.SUM)
        return x

    def gather(self, tree, axis: int = 0):
        """Every tensor with its ``axis`` gathered in data-rank order (the
        inverse of ``shard_batch`` on that axis). Runs on ``all_reduce``
        into a zeroed buffer that the first rank of each data index fills."""
        if self.world == 1:
            return tree

        def one(x: Tensor) -> Tensor:
            wide = x.to(torch.int32) if x.dtype == torch.bool else x.float() if x.dtype == torch.bfloat16 else x
            shape = list(wide.shape)
            n = shape[axis]
            shape[axis] = n * self.data
            buf = wide.new_zeros(shape)
            if self.rank % self.model == 0:
                buf.narrow(axis, self.data_index * n, n).copy_(wide)
            dist.all_reduce(buf, op=dist.ReduceOp.SUM)
            return buf.to(x.dtype)

        return _map(tree, one)

    def barrier(self) -> None:
        if self.world > 1:
            dist.barrier()


def make_mesh(data: int | None = None, model: int = 1) -> MeshSpec:
    """The (data, model) grid over the process group's world, a 1 x 1 mesh
    without one."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if data is None:
        data = world // model
    if data * model != world:
        raise ValueError(f"mesh {data}x{model} != {world} ranks")
    return MeshSpec(data=data, model=model, rank=rank)


# ---------------------------------------------------------------------------
# env-axis rollout sharding
# ---------------------------------------------------------------------------


def gather_rollout(mesh: MeshSpec, out):
    """A ``RolloutOutput`` of this rank's lanes as the whole batch's: the
    time-major streams gathered on their lane axis (1), the controlled mask
    on axis 0."""
    return type(out)(**{name: mesh.gather(value, axis=0 if name == "controlled_mask" else 1)
                        for name, value in out._asdict().items()})


def run_sharded(mesh: MeshSpec, run, cfg, model, scenario, controlled_mask: Tensor, generator, **kwargs):
    """The env-axis sharded rollout, the counterpart of running the JAX
    rollout under a ``data``-sharded scenario: each rank runs ``run``
    (``run_streaming`` or ``run_closed_loop``) on its rows of the scenes and
    of ``controlled_mask`` with its own ``generator`` (or ``sampler=``), and
    every rank gets the whole batch's output. A per-lane ``tilt_logits``
    [E, A, bins, 3] is sharded with the scenes."""
    tilt = kwargs.get("tilt_logits")
    if tilt is not None and tilt.dim() == 4:
        kwargs["tilt_logits"] = mesh.shard_batch(tilt)
    out = run(cfg, model, mesh.shard_batch(scenario), mesh.shard_batch(controlled_mask), generator, **kwargs)
    return gather_rollout(mesh, out)
