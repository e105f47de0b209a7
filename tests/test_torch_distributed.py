"""The port's multi-device learner and rollout (``parallel/mesh.py``, the
trainers with a mesh, ``train.py --distributed``) on the CPU.

One spawn of 2 gloo ranks (tests/torch_distributed_worker.py, in the pattern
of tests/distributed_worker.py) reports to several tests: the data-parallel
CtRL-Sim step (``accum_steps`` 2, dropout and goal dropout on; and with
``model.remat``, whose backward recomputes the dropout), its eval
step and grad-norm function, the CTG++ step and its validation, and the
env-sharded ``run_closed_loop``, each held to the port's single-process run
within 1e-6 in f32 (relative to max(1, |x|); gradients relative to their
largest). The single-process runs are held to the JAX package by the other
test files. Then ``train.py --distributed`` under torchrun, and the mesh's
pieces on one process."""

import json
import os
import socket
import subprocess
import sys

import pytest
import torch

from ctrl_sim_tpu_torch.parallel import MeshSpec, make_mesh
from ctrl_sim_tpu_torch.models.draws import RowGenerator, plain, rand_rows, randint_rows, randn_rows, row_offset

torch.set_num_threads(2)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_WORKER = os.path.join(os.path.dirname(__file__), "torch_distributed_worker.py")
TOL = 1e-6
TOY_TRAIN = [
    "model.hidden_dim=32", "model.num_heads=2", "model.dim_feedforward=64", "model.num_decoder_layers=1",
    "model.num_transformer_encoder_layers=1", "waymo.train_context_length=4", "waymo.max_num_agents=8",
    "waymo.max_num_road_polylines=8", "waymo.max_num_road_pts_per_polyline=10", "sim.steps=12",
    "train.global_batch_size=5", "train.accum_steps=2",
]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env(**extra) -> dict:
    env = dict(os.environ, PYTHONPATH=_REPO, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    env.update({k: str(v) for k, v in extra.items()})
    return env


@pytest.fixture(scope="module")
def report(tmp_path_factory):
    out = tmp_path_factory.mktemp("dist") / "report.json"
    port = _free_port()
    procs = [
        subprocess.Popen([sys.executable, _WORKER, str(out)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True, env=_env(RANK=r, LOCAL_RANK=r, WORLD_SIZE=2, MASTER_ADDR="127.0.0.1",
                                             MASTER_PORT=port))
        for r in range(2)
    ]
    logs = [p.communicate(timeout=600)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"rank exited {p.returncode}:\n{log[-4000:]}"
    return json.loads(out.read_text())


def _held(rep: dict, keys) -> None:
    for key in keys:
        assert rep[key] <= TOL, (key, rep[key])


@pytest.mark.parametrize("case", ["ctrl_sim", "ctrl_sim_remat"])
def test_ctrl_sim_step_equals_single_process(report, case):
    rep = report[case]
    _held(rep, ("losses", "grads", "grad_norm", "params", "eval", "grad_norms"))
    assert rep["params_held"] > 0.4 and 5.0 < rep["loss"] < 100.0


def test_ctg_step_equals_single_process(report):
    rep = report["ctg_plus_plus"]
    _held(rep, ("losses", "grads", "grad_norm", "params", "eval"))
    assert rep["params_held"] > 0.4


def test_sharded_closed_loop_equals_single_process(report):
    rep = report["closed_loop"]
    assert rep.pop("distinct_rank_draws")  # each rank drew from a stream of its own
    assert set(rep) >= {"position", "heading", "reward8", "rtgs", "controlled_mask"}
    _held(rep, rep)


def test_train_cli_under_torchrun(tmp_path):
    """``python -m torch.distributed.run --nproc_per_node 2 -m
    ctrl_sim_tpu_torch.train --distributed --device cpu``: rank 0 alone
    prints and writes the checkpoint, the global batch of 5 is rounded to
    4 for 2 ranks, and a second run resumes on every rank."""
    base = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "2",
            "-m", "ctrl_sim_tpu_torch.train", "--distributed", "--device", "cpu", "--synthetic", "4",
            "--synthetic_agents", "6", "--log_every", "1", "--save_dir", str(tmp_path)]
    base += [x for o in TOY_TRAIN for x in ("-o", o)]
    run = subprocess.run(base + ["--steps", "2"], capture_output=True, text=True, env=_env(), timeout=600)
    assert run.returncode == 0, run.stdout[-3000:] + run.stderr[-3000:]
    out = run.stdout
    assert out.count("[train] devices=2 batch=4 ") == 1 and "rounding global batch to 4" in out
    assert out.count("[train] step=2 ") == 1 and out.count("[train] done at step 2") == 1
    assert (tmp_path / "step_2.pt").exists() and len((tmp_path / "metrics.jsonl").read_text().splitlines()) == 2
    again = subprocess.run(base + ["--steps", "3"], capture_output=True, text=True, env=_env(), timeout=600)
    assert again.returncode == 0, again.stdout[-3000:] + again.stderr[-3000:]
    assert again.stdout.count("resuming from step 2") == 1 and (tmp_path / "step_3.pt").exists()


def test_mesh_without_a_process_group_is_one_by_one():
    mesh = make_mesh()
    assert mesh == MeshSpec(1, 1, 0) and mesh.world == 1
    batch = {"x": torch.arange(6.0), "y": (torch.ones(6, 2), torch.zeros(6))}
    assert mesh.shard_batch(batch)["x"] is not None and torch.equal(mesh.shard_batch(batch)["x"], batch["x"])
    assert mesh.gather(batch) is batch and mesh.replicate(batch) is batch
    with pytest.raises(ValueError):
        make_mesh(data=2)


def test_mesh_rows_of_each_rank():
    rows = [MeshSpec(data=2, model=2, rank=r).rows(8) for r in range(4)]
    assert rows == [slice(0, 4), slice(0, 4), slice(4, 8), slice(4, 8)]  # the model axis replicates
    sharded = MeshSpec(data=4, rank=3).shard_batch({"x": torch.arange(8), "s": torch.tensor(1.0)})
    assert sharded["x"].tolist() == [6, 7] and float(sharded["s"]) == 1.0
    with pytest.raises(ValueError, match="does not split"):
        MeshSpec(data=3, rank=0).rows(8)


def test_row_draws_are_the_global_draws_cut_to_the_rank():
    """From ``RowGenerator(g, offset, rows, total)`` a draw for a leading
    axis of ``rows`` (or a multiple of it, batch-major) is g's draw of the
    global shape, cut to the rank's rows; from a plain generator, a plain
    draw. A RowGenerator is no torch.Generator: a direct draw raises."""
    def rows(seed, offset, n, total):
        return RowGenerator(torch.Generator().manual_seed(seed), offset, n, total)

    for draw, full in ((rand_rows, torch.rand), (randn_rows, torch.randn)):
        want = full((6, 3, 2), generator=torch.Generator().manual_seed(5))
        got = draw((2, 3, 2), rows(5, 2, 2, 6))
        flat = draw((4, 2), rows(5, 2, 2, 6))  # [rows x 2, ...] batch-major
        torch.testing.assert_close(got, want[2:4], rtol=0, atol=0)
        torch.testing.assert_close(flat, full((12, 2), generator=torch.Generator().manual_seed(5))[4:8],
                                   rtol=0, atol=0)
    assert row_offset(rows(0, 2, 2, 6), 2) == 2 and row_offset(rows(0, 2, 2, 6), 6) == 6
    ints = randint_rows(0, 100, (1,), rows(6, 1, 1, 3))
    with pytest.raises(ValueError, match="not a multiple"):
        rand_rows((3, 2), rows(0, 2, 2, 6))
    with pytest.raises(TypeError):
        torch.rand(2, generator=rows(0, 2, 2, 6))
    assert int(ints) == int(torch.randint(0, 100, (3,), generator=torch.Generator().manual_seed(6))[1])
    g = torch.Generator().manual_seed(7)
    assert row_offset(g, 5) == 0 and plain(g) is g and plain(RowGenerator(g, 0, 1, 2)) is g
    torch.testing.assert_close(rand_rows((3,), torch.Generator().manual_seed(7)),
                               torch.rand(3, generator=torch.Generator().manual_seed(7)), rtol=0, atol=0)


def test_flash_batch_offset_keys_dropout_on_the_global_row():
    """The plain K3/K4 with ``batch_offset`` o on rows [o, o + B) of a
    launch gives those rows' output of the whole launch, dropout included
    (the kernels take the same offset; chip_smoke.py holds them to it)."""
    from ctrl_sim_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator().manual_seed(8)
    q, k, v = (torch.randn(6, 24, 16, generator=gen) for _ in range(3))
    spec = fa.MaskSpec(4, 3, 0, False, None)
    full = fa.flash_mha(q, k, v, spec, 2, 0.3, 77)
    part = fa.flash_mha(q[2:5], k[2:5], v[2:5], spec, 2, 0.3, 77, batch_offset=2)
    torch.testing.assert_close(part, full[2:5], rtol=0, atol=0)
    assert not torch.equal(fa.flash_mha(q[2:5], k[2:5], v[2:5], spec, 2, 0.3, 77), full[2:5])
