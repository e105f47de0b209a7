"""The port's training path held against the JAX package: the model's
training forward (heads within 1e-4), ``compute_loss`` (1e-5), the loss
gradients with dropout 0 (per parameter within 1e-4 of its max |grad|), the
weight-decay partition, the optimizer's details, and 20 trainer steps from
the executed reference's init in ``tests/goldens/reference_training.npz``
against its recorded losses (the bounds of test_training_parity.py:103).
Then the port's own pieces: accumulation, dropout and remat under one
generator, checkpoints, the ``train`` entry point on the CPU, and the
refusals of what is not ported."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ctrl_sim_tpu.data.datagen import generate_offline_data as jax_replay
from ctrl_sim_tpu.data.pipeline import build_train_batch as jax_build_batch
from ctrl_sim_tpu.models.ctrl_sim import compute_loss as jax_compute_loss
from ctrl_sim_tpu.models.decoder import DecoderOutput as JaxDecoderOutput
from ctrl_sim_tpu.training import trainer as jtrainer
from ctrl_sim_tpu.utils.torch_import import params_from_torch_state
from ctrl_sim_tpu_torch import train as torch_train
from ctrl_sim_tpu_torch.config import load_config as torch_load_config
from ctrl_sim_tpu_torch.config import preset
from ctrl_sim_tpu_torch.data.store import ScenarioStore
from ctrl_sim_tpu_torch.data.synthetic import synthetic_scenario
from ctrl_sim_tpu_torch.models.ctrl_sim import CtRLSim, compute_loss
from ctrl_sim_tpu_torch.models.decoder import DecoderOutput
from ctrl_sim_tpu_torch.ops.masks import multi_agent_causal_mask
from ctrl_sim_tpu_torch.params import from_flax_params
from ctrl_sim_tpu_torch.training import Trainer
from ctrl_sim_tpu_torch.training.checkpoint import CheckpointManager
from ctrl_sim_tpu_torch.training.trainer import _split, clip_by_global_norm, decay_names, lr_schedule
from torch_port_common import configs, jax_scenario, models, scenes, t2n

torch.set_num_threads(2)

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens", "reference_training.npz")
MODEL_KEYS = ("agent_states", "agent_types", "goals", "actions", "rtgs", "timesteps",
              "moving_agent_mask", "road_points", "road_types")
TOY_TRAIN = [  # train.main overrides: a tiny model on tiny scenes (contacts on, the default)
    "model.hidden_dim=32", "model.num_heads=2", "model.dim_feedforward=64",
    "model.num_decoder_layers=1", "model.num_transformer_encoder_layers=1", "waymo.train_context_length=4",
    "waymo.max_num_agents=8", "waymo.max_num_road_polylines=8", "waymo.max_num_road_pts_per_polyline=10",
    "sim.steps=12", "train.global_batch_size=4", "train.accum_steps=2",
]


@pytest.fixture(scope="module")
def setup():
    """The JAX model and the port's with the same weights, and one batch
    from the JAX data path (dropout off: the comparisons are deterministic)."""
    jcfg, tcfg = configs(**{"model.dropout": 0.0, "model.goal_dropout": 0.0})
    jm, params, tm = models(jcfg, tcfg)
    js = jax_scenario(scenes(jcfg, 3))
    jb = jax.jit(lambda k, s: jax_build_batch(jcfg, k, s, jax_replay(jcfg, s)))(jax.random.PRNGKey(0), js)
    jb = {k: jnp.asarray(jb[k]) for k in MODEL_KEYS}
    tb = {k: torch.tensor(np.asarray(v)) for k, v in jb.items()}
    return jcfg, tcfg, jm, params, tm, jb, tb


def test_forward_heads_match_jax(setup):
    jcfg, tcfg, jm, params, tm, jb, tb = setup
    want = jax.jit(lambda p, b: jm.apply(p, b, deterministic=True))(params, jb)
    with torch.no_grad():
        got = tm(tb, deterministic=True)
    for name in want._fields:
        np.testing.assert_allclose(t2n(getattr(got, name)), np.asarray(getattr(want, name)),
                                   atol=1e-4, rtol=1e-4, err_msg=name)


@pytest.mark.parametrize("over", [{}, {"model.supervise_moving": False}, {"model.local_frame_predictions": True}])
def test_compute_loss_matches_jax(setup, over):
    _, _, _, _, _, jb, tb = setup
    jcfg, tcfg = configs(**over)
    B, A, T = tb["actions"].shape
    rng = np.random.default_rng(0)
    preds = [rng.normal(size=(B, A, T, n)).astype(np.float32) * 3
             for n in (jcfg.waymo.action_dim, 3 * jcfg.waymo.rtg_discretization, 2 * T)]
    want = jax_compute_loss(jcfg, jb, JaxDecoderOutput(*(jnp.asarray(p) for p in preds)))
    got = compute_loss(tcfg, tb, DecoderOutput(*(torch.tensor(p) for p in preds)))
    for name, a, b in zip(want._fields, got, want):
        np.testing.assert_allclose(float(a), float(b), atol=1e-5, rtol=1e-6, err_msg=name)


def test_loss_gradients_match_jax(setup):
    jcfg, tcfg, jm, params, tm, jb, tb = setup
    grads = jax.jit(jax.grad(lambda p: jax_compute_loss(jcfg, jb, jm.apply(p, jb, deterministic=True)).total))(params)
    want = from_flax_params(jax.tree.map(np.asarray, grads))
    tm.zero_grad()
    compute_loss(tcfg, tb, tm(tb, deterministic=True)).total.backward()
    for name, p in tm.named_parameters():
        # the k-projection biases have an exactly zero true gradient (the
        # softmax is shift-invariant): the 1e-8 floor covers their rounding
        scale = max(want[name].abs().max().item(), 1e-4)
        err = (p.grad - want[name]).abs().max().item()
        assert err <= 1e-4 * scale, (name, err, scale)


def test_decay_partition_equals_jax_mask(setup):
    _, _, _, params, tm, _, _ = setup
    mask = from_flax_params(jtrainer._decay_mask(params))
    decayed = decay_names(tm)
    assert decayed == {n for n, m in mask.items() if m.item() > 0}
    # named "weight" in the state_dict, yet not decayed: LayerNorm scales, embeddings
    assert {"encoder.embed_ln.weight", "encoder.embed_action.weight", "decoder.layers.0.norm1.weight"}.isdisjoint(decayed)
    assert {"decoder.layers.0.self_attn.q_proj.weight", "decoder.predict_action.fc1.weight"} <= decayed


def test_optimizer_matches_optax():
    jcfg, tcfg = configs(**{"train.warmup_steps": 10, "train.max_steps": 50})
    want, got = jtrainer.lr_schedule(jcfg), lr_schedule(tcfg)
    for step in (0, 1, 5, 10, 11, 30, 50, 60):
        assert abs(got(step) - float(want(step))) <= 1e-12 + 1e-7 * abs(got(step)), step
    assert got(0) == 0.0  # the first update has lr 0
    rng = np.random.default_rng(0)
    for scale in (0.1, 10.0):
        grads = [rng.normal(size=s).astype(np.float32) * scale for s in ((3, 4), (7,), (2, 2, 2))]
        tx = optax.clip_by_global_norm(1.0)
        want_g, _ = tx.update([jnp.asarray(g) for g in grads], tx.init(None))
        got_g = [torch.tensor(g) for g in grads]
        norm = clip_by_global_norm(got_g, 1.0)
        assert abs(norm.item() - float(optax.global_norm([jnp.asarray(g) for g in grads]))) < 1e-5 * norm.item()
        for a, b in zip(got_g, want_g):
            np.testing.assert_allclose(t2n(a), np.asarray(b), atol=1e-7, rtol=1e-6)


@pytest.fixture(scope="module")
def golden():
    return np.load(GOLDENS)


def test_twenty_steps_match_executed_reference(golden):
    """The JAX parity test's configuration and recorded batches, through
    the port's trainer from the reference's own init."""
    over = {
        "model.hidden_dim": 32, "model.num_heads": 2, "model.dim_feedforward": 64,
        "model.num_transformer_encoder_layers": 2, "model.num_decoder_layers": 2,
        "model.compute_dtype": "float32", "model.dropout": 0.0, "model.goal_dropout": 0.0,
        "model.supervise_moving": True, "model.use_flash_attention": False, "model.remat": False,
        "waymo.train_context_length": 4, "waymo.max_num_agents": 4,
        "waymo.max_num_road_polylines": 6, "waymo.max_num_road_pts_per_polyline": 10,
        "train.lr": 5e-4, "train.weight_decay": 1e-4, "train.warmup_steps": 20, "train.max_steps": 200,
        "train.gradient_clip_val": 10.0, "train.accum_steps": 1,
    }
    jcfg, tcfg = configs(**over)
    init = {k[len("init_"):]: golden[k] for k in golden.files if k.startswith("init_")}
    flax = jax.tree.map(np.asarray, params_from_torch_state(init, jcfg))
    model = CtRLSim(tcfg, device="cpu")
    model.load_state_dict(from_flax_params(flax), strict=True)
    trainer = Trainer(tcfg, device="cpu")
    state = trainer.state_from_model(model)
    step = trainer.make_train_step()
    losses = []
    for i in range(20):
        batch = {k: torch.tensor(golden[f"b{i}_{k}"]) for k in MODEL_KEYS}
        batch["timesteps"] = batch["timesteps"][:, 0, :].long()  # recorded [B, A, T]; ours [B, T]
        state, out = step(state, batch, None)
        losses.append(float(out.total))
    np.testing.assert_allclose(np.asarray(losses), golden["loss"][:20], rtol=2e-4, atol=2e-4)


def test_accumulation_averages_microbatch_gradients(setup):
    _, _, _, _, tm, _, tb = setup
    _, tcfg = configs(**{"model.dropout": 0.0, "model.goal_dropout": 0.0, "train.accum_steps": 3,
                         "train.gradient_clip_val": 1e9})
    trainer = Trainer(tcfg, device="cpu")
    model = CtRLSim(tcfg, device="cpu")
    model.load_state_dict(tm.state_dict())
    state, losses = trainer.make_train_step()(trainer.state_from_model(model), tb, None)
    ref = CtRLSim(tcfg, device="cpu")
    ref.load_state_dict(tm.state_dict())
    parts = [{k: v[i : i + 1] for k, v in tb.items()} for i in range(3)]
    for mb in parts:
        (compute_loss(tcfg, mb, ref(mb, deterministic=True)).total / 3).backward()
    last = compute_loss(tcfg, parts[-1], ref(parts[-1], deterministic=True))
    for a, b in zip(losses, last):
        assert abs(float(a) - float(b)) < 1e-5
    for (name, p), q in zip(model.named_parameters(), ref.parameters()):
        torch.testing.assert_close(p.grad, q.grad, atol=1e-6, rtol=1e-5, msg=name)


def test_first_update_has_lr_zero_and_the_eval_and_grad_norm_steps(setup):
    _, tcfg, _, _, tm, _, tb = setup
    trainer = Trainer(tcfg, device="cpu")
    model = CtRLSim(tcfg, device="cpu")
    model.load_state_dict(tm.state_dict())
    state = trainer.state_from_model(model)
    want = compute_loss(tcfg, tb, tm(tb, deterministic=True))
    for a, b in zip(trainer.make_eval_step()(state, tb), want):
        assert abs(float(a) - float(b)) < 1e-6
    norms = trainer.make_grad_norm_fn()(state, tb, None)  # dropout 0 in this config
    tm.zero_grad()
    want.total.backward()
    total = torch.sqrt(sum(p.grad.square().sum() for p in tm.parameters()))
    assert abs(norms["grad_2.0_norm_total"].item() - total.item()) < 1e-5 * total.item()
    name = "decoder.layers.0.linear1.weight"
    assert abs(norms[f"grad_2.0_norm/{name}"].item() - tm.get_parameter(name).grad.norm().item()) < 1e-5
    state, _ = trainer.make_train_step()(state, tb, None)
    assert state.step == 1 and torch.isfinite(state.grad_norm)
    for (name, p), q in zip(model.named_parameters(), tm.parameters()):
        assert torch.equal(p, q), name  # lr 0: optax reads the schedule before the update


def test_dropout_draws_from_the_generator_and_remat_replays_them(setup):
    _, _, _, _, tm, _, tb = setup
    grads = {}
    for remat in (False, True):
        _, tcfg = configs(**{"model.remat": remat})
        model = CtRLSim(tcfg, device="cpu")
        model.load_state_dict(tm.state_dict())
        for run in range(2):
            model.zero_grad()
            gen = torch.Generator().manual_seed(11)
            compute_loss(tcfg, tb, model(tb, deterministic=False, generator=gen)).total.backward()
            grads[remat, run] = [p.grad.clone() for p in model.parameters()]
        with torch.no_grad():
            det = model(tb, deterministic=True).action_preds
            drop = model(tb, deterministic=False, generator=torch.Generator().manual_seed(11)).action_preds
        assert not torch.allclose(det, drop)
    for key in ((False, 1), (True, 0), (True, 1)):
        for a, b in zip(grads[False, 0], grads[key]):
            torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-5)


def test_checkpoint_round_trip_and_retention(setup, tmp_path):
    _, _, _, _, tm, _, tb = setup
    _, tcfg = configs(**{"train.keep_last_n": 2})
    trainer = Trainer(tcfg, device="cpu")
    state = trainer.init_state(torch.Generator().manual_seed(1))
    step = trainer.make_train_step()
    mgr = CheckpointManager(tcfg, str(tmp_path))
    for i, val in enumerate((3.0, 1.0, 2.0, 4.0, 5.0)):
        state, _ = step(state, tb, torch.Generator().manual_seed(i))
        mgr.save(state.step, state, metrics={"val_loss": val})
    mgr.wait()
    assert mgr.all_steps() == [2, 4, 5] and mgr.latest_step() == 5  # the last two and the best
    fresh = trainer.init_state(torch.Generator().manual_seed(2))
    fresh = mgr.restore(fresh)
    assert fresh.step == 5
    for a, b in zip(fresh.model.state_dict().values(), state.model.state_dict().values()):
        assert torch.equal(a, b)
    # the restored optimizer continues exactly as the saved one
    s1, l1 = step(state, tb, torch.Generator().manual_seed(9))
    s2, l2 = step(fresh, tb, torch.Generator().manual_seed(9))
    for a, b in zip(s1.model.parameters(), s2.model.parameters()):
        assert torch.equal(a, b)
    assert CheckpointManager.load_config(str(tmp_path))["train"]["keep_last_n"] == 2


def test_train_main_on_cpu(tmp_path, capsys):
    args = ["--synthetic", "8", "--synthetic_agents", "6", "--device", "cpu", "--log_every", "1",
            "--save_dir", str(tmp_path)]
    for o in TOY_TRAIN:
        args += ["-o", o]
    torch_train.main(args + ["--steps", "3"])
    out = capsys.readouterr().out
    assert "[train] devices=1 batch=4 preset=ctrl_sim" in out
    assert "[train] store: 8 scenes" in out
    assert out.count("[train] step=") == 3 and "[train] done at step 3" in out
    rows = [json.loads(r) for r in (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in rows] == [1, 2, 3] and all(np.isfinite(r["total"]) for r in rows)
    torch_train.main(args + ["--steps", "4"])
    out = capsys.readouterr().out
    assert "[train] resuming from step 3" in out and "[train] done at step 4" in out


def _train_losses(tmp_path, name, steps, extra=()):
    """Runs train.main on the CPU (in ``tmp_path / name``, resuming if it
    holds a checkpoint) and returns its metrics rows by step."""
    args = ["--synthetic", "4", "--synthetic_agents", "6", "--device", "cpu", "--log_every", "1",
            "--save_dir", str(tmp_path / name), "--steps", str(steps)]
    for o in (*TOY_TRAIN, *extra):
        args += ["-o", o]
    torch_train.main(args)
    rows = [json.loads(r) for r in (tmp_path / name / "metrics.jsonl").read_text().splitlines()]
    return {r["step"]: r for r in rows}


def test_draws_depend_only_on_seed_and_step(tmp_path, capsys):
    """Each step's batch and dropout masks come from (seed, step): a run
    resumed at step 2 logs the losses of an uninterrupted run at step 3,
    and turning on the grad-norm logging (which draws its own dropout
    stream) changes no loss. Dropout is on (model.dropout 0.1)."""
    keys = ("total", "loss_actions", "loss_rtg_goal", "loss_state")
    straight = _train_losses(tmp_path, "straight", 3)
    _train_losses(tmp_path, "resumed", 2)
    resumed = _train_losses(tmp_path, "resumed", 3)
    assert "resuming from step 2" in capsys.readouterr().out
    logged = _train_losses(tmp_path, "logged", 3, ["train.log_grad_norms=true"])
    assert any(k.startswith("grad_2.0_norm/") for k in logged[3]), sorted(logged[3])
    for step in (1, 2, 3):
        for k in keys:
            assert resumed[step][k] == straight[step][k], (step, k)
            assert logged[step][k] == straight[step][k], (step, k)
    assert straight[1]["total"] != straight[2]["total"]


def test_accumulation_refuses_a_batch_it_does_not_divide(setup):
    """Three rows into two microbatches would give uneven chunks, each
    weighted 1/2; the JAX step's reshape raises, and so does the port's."""
    *_, tm, _, tb = setup
    assert len(tb["actions"]) == 3
    _, cfg = configs(**{"model.dropout": 0.0, "model.goal_dropout": 0.0, "train.accum_steps": 2})
    trainer = Trainer(cfg, device="cpu")
    state = trainer.state_from_model(tm)
    with pytest.raises(ValueError, match="equal microbatches"):
        trainer.make_train_step()(state, tb, torch.Generator().manual_seed(0))
    assert len(_split(tb, 3)) == 3 and all(len(m["actions"]) == 1 for m in _split(tb, 3))


def test_the_ctrl_sim_step_refuses_replayed_draws(setup):
    """Replayed diffusion draws are ``CTGTrainer``'s: the CtRL-Sim step
    raises on them instead of dropping them."""
    *_, tm, _, tb = setup
    _, cfg = configs(**{"model.dropout": 0.0, "model.goal_dropout": 0.0})
    trainer = Trainer(cfg, device="cpu")
    with pytest.raises(ValueError, match="CTGTrainer"):
        trainer.make_train_step()(trainer.state_from_model(tm), tb, None, draws=[("steps", "noise")])


def test_entry_points_need_the_card_or_an_explicit_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    _, tcfg = configs()
    scene = synthetic_scenario(tcfg, seed=0, num_agents=4, arena_half=60.0, num_lanes=2)
    calls = [
        lambda: Trainer(tcfg),
        lambda: CtRLSim(tcfg),
        lambda: ScenarioStore.from_scenes(tcfg, [scene]),
        lambda: multi_agent_causal_mask(2, 2, 3),
        lambda: torch_train.main(["--synthetic", "2", "--steps", "1"]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def test_refusals_of_what_is_not_ported(tmp_path, capsys):
    """The DT, IL, trajeglish and CTG++ presets, refused until they were
    ported, equal the JAX package's, and ``train.py --preset dt`` takes a
    step on the CPU (``--preset ctg_plus_plus``:
    ``tests/test_torch_ctg_training.py``). What stays unported is refused:
    the multi-device learner. The JSON scene loaders are ported: a data or
    validation directory without scene JSONs raises."""
    import dataclasses

    from ctrl_sim_tpu.config import preset as jax_preset

    for name in ("ctrl_sim", "dt", "il", "trajeglish", "ctg_plus_plus"):
        ours, ref = preset(name), jax_preset(name)
        for section in ("sim", "waymo", "model", "diffusion", "train", "policy", "eval"):
            assert dataclasses.asdict(getattr(ours, section)) == dataclasses.asdict(getattr(ref, section)), (name, section)
    base = ["--device", "cpu", "--save_dir", str(tmp_path)]
    with pytest.raises(NotImplementedError):
        torch_train.main(base + ["--distributed"])
    (tmp_path / "no_scenes").mkdir()
    for flag in ("--data_dir", "--val_dir"):
        with pytest.raises(FileNotFoundError):
            torch_train.main(base + ["--synthetic", "2", flag, str(tmp_path / "no_scenes"),
                                     *(x for o in TOY_TRAIN for x in ("-o", o))])
    assert preset("ctrl_sim") == torch_load_config()
    args = base + ["--preset", "dt", "--synthetic", "4", "--synthetic_agents", "6", "--log_every", "1", "--steps", "1"]
    for o in TOY_TRAIN:
        args += ["-o", o]
    torch_train.main(args)
    out = capsys.readouterr().out
    assert "preset=dt" in out and "[train] step=1 " in out and "[train] done at step 1" in out
    row = json.loads((tmp_path / "metrics.jsonl").read_text().splitlines()[0])
    assert np.isfinite(row["total"]) and row["loss_rtg_goal"] == row["loss_state"] == 0.0
