"""CTG++ training in the port held against the JAX package: one
``CTGTrainer`` step with accumulation 2 (dropout 0, lr 1e-2 from the first
update) from the same params and batch, under the JAX step's own draws of
diffusion steps and noise (``fold_in(fold_in(key, step), microbatch)``):
the reported losses, which are the last microbatch's as in the JAX step,
and the updated parameters within 1e-5 where AdamW's first update is well
conditioned (see the test). Then ``train --preset
ctg_plus_plus --device cpu`` for 2 toy steps with a validation by
``state_mse``, and a resumed run."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import torch

from ctrl_sim_tpu.training.trainer import CTGTrainer as JaxCTGTrainer
from ctrl_sim_tpu.training.trainer import TrainState as JaxTrainState
from ctrl_sim_tpu.training.trainer import make_optimizer as jax_make_optimizer
from ctrl_sim_tpu_torch import train as torch_train
from ctrl_sim_tpu_torch.params import from_flax_params
from ctrl_sim_tpu_torch.training import CTGTrainer
from torch_port_common import CTG_TOY, ctg_configs, ctg_golden, ctg_golden_cond, ctg_models, jax_loss_draws, t2n

torch.set_num_threads(2)
TOL = {"atol": 1e-5, "rtol": 1e-4}


def _batch(g: dict) -> dict:
    """The golden's conditioning twice (4 scenes, 2 per microbatch) with
    ground-truth futures drawn from a seed."""
    rng = np.random.default_rng(0)
    cond = {k: np.concatenate([v, v]) for k, v in ctg_golden_cond(g).items()}
    B, N = cond["goals"].shape[:2]
    fut = rng.normal(size=(B, N, 3, 6)).astype(np.float32)
    fut[..., -1] = rng.random((B, N, 3)) > 0.2
    return {**cond, "agent_future_states": fut,
            "agent_future_actions": rng.uniform(-1, 1, size=(B, N, 3, 2)).astype(np.float32)}


def test_train_step_matches_jax_under_its_draws():
    over = {"model.dropout": 0.0, "model.goal_dropout": 0.0, "train.lr": 1e-2, "train.warmup_steps": 0}
    jcfg, tcfg = ctg_configs(**over)
    assert jcfg.train.accum_steps == 2
    g = ctg_golden()
    _, params, tm = ctg_models(jcfg, tcfg, g)
    batch = _batch(g)
    start = from_flax_params(jax.tree.map(np.asarray, params))  # the JAX step donates its state
    state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                          opt_state=jax_make_optimizer(jcfg, params).init(params))
    key = jax.random.PRNGKey(7)
    new_state, want = JaxCTGTrainer(jcfg).make_train_step()(
        state, jax.tree.map(jnp.asarray, batch), key)

    base = jax.random.fold_in(key, 0)
    micro_shape = (2,) + batch["agent_future_states"].shape[1:3] + (7,)
    draws = [jax_loss_draws(jax.random.fold_in(base, i), micro_shape, tcfg.model.n_diffusion_steps) for i in (0, 1)]
    ours = CTGTrainer(tcfg, device="cpu").state_from_model(tm)
    ours, got = CTGTrainer(tcfg, device="cpu").make_train_step()(
        ours, {k: torch.as_tensor(v) for k, v in batch.items()}, None, draws=draws)
    assert ours.step == 1 and got._fields == want._fields
    for name in want._fields:
        np.testing.assert_allclose(t2n(getattr(got, name)), np.asarray(getattr(want, name)), err_msg=name, **TOL)
    # AdamW's first update is lr * g / (|g| + 1e-8) per element: where the
    # gradient is rounding noise (the attention key biases, to which the
    # softmax is invariant, have a zero gradient in exact arithmetic) it is
    # noise in both programs. Elements with |g| >= 1e-6 are held within
    # 1e-5, the others to the update's bound, lr (1 + wd |p|)
    want_params = from_flax_params(jax.tree.map(np.asarray, new_state.params))
    got_params = ours.model.state_dict()
    grads = {name: p.grad for name, p in ours.model.named_parameters()}
    assert got_params.keys() == want_params.keys() == grads.keys()
    lr, wd = tcfg.train.lr, tcfg.train.weight_decay
    held = 0
    for name, w in want_params.items():
        got, w = t2n(got_params[name]), w.numpy()
        sure = t2n(grads[name].abs()) >= 1e-6
        held += int(sure.sum())
        np.testing.assert_allclose(got[sure], w[sure], err_msg=name, **TOL)
        bound = 2 * lr * (1 + wd * np.abs(start[name].numpy()[~sure]))
        assert (np.abs(got[~sure] - w[~sure]) <= bound).all(), name
    total = sum(w.numel() for w in want_params.values())
    assert held > 0.9 * total, (held, total)  # 93% of the elements at this toy size
    assert max(float((want_params[n] - start[n]).abs().max()) for n in start) > 1e-3  # the step moved the weights

TOY = {**CTG_TOY, "waymo.input_horizon": 3, "waymo.train_context_length": 6, "sim.steps": 12,
       "sim.max_agents": 4, "train.global_batch_size": 4, "model.n_diffusion_steps": 4,
       "model.n_eval_diffusion_step": 2}


def test_train_cli_ctg(tmp_path, capsys):
    """``python -m ctrl_sim_tpu_torch.train --preset ctg_plus_plus --device
    cpu``: 2 toy steps with finite losses, the CTG++ log line, no gradient
    norms, a validation by the sampled futures' ``state_mse`` on scene JSONs
    at step 2; then a resumed run to step 3."""
    from ctrl_sim_tpu_torch.config import _set_dotted, preset
    from ctrl_sim_tpu_torch.data.export import export_raw_json
    from ctrl_sim_tpu_torch.data.synthetic import synthetic_scenario

    cfg = preset("ctg_plus_plus")
    for k, v in TOY.items():
        cfg = _set_dotted(cfg, k, v)
    val = tmp_path / "val"
    val.mkdir()
    for s in range(2):
        export_raw_json(synthetic_scenario(cfg, seed=100 + s, num_agents=4), str(val / f"scene_{s}.json"))
    flags = [x for k, v in TOY.items() for x in ("-o", f"{k}={json.dumps(v)}")]
    save = tmp_path / "ckpt"
    args = ["--preset", "ctg_plus_plus", "--device", "cpu", "--synthetic", "3", "--synthetic_agents", "4",
            "--log_every", "1", "--save_dir", str(save), "-o", "train.log_grad_norms=true", *flags]
    torch_train.main(args + ["--steps", "2", "--val_dir", str(val), "--val_every", "2"])
    out = capsys.readouterr().out
    assert "preset=ctg_plus_plus" in out and out.count("[train] step=") == 2, out
    val_line = [r for r in out.splitlines() if r.startswith("[val] step=2 ")][0]
    assert "state_mse=" in val_line and "action_mse=" in val_line, val_line
    line = [r for r in out.splitlines() if r.startswith("[train] step=2 ")][0]
    for key in ("diffusion=", "a0=", "rtg="):
        assert key in line, line
    rows = [json.loads(r) for r in (save / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in rows] == [1, 2, 2] and np.isfinite(rows[-1]["val_loss"])
    for r in rows[:2]:
        assert all(np.isfinite(r[k]) for k in ("total", "diffusion_loss", "a0_loss")), r
        assert not any(k.startswith("grad_norm") for k in r), r  # CTG++ logs no gradient norms
    torch_train.main(args + ["--steps", "3"])
    out = capsys.readouterr().out
    assert "resuming from step 2" in out and "[train] done at step 3" in out
