"""Reference PyTorch checkpoints into the port: a Lightning-style
``{"state_dict": ...}`` file built from the executed reference's weights
(``tests/goldens/reference_model.npz``, the small golden of each family)
read by the JAX package's ``load_torch_checkpoint`` and by the port's, with
every tensor equal; then imported by the port's CLI
``ctrl_sim_tpu_torch.import_checkpoint`` into ``step_0.pt`` +
``config.json``, restored, and run: the port's forward on the imported
weights reproduces the reference's logits within the tolerance of
``tests/test_torch_goldens.py`` (1e-4 absolute and relative). The CTG++
layout imports the same way."""

import json
import os

import numpy as np
import pytest
import torch

from ctrl_sim_tpu.utils.torch_import import load_torch_checkpoint as jax_load_torch_checkpoint
from ctrl_sim_tpu_torch import import_checkpoint
from ctrl_sim_tpu_torch.config import _set_dotted, preset
from ctrl_sim_tpu_torch.training.checkpoint import CheckpointManager, restore_model
from ctrl_sim_tpu_torch.utils.torch_import import golden_batch, golden_state, load_torch_checkpoint

torch.set_num_threads(2)

GOLDEN = os.path.join(os.path.dirname(__file__), "goldens", "reference_model.npz")
SMALL = {
    "model.hidden_dim": 64, "model.num_heads": 4, "model.dim_feedforward": 128,
    "model.num_transformer_encoder_layers": 2, "model.num_decoder_layers": 2,
    "waymo.train_context_length": 4, "waymo.max_num_agents": 4,
    "waymo.max_num_road_polylines": 6, "waymo.max_num_road_pts_per_polyline": 10,
    "model.compute_dtype": "float32", "model.use_flash_attention": False, "model.remat": False,
}
NO_HEADS = {"model.predict_rtg": False, "model.predict_future_states": False}
FAMILIES = {"ctrl_sim": {}, "dt": NO_HEADS, "il": NO_HEADS, "trajeglish": NO_HEADS}


def _lightning_file(tmp_path, family: str) -> str:
    """A Lightning-style checkpoint of the golden's weights of ``family``,
    with the hyper-parameters and an extra non-tensor entry beside them."""
    g = np.load(GOLDEN)
    state = {k: torch.tensor(v) for k, v in golden_state(g, family).items()}
    path = str(tmp_path / f"{family}.ckpt")
    torch.save({"state_dict": state, "epoch": 3, "global_step": 1234}, path)
    return path


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_import_matches_jax_loader_and_reference_logits(tmp_path, family, capsys):
    path = _lightning_file(tmp_path, family)
    got, want = load_torch_checkpoint(path), jax_load_torch_checkpoint(path)
    assert got.keys() == want.keys() and len(got) > 0
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)

    out = tmp_path / "imported"
    flags = [x for k, v in {**SMALL, **FAMILIES[family]}.items() for x in ("-o", f"{k}={json.dumps(v)}")]
    import_checkpoint.main(["--torch", path, "--out", str(out), "--preset", family, *flags])
    assert f"[import] wrote {out}" in capsys.readouterr().out
    assert sorted(os.listdir(out)) == ["config.json", "metrics.json", "step_0.pt"]

    cfg = preset(family)
    for k, v in {**SMALL, **FAMILIES[family]}.items():
        cfg = _set_dotted(cfg, k, v)
    assert CheckpointManager.load_config(str(out))["model"]["hidden_dim"] == 64
    model, step = restore_model(cfg, str(out), "cpu")
    assert step == 0
    g = np.load(GOLDEN)
    batch = {k: torch.as_tensor(v) for k, v in golden_batch(g, family).items()}
    with torch.no_grad():
        pred = model(batch)
    for name in ("action_preds", "rtg_preds", "state_preds"):
        if f"{family}_out_{name}" not in g.files:
            assert getattr(pred, name) is None, name
            continue
        np.testing.assert_allclose(getattr(pred, name).numpy(), g[f"{family}_out_{name}"], atol=1e-4, rtol=1e-4,
                                   err_msg=name)


def test_import_refuses_the_ctg_layout(tmp_path, capsys):
    """The CTG++ layout, refused until it was ported, imports: a Lightning
    file of the executed reference's CTG++ weights (denoiser with RTG
    conditioning, RTG head, schedule buffers) under ``--preset
    ctg_plus_plus``, restored, reproduces the reference's denoiser and RTG
    outputs (``tests/test_torch_ctg_goldens.py``'s tolerances). A CtRL-Sim
    file under a CTG++ config still fails: its tensors are not the layout."""
    from torch_port_common import CTG_TOY, ctg_golden, ctg_golden_cond, ctg_reference_state

    g = ctg_golden()
    state = {k: torch.tensor(v) for k, v in ctg_reference_state(g, use_rtg=True).items()}
    state["diff_model.betas"] = torch.tensor(g["sched_betas"])
    path = str(tmp_path / "ctg.ckpt")
    torch.save({"state_dict": state, "epoch": 1}, path)
    over = {**CTG_TOY, "model.use_rtg": True}
    flags = [x for k, v in over.items() for x in ("-o", f"{k}={json.dumps(v)}")]
    out = tmp_path / "imported"
    import_checkpoint.main(["--torch", path, "--out", str(out), "--preset", "ctg_plus_plus", *flags])
    assert f"[import] wrote {out}" in capsys.readouterr().out
    cfg = preset("ctg_plus_plus")
    for k, v in over.items():
        cfg = _set_dotted(cfg, k, v)
    model, step = restore_model(cfg, str(out), "cpu")
    assert step == 0 and type(model).__name__ == "CTGPlusPlus"
    cond = {k: torch.as_tensor(v) for k, v in ctg_golden_cond(g).items()}
    with torch.no_grad():
        dit = model.diffusion.model(torch.as_tensor(g["in_future_k"]), cond, torch.as_tensor(g["in_diff_step"]))
        rtg = model.rtg_model(cond)
    np.testing.assert_allclose(dit.numpy(), g["dit_out"], atol=2e-4, rtol=1e-4)
    np.testing.assert_allclose(rtg.numpy(), g["rtg_out"], atol=2e-4, rtol=1e-4)
    with pytest.raises(KeyError):
        import_checkpoint.main(["--torch", _lightning_file(tmp_path, "ctrl_sim"), "--out", str(tmp_path / "y"),
                                "--preset", "ctg_plus_plus"])
