"""The port held against the executed reference PyTorch model
(``tests/goldens/reference_model*.npz``, written by
tools/make_model_goldens.py): the reference weights go through the port's
``utils/torch_import.py`` and ``params.from_flax_params``, and the port's
forward, f32 on the CPU (the plain masked attention), reproduces the
reference's logits within 1e-4, as ``tests/test_model_goldens.py`` holds
the JAX model. The port's importer equals the JAX package's array for
array. The full-size golden is the deployed shape: hidden 256, 8 heads,
FF 1024, 2 + 4 layers, 24 agents, 32 steps, 200 x 100 road points."""

from __future__ import annotations

import os

import jax
import numpy as np
import pytest
import torch

from ctrl_sim_tpu.config import load_config as jax_load_config
from ctrl_sim_tpu.utils import torch_import as jax_import
from ctrl_sim_tpu_torch.config import load_config
from ctrl_sim_tpu_torch.models.ctrl_sim import CtRLSim
from ctrl_sim_tpu_torch.params import from_flax_params
from ctrl_sim_tpu_torch.utils import torch_import

torch.set_num_threads(2)

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")
COMMON = {
    "model.compute_dtype": "float32",
    "model.use_flash_attention": False,
    "model.use_pallas_attention": False,
    "model.remat": False,
}
CASES = {  # golden file, weight family, config overrides
    "small": ("reference_model.npz", "ctrl_sim", {
        "model.hidden_dim": 64, "model.num_heads": 4, "model.dim_feedforward": 128,
        "model.num_transformer_encoder_layers": 2, "model.num_decoder_layers": 2,
        "waymo.train_context_length": 4, "waymo.max_num_agents": 4,
        "waymo.max_num_road_polylines": 6, "waymo.max_num_road_pts_per_polyline": 10,
    }),
    "full": ("reference_model_full.npz", "full", {
        "model.hidden_dim": 256, "model.num_heads": 8, "model.dim_feedforward": 1024,
        "model.num_transformer_encoder_layers": 2, "model.num_decoder_layers": 4,
        "waymo.train_context_length": 32, "waymo.max_num_agents": 24,
        "waymo.max_num_road_polylines": 200, "waymo.max_num_road_pts_per_polyline": 100,
    }),
}


def _golden(case):
    fname, family, over = CASES[case]
    path = os.path.join(GOLDENS, fname)
    if not os.path.exists(path):
        pytest.skip(f"{fname} not generated")
    return np.load(path), family, {**COMMON, **over}


@pytest.mark.parametrize("case", sorted(CASES))
def test_importer_matches_jax(case):
    g, family, over = _golden(case)
    state = torch_import.golden_state(g, family)
    got = torch_import.params_from_torch_state(state, load_config(over))
    want = jax_import.params_from_torch_state(state, jax_load_config(over))
    got_leaves = jax.tree_util.tree_leaves_with_path(got)
    want_leaves = jax.tree_util.tree_leaves_with_path(want)
    assert [p for p, _ in got_leaves] == [p for p, _ in want_leaves]
    for (path, a), (_, b) in zip(got_leaves, want_leaves):
        assert isinstance(a, np.ndarray), jax.tree_util.keystr(path)
        np.testing.assert_array_equal(a, np.asarray(b), err_msg=jax.tree_util.keystr(path))


def test_importer_rejects_unmapped_tensors():
    g, family, over = _golden("small")
    state = {**torch_import.golden_state(g, family), "encoder.extra.weight": np.zeros(3)}
    with pytest.raises(ValueError, match="not mapped"):
        torch_import.params_from_torch_state(state, load_config(over))


@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_matches_executed_reference(case):
    g, family, over = _golden(case)
    cfg = load_config(over)
    model = CtRLSim(cfg, device="cpu")
    params = torch_import.params_from_torch_state(torch_import.golden_state(g, family), cfg)
    model.load_state_dict(from_flax_params(params), strict=True)
    model.eval()
    batch = {k: torch.as_tensor(v) for k, v in torch_import.golden_batch(g, family).items()}
    with torch.no_grad():
        out = model(batch)
    for name in ("action_preds", "rtg_preds", "state_preds"):
        np.testing.assert_allclose(getattr(out, name).numpy(), g[f"{family}_out_{name}"],
                                   atol=1e-4, rtol=1e-4, err_msg=name)
