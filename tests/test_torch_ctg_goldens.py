"""The port's CTG++ against the executed reference (the reference's own
PyTorch modules, run by the tools that wrote ``tests/goldens``), through
the port's import of the reference layout
(``utils/torch_import.py:ctg_params_from_torch_state`` and
``params.from_flax_params``), with the tolerances
``tests/test_ctg_golden.py`` and ``tests/test_dit_golden.py`` hold the JAX
package to: the DiT forward with RTG conditioning and the RTG model
(``reference_ctg.npz``, 2e-4 absolute / 1e-4 relative), the strided
sampler on the reference's recorded noise stream (5e-4 / 1e-3), the
schedule constants and positional table, the social layer
(``reference_dit.npz``), and the importer's tree equal to the JAX
importer's. The full-size DiT (``reference_ctg_full.npz``: hidden 256, 8
heads, 24 agents, horizon 10 + 22, 200 x 100 road crops) runs on the card
only (marked ``cuda``; ``chip_smoke.py``'s ctg-golden-full phase runs it
too)."""

import os

import jax
import numpy as np
import pytest
import torch

from ctrl_sim_tpu.utils.torch_import import ctg_params_from_torch_state as jax_ctg_params
from ctrl_sim_tpu_torch.config import load_config
from ctrl_sim_tpu_torch.models.ctg.dit import DiT, RelativeSocialAttention, positional_encoding_table
from ctrl_sim_tpu_torch.models.ctg_plus_plus import CTGPlusPlus
from ctrl_sim_tpu_torch.params import from_flax_params
from ctrl_sim_tpu_torch.utils.torch_import import ctg_params_from_torch_state
from torch_port_common import ctg_configs, ctg_golden, ctg_golden_cond, ctg_reference_state, t2n

torch.set_num_threads(2)
GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")


@pytest.fixture(scope="module")
def golden():
    return ctg_golden()


def _imported(tcfg, state: dict) -> CTGPlusPlus:
    model = CTGPlusPlus(tcfg, device="cpu")
    model.load_state_dict(from_flax_params(ctg_params_from_torch_state(state, tcfg)), strict=True)
    return model.eval()


def _cond(golden) -> dict:
    return {k: torch.as_tensor(v) for k, v in ctg_golden_cond(golden).items()}


def test_dit_and_rtg_model_match_executed_reference(golden):
    _, tcfg = ctg_configs(**{"model.use_rtg": True})
    model = _imported(tcfg, ctg_reference_state(golden, use_rtg=True))
    with torch.no_grad():
        dit = model.diffusion.model(torch.as_tensor(golden["in_future_k"]), _cond(golden),
                                    torch.as_tensor(golden["in_diff_step"]))
        rtg = model.rtg_model(_cond(golden))
    np.testing.assert_allclose(t2n(dit), golden["dit_out"], atol=2e-4, rtol=1e-4)
    np.testing.assert_allclose(t2n(rtg), golden["rtg_out"], atol=2e-4, rtol=1e-4)


def test_sampler_matches_executed_reference(golden):
    """The reference's recorded noise stream replayed through the sampler
    (10 compounding denoiser steps)."""
    _, tcfg = ctg_configs()
    model = _imported(tcfg, ctg_reference_state(golden))
    noise = torch.as_tensor(golden["sample_noise"])  # [1 + n_eval, B, N, T_out, 7]
    with torch.no_grad():
        out = model.sample_from_cond(_cond(golden), noise_override=(noise[0], noise[1:]))
    np.testing.assert_allclose(t2n(out), golden["sample_out"], atol=5e-4, rtol=1e-3)


def test_schedule_and_positional_table_match_reference(golden):
    _, tcfg = ctg_configs()
    sched = CTGPlusPlus(tcfg, device="cpu").diffusion.schedule
    for name in ("betas", "alphas_cumprod", "posterior_variance", "posterior_log_variance_clipped",
                 "posterior_mean_coef1", "posterior_mean_coef2", "sqrt_alphas_cumprod",
                 "sqrt_one_minus_alphas_cumprod"):
        np.testing.assert_allclose(t2n(getattr(sched, name)), golden["sched_" + name], atol=1e-6, rtol=1e-5,
                                   err_msg=name)
    pe = golden["dit_w_pos_encoder.pe"]  # [max_len, 1, H], a frozen parameter of the reference
    np.testing.assert_allclose(t2n(positional_encoding_table(pe.shape[0], pe.shape[2])), pe[:, 0], atol=1e-6)


def test_social_attention_matches_executed_reference():
    """The reference's torch-geometric message passing over an explicit
    edge list, against the port's dense masked form (reference_dit.npz)."""
    with np.load(os.path.join(GOLDENS, "reference_dit.npz")) as f:
        g = {k: f[k] for k in f.files}
    layer = RelativeSocialAttention(64, 4, 128, torch.float32)
    names = {"mlp_lin1": "mlp.0", "mlp_lin2": "mlp.3"}
    state = {f"{name}.{leaf}": torch.as_tensor(g[f"w_{names.get(name, name)}.{leaf}"])
             for name, _ in layer.named_children() for leaf in ("weight", "bias")}
    layer.load_state_dict(state, strict=True)
    assert len(state) == len([k for k in g if k.startswith("w_")])  # every reference tensor used
    x = torch.as_tensor(g["in_x"]).transpose(0, 1)  # (N, B, H) -> [B, N, H]
    B, N, H = x.shape
    with torch.no_grad():
        out = layer(x, torch.as_tensor(g["in_rel"]).reshape(B, N, N, H), ~torch.as_tensor(g["in_pad"]))
    np.testing.assert_allclose(t2n(out), g["out"].transpose(1, 0, 2), atol=2e-4, rtol=1e-4)


@pytest.mark.parametrize("use_rtg", [False, True], ids=["no-rtg", "rtg"])
def test_importer_equals_jax_importer(golden, use_rtg):
    """The port's mapping of a reference Lightning state dict (with the
    schedule buffers a checkpoint carries, and the RTG head skipped when
    ``model.use_rtg`` is off) equals the JAX importer's, tensor for tensor,
    and an unmapped tensor raises."""
    jcfg, tcfg = ctg_configs(**{"model.use_rtg": use_rtg})
    rtg_head = {k: v for k, v in ctg_reference_state(golden, use_rtg=True).items() if k.startswith("rtg_model.")}
    state = {**ctg_reference_state(golden, use_rtg=use_rtg), **rtg_head}
    for name in ("betas", "alphas_cumprod", "posterior_variance"):
        state["diff_model." + name] = golden["sched_" + name]
    got = from_flax_params(ctg_params_from_torch_state(state, tcfg))
    want = from_flax_params(jax.tree.map(np.asarray, jax_ctg_params(state, jcfg, strict=True)))
    assert got.keys() == want.keys() and any(k.startswith("rtg_model.") for k in got) == use_rtg
    for k in want:
        assert torch.equal(got[k], want[k]), k
    with pytest.raises(ValueError, match="not mapped"):
        ctg_params_from_torch_state({**state, "diff_model.model.extra.weight": np.zeros(1)}, tcfg)


@pytest.mark.cuda
def test_full_size_dit_matches_executed_reference_on_the_card():
    """The DiT at the preset's full width in f32 on the card, with the
    executed reference's f16-snapped weights and inputs, within 5e-4 / 1e-4."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the full-size DiT runs on the card only")
    torch.backends.cuda.matmul.allow_tf32 = False
    with np.load(os.path.join(GOLDENS, "reference_ctg_full.npz")) as f:
        g = {k: f[k] for k in f.files}
    cfg = load_config({"model.ctg_plus_plus": True, "model.use_rtg": True, "model.compute_dtype": "float32"})
    state = {"diff_model.model." + k[len("dit_w_"):]: g[k].astype(np.float32) for k in g if k.startswith("dit_w_")}
    weights = from_flax_params(ctg_params_from_torch_state(state, cfg))  # the denoiser alone: no RTG head here
    model = DiT(cfg, torch.float32, "cuda")
    model.load_state_dict({k.removeprefix("diffusion.model."): v for k, v in weights.items()}, strict=True)
    cond = {k: torch.as_tensor(v.astype(np.float32) if v.dtype == np.float16 else v, device="cuda")
            for k, v in ctg_golden_cond(g).items()}
    with torch.no_grad():
        out = model.eval()(torch.as_tensor(g["in_future_k"].astype(np.float32), device="cuda"), cond,
                           torch.as_tensor(g["in_diff_step"], device="cuda"))
    np.testing.assert_allclose(t2n(out), g["dit_out"], atol=5e-4, rtol=1e-4)
