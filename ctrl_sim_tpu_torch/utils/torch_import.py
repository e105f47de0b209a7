"""Weights of the reference PyTorch models (a Lightning ``state_dict``) as
the JAX models' param trees of numpy arrays, which
``params.from_flax_params`` turns into the port's ``state_dict``: CtRL-Sim
(keys as in the reference's models/ctrl_sim.py: ``encoder.*`` and
``decoder.*``) and CTG++ (models/ctg_plus_plus.py: ``diff_model.model.*``
and ``rtg_model.*``).

The port's own copy of ``ctrl_sim_tpu/utils/torch_import.py``, numpy only:
``params_from_torch_state`` for each family that shares the CtRL-Sim
backbone (CtRL-Sim, DT, IL, trajeglish; DT embeds its returns with Linear
layers, the others with embeddings), ``ctg_params_from_torch_state`` for
CTG++. Mapping:

  Linear weight [out, in]          -> kernel [in, out] (transposed)
  LayerNorm weight/bias            -> scale/bias
  nn.Embedding weight              -> embedding
  MultiheadAttention packed
    in_proj_weight/bias            -> q_proj/k_proj/v_proj (+ out_proj)
  MLPLayer Sequential 0/1/3        -> Dense_0/LayerNorm_0/Dense_1

``load_torch_checkpoint`` reads such a checkpoint (a Lightning ``.ckpt``
or a raw state dict) with torch alone; ``golden_state`` reads the
executed-reference goldens
(``tests/goldens/reference_model*.npz``), whose weight names drop the
``encoder.`` prefix and shorten ``decoder.`` to ``dec.``.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np

from ctrl_sim_tpu_torch.config import Config


def _lin(w, b):
    return {"kernel": np.asarray(w).T, "bias": np.asarray(b)}


def _ln(w, b):
    return {"scale": np.asarray(w), "bias": np.asarray(b)}


class _W:
    """Name-checked accessor over a torch state dict; tracks consumption so
    the importer can assert full coverage."""

    def __init__(self, state: Mapping[str, np.ndarray]):
        self.store = dict(state)
        self.used: set[str] = set()

    def __call__(self, name):
        self.used.add(name)
        return np.asarray(self.store[name])

    def mlp(self, prefix):
        return {
            "Dense_0": _lin(self(f"{prefix}.mlp.0.weight"), self(f"{prefix}.mlp.0.bias")),
            "LayerNorm_0": _ln(self(f"{prefix}.mlp.1.weight"), self(f"{prefix}.mlp.1.bias")),
            "Dense_1": _lin(self(f"{prefix}.mlp.3.weight"), self(f"{prefix}.mlp.3.bias")),
        }

    def linear(self, prefix):
        return _lin(self(f"{prefix}.weight"), self(f"{prefix}.bias"))

    def lnorm(self, prefix):
        return _ln(self(f"{prefix}.weight"), self(f"{prefix}.bias"))

    def embed(self, prefix):
        return {"embedding": self(f"{prefix}.weight")}

    def mha(self, prefix):
        w = self(f"{prefix}.in_proj_weight")
        b = self(f"{prefix}.in_proj_bias")
        H = w.shape[1]
        return {
            "q_proj": _lin(w[:H], b[:H]),
            "k_proj": _lin(w[H : 2 * H], b[H : 2 * H]),
            "v_proj": _lin(w[2 * H :], b[2 * H :]),
            "out_proj": self.linear(f"{prefix}.out_proj"),
        }

    def enc_layer(self, i):
        p = f"encoder.transformer_encoder.layers.{i}"
        return {
            "self_attn": self.mha(f"{p}.self_attn"),
            "linear1": self.linear(f"{p}.linear1"),
            "linear2": self.linear(f"{p}.linear2"),
            "norm1": self.lnorm(f"{p}.norm1"),
            "norm2": self.lnorm(f"{p}.norm2"),
        }

    def dec_layer(self, i):
        p = f"decoder.transformer_decoder.layers.{i}"
        return {
            "self_attn": self.mha(f"{p}.self_attn"),
            "cross_attn": self.mha(f"{p}.multihead_attn"),
            "linear1": self.linear(f"{p}.linear1"),
            "linear2": self.linear(f"{p}.linear2"),
            "norm1": self.lnorm(f"{p}.norm1"),
            "norm2": self.lnorm(f"{p}.norm2"),
            "norm3": self.lnorm(f"{p}.norm3"),
        }


def params_from_torch_state(state: Mapping[str, np.ndarray], cfg: Config) -> dict:
    """The JAX model's param tree (``{"params": {"encoder", "decoder"}}``,
    numpy leaves) for CtRL-Sim, DT, IL or trajeglish from a reference state
    dict. A tensor the mapping does not consume raises."""
    mc = cfg.model
    w = _W(state)
    rtg = w.linear if mc.decision_transformer else w.embed
    enc = {
        "embed_state": w.mlp("encoder.embed_state"),
        "embed_goal": w.mlp("encoder.embed_goal"),
        "embed_state_goal": w.linear("encoder.embed_state_goal"),
        "embed_action": w.embed("encoder.embed_action"),
        "embed_rtg": w.linear("encoder.embed_rtg"),
        "embed_timestep": w.embed("encoder.embed_timestep"),
        "embed_agent_id": w.embed("encoder.embed_agent_id"),
        "embed_ln": w.lnorm("encoder.embed_ln"),
        "embed_rtg_goal": rtg("encoder.embed_rtg_goal"),
        "embed_rtg_veh": rtg("encoder.embed_rtg_veh"),
        "embed_rtg_road": rtg("encoder.embed_rtg_road"),
    }
    if mc.use_map:
        enc["map_encoder"] = {
            "map_seeds": w("encoder.map_encoder.map_seeds"),
            "road_pts_encoder": w.mlp("encoder.map_encoder.road_pts_encoder"),
            "road_pts_attn_layer": w.mha("encoder.map_encoder.road_pts_attn_layer"),
            "norm1": w.lnorm("encoder.map_encoder.norm1"),
            "norm2": w.lnorm("encoder.map_encoder.norm2"),
            "map_feats": w.mlp("encoder.map_encoder.map_feats"),
            "road_type_encoder": w.mlp("encoder.map_encoder.road_type_encoder"),
            "road_road_type_encoder": w.mlp("encoder.map_encoder.road_road_type_encoder"),
        }
    for i in range(mc.num_transformer_encoder_layers):
        enc[f"encoder_layer_{i}"] = w.enc_layer(i)

    dec = {"predict_action": w.mlp("decoder.predict_action")}
    if mc.predict_rtg:
        dec["predict_rtg"] = w.mlp("decoder.predict_rtg")
    if mc.predict_future_states:
        dec["predict_future_states"] = w.mlp("decoder.predict_future_states")
    for i in range(mc.num_decoder_layers):
        dec[f"decoder_layer_{i}"] = w.dec_layer(i)

    unused = sorted(set(w.store) - w.used)
    if unused:
        raise ValueError(f"torch tensors not mapped: {unused}")
    return {"params": {"encoder": enc, "decoder": dec}}


def _ctg_social(w: _W, p: str) -> dict:
    """RelativeSocialAttentionLayer (ctg_arch.py:48-193)."""
    out = {name: w.linear(f"{p}.{name}") for name in (
        "lin_q_node", "lin_k_node", "lin_k_edge", "lin_v_node", "lin_v_edge", "lin_self", "lin_ih", "lin_hh",
        "out_proj")}
    out.update(norm1=w.lnorm(f"{p}.norm1"), norm2=w.lnorm(f"{p}.norm2"), mlp_lin1=w.linear(f"{p}.mlp.0"),
               mlp_lin2=w.linear(f"{p}.mlp.3"))
    return out


def _ctg_single_input_embedding(w: _W, p: str) -> dict:
    """SingleInputEmbedding (ctg_arch.py:196-213): Sequential 0/1, 3/4, 6/7."""
    out = {}
    for i in range(3):
        out[f"Dense_{i}"] = w.linear(f"{p}.embed.{3 * i}")
        out[f"LayerNorm_{i}"] = w.lnorm(f"{p}.embed.{3 * i + 1}")
    return out


def _ctg_map_encoder(w: _W, p: str) -> dict:
    """MapEncoderPtsMA (ctg_arch.py:262-335)."""
    return {
        "road_pts_lin": w.linear(f"{p}.road_pts_lin.0"),
        "map_seeds": w(f"{p}.map_seeds"),
        "road_pts_attn_layer": w.mha(f"{p}.road_pts_attn_layer"),
        "norm1": w.lnorm(f"{p}.norm1"),
        "norm2": w.lnorm(f"{p}.norm2"),
        "map_feats_lin1": w.linear(f"{p}.map_feats.0"),
        "map_feats_lin2": w.linear(f"{p}.map_feats.3"),
        "road_type_lin": w.linear(f"{p}.road_type_lin.0"),
        "road_pt_type_mlp_lin1": w.linear(f"{p}.road_pt_type_mlp.0"),
        "road_pt_type_mlp_lin2": w.linear(f"{p}.road_pt_type_mlp.3"),
    }


def _ctg_trunk(w: _W, p: str, num_layers: int) -> dict:
    t = {}
    for i in range(num_layers):
        for j in range(2):
            q = f"{p}.temporal_attn_layers.{i}.layers.{j}"
            t[f"temporal_{i}_{j}"] = {
                "self_attn": w.mha(f"{q}.self_attn"), "linear1": w.linear(f"{q}.linear1"),
                "linear2": w.linear(f"{q}.linear2"), "norm1": w.lnorm(f"{q}.norm1"), "norm2": w.lnorm(f"{q}.norm2"),
            }
        t[f"social_{i}"] = _ctg_social(w, f"{p}.social_attn_layers.{i}")
        t[f"map_attn_{i}"] = w.mha(f"{p}.map_attn_layers.{i}")
    return t


def _skip(w: _W, *prefixes: str) -> None:
    """Mark the tensors under ``prefixes`` consumed without a mapping
    (frozen tables, schedule buffers, modules the reference builds but
    never calls)."""
    w.used.update(k for k in w.store if k.startswith(prefixes))


def ctg_params_from_torch_state(state: Mapping[str, np.ndarray], cfg: Config) -> dict:
    """The JAX ``CTGPlusPlus`` param tree (``{"params": {"diffusion":
    {"model": ...}, "rtg_model": ...}}``, numpy leaves) from a reference
    CTG++ Lightning state dict (models/ctg_plus_plus.py):
    ``diff_model.model.*`` for the DiT denoiser (the reference's attribute
    ``diffustion_step_encoder`` keeps its spelling) and ``rtg_model.*`` for
    the RTG head, which is skipped when ``model.use_rtg`` is off. The
    positional tables and the diffusion schedule buffers are recomputed,
    not read. A tensor the mapping does not consume raises."""
    mc = cfg.model
    layers = mc.num_transformer_encoder_layers
    w = _W(state)
    p = "diff_model.model"
    dit = {
        "embed_state_action": w.mlp(f"{p}.embed_state_action"),
        "embed_goal": w.mlp(f"{p}.embed_goal"),
        "embed_timestep": w.embed(f"{p}.embed_timestep"),
        "embed_all_elements": w.mlp(f"{p}.embed_all_elements"),
        "diffusion_step_encoder": w.mlp(f"{p}.diffustion_step_encoder"),
        "relative_encodings_encoder": _ctg_single_input_embedding(w, f"{p}.relative_encodings_encoder"),
        "map_encoder": _ctg_map_encoder(w, f"{p}.map_encoder"),
        "trunk": _ctg_trunk(w, p, layers),
        "output_mlp": w.mlp(f"{p}.output_mlp"),
    }
    if mc.use_rtg:
        for name in ("embed_rtg_goal", "embed_rtg_veh", "embed_rtg_road"):
            dit[name] = w.embed(f"{p}.{name}")
        dit["embed_rtg"] = w.linear(f"{p}.embed_rtg")
    _skip(w, f"{p}.pos_encoder.pe", "diff_model.betas", "diff_model.alphas_cumprod", "diff_model.sqrt_",
          "diff_model.log_one_minus", "diff_model.posterior_", "diff_model.loss_fn.")
    params = {"diffusion": {"model": dit}}
    if not mc.use_rtg:
        _skip(w, "rtg_model.")
    elif any(k.startswith("rtg_model.") for k in w.store):
        p = "rtg_model"
        _skip(w, f"{p}.pos_encoder.pe", f"{p}.diffustion_step_encoder.")
        params["rtg_model"] = {
            "embed_state_action": w.mlp(f"{p}.embed_state_action"),
            "embed_goal": w.mlp(f"{p}.embed_goal"),
            "embed_timestep": w.embed(f"{p}.embed_timestep"),
            "embed_all_elements": w.mlp(f"{p}.embed_all_elements"),
            "relative_encodings_encoder": _ctg_single_input_embedding(w, f"{p}.relative_encodings_encoder"),
            "map_encoder": _ctg_map_encoder(w, f"{p}.map_encoder"),
            "trunk": _ctg_trunk(w, p, layers),
            "predict_rtg": w.mlp(f"{p}.predict_rtg"),
        }
    unused = sorted(set(w.store) - w.used)
    if unused:
        raise ValueError(f"torch tensors not mapped: {unused}")
    return {"params": params}


def golden_state(npz: Mapping[str, np.ndarray], family: str) -> dict[str, np.ndarray]:
    """The reference state dict stored in a golden file under
    ``{family}_w_*``: ``dec.`` names go to ``decoder.``, the rest to
    ``encoder.``."""
    pfx = f"{family}_w_"
    state = {}
    for key in npz:
        if not key.startswith(pfx):
            continue
        name = key[len(pfx):]
        name = "decoder." + name[len("dec."):] if name.startswith("dec.") else "encoder." + name
        state[name] = np.asarray(npz[key])
    return state


def golden_batch(npz: Mapping[str, np.ndarray], family: str) -> dict[str, np.ndarray]:
    """The input batch stored in a golden file under ``{family}_in_*``,
    with the per-agent timesteps [B, A, T] cut to the model's [B, T]."""
    pfx = f"{family}_in_"
    batch = {}
    for key in npz:
        if key.startswith(pfx):
            batch[key[len(pfx):]] = np.asarray(npz[key])
    batch["timesteps"] = batch["timesteps"][:, 0, :].astype(np.int64)
    return batch


def load_torch_checkpoint(path: str) -> dict[str, np.ndarray]:
    """A Lightning ``.ckpt`` (its ``state_dict``) or a raw state-dict ``.pt``
    as numpy arrays, loaded on the CPU with ``weights_only``."""
    import torch

    blob = torch.load(path, map_location="cpu", weights_only=True)
    state = blob.get("state_dict", blob) if isinstance(blob, dict) else blob
    return {k: v.numpy() for k, v in state.items() if hasattr(v, "numpy")}
