"""Weights of the reference PyTorch CtRL-Sim (a Lightning ``state_dict``,
keys as in the reference's models/ctrl_sim.py: ``encoder.*`` and
``decoder.*``) as the JAX model's param tree of numpy arrays, which
``params.from_flax_params`` turns into the port's ``state_dict``.

The port's own copy of the CtRL-Sim part of
``ctrl_sim_tpu/utils/torch_import.py``, numpy only, for each family that
shares its backbone (CtRL-Sim, DT, IL, trajeglish; DT embeds its returns
with Linear layers, the others with embeddings). Mapping:

  Linear weight [out, in]          -> kernel [in, out] (transposed)
  LayerNorm weight/bias            -> scale/bias
  nn.Embedding weight              -> embedding
  MultiheadAttention packed
    in_proj_weight/bias            -> q_proj/k_proj/v_proj (+ out_proj)
  MLPLayer Sequential 0/1/3        -> Dense_0/LayerNorm_0/Dense_1

``golden_state`` reads the executed-reference goldens
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
