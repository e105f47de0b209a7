"""Multi-agent causal decoder and heads (port of
``ctrl_sim_tpu/models/decoder.py``; reference modules/decoder.py:8-79).

Two execution paths:

- ``forward``: the full-sequence decode of training. On a CUDA tensor with
  ``model.use_flash_attention`` the self-attention goes through the flash
  kernels K3/K4 (ops/flash_attention.py) with the mask evaluated in the
  kernel; otherwise through the plain einsum path with the dense
  [N, N] mask of ops/masks.py.
- ``decode_step_groups`` (and ``decode_step``, one group): the streaming
  rollout's incremental decode over a ring-buffer KV cache through the
  decode-attention kernel K1, or K2 over an int8 cache (ops/attention.py),
  with the static episode memory's cross-attention K/V projected once.

Heads: 1000-way action categorical (read from the rtg-token stream), 350
bins x 3 return-to-go components (from the state-token stream), and 32
future (x, y) per token (from the action stream).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from benchmark.reference.sim.config import Config
from benchmark.reference.sim.models.layers import MLPLayer, TransformerDecoderLayer
from benchmark.reference.sim.ops import masks
from benchmark.reference.sim.ops.flash_attention import MaskSpec

Tensor = torch.Tensor


class DecoderOutput(NamedTuple):
    action_preds: Tensor  # [B, A, T, 1000]
    rtg_preds: Tensor | None  # [B, A, T, 350*3], bins-major
    state_preds: Tensor | None  # [B, A, T, T_ctx*2]


def _checkpointed(layer: nn.Module, generator: torch.Generator | None, *args) -> Tensor:
    """``layer(*args)`` whose activations are recomputed in the backward
    (``model.remat``). The recomputation must draw the same dropout masks
    and flash seeds: the default generators are replayed by
    ``torch.utils.checkpoint`` itself, an explicit ``generator`` is put back
    to its state before the first call for the recomputation, then to where
    it had got to."""
    if generator is None:
        return checkpoint(layer, *args, use_reentrant=False)
    before = generator.get_state()
    first = True

    def run(*a):
        nonlocal first
        if first:
            first = False
            return layer(*a, generator=generator)
        now = generator.get_state()
        generator.set_state(before)
        try:
            return layer(*a, generator=generator)
        finally:
            generator.set_state(now)

    return checkpoint(run, *args, use_reentrant=False)


@dataclass
class KVCache:
    """Ring-buffer self-attention cache of the streaming decoder.

    k, v: per-layer lists of [B, window, K, A, H] — token-type-major within
    each timestep slot, so one group of A tokens of one type is one
    contiguous slice. The buffers are updated in place by ``decode_step``.
    slot_t: the episode timestep each slot holds (-1 empty).
    The reference holds it in float32 (the port's int8 cache, kernel K2,
    has no plain copy here).
    """

    k: list[Tensor]
    v: list[Tensor]
    slot_t: list[int]

    @staticmethod
    def create(num_layers: int, B: int, window: int, A: int, K: int, H: int,
               dtype: torch.dtype, device=None) -> "KVCache":
        def buf(shape, dt):
            return [torch.zeros(shape, dtype=dt, device=device) for _ in range(num_layers)]

        return KVCache(k=buf((B, window, K, A, H), dtype), v=buf((B, window, K, A, H), dtype), slot_t=[-1] * window)


class Decoder(nn.Module):
    def __init__(self, cfg: Config, dtype: torch.dtype, device=None):
        super().__init__()
        mc, wc = cfg.model, cfg.waymo
        H = mc.hidden_dim
        self.cfg = cfg
        score = getattr(torch, mc.cross_score_dtype)
        self.layers = nn.ModuleList(
            TransformerDecoderLayer(
                H, mc.num_heads, mc.dim_feedforward, dtype,
                cross_score_dtype=score, dropout=mc.dropout, device=device,
            )
            for _ in range(mc.num_decoder_layers)
        )
        self.predict_action = MLPLayer(H, H, wc.action_dim, dtype, device)
        if mc.predict_rtg:
            self.predict_rtg = MLPLayer(
                H, H, wc.rtg_discretization * mc.num_reward_components, dtype, device
            )
        if mc.predict_future_states:
            self.predict_future_states = MLPLayer(
                H, H, wc.train_context_length * 2, dtype, device
            )

    def forward(
        self,
        tokens: Tensor,  # [B, T*A*K, H] after embed_ln
        memory: Tensor,  # [B, M, H]
        memory_valid: Tensor,  # [B, M] bool
        num_timesteps: int,
        deterministic: bool = True,
        window: int | None = None,
        generator: torch.Generator | None = None,
    ) -> DecoderOutput:
        mc, wc = self.cfg.model, self.cfg.waymo
        K, A, T = mc.num_token_types, wc.max_num_agents, num_timesteps
        mask = spec = None
        if mc.use_flash_attention and tokens.is_cuda:
            # the mask is evaluated in the kernel, never stored
            spec = MaskSpec(A, K, mc.state_token_index, mc.attend_own_return_action, window)
        else:
            mask = masks.multi_agent_causal_mask(
                T, A, K, mc.state_token_index, mc.attend_own_return_action, window, device=tokens.device
            )
        x = tokens
        for layer in self.layers:
            args = (x, memory, mask, memory_valid, deterministic, spec)
            x = _checkpointed(layer, generator, *args) if mc.remat else layer(*args, generator=generator)

        B, H = x.shape[0], x.shape[-1]
        streams = x.reshape(B, T * A, K, H)

        def head(mlp: nn.Module, stream: int) -> Tensor:  # -> [B, A, T, D]
            y = mlp(streams[:, :, stream])
            return y.reshape(B, T, A, y.shape[-1]).transpose(1, 2)

        return DecoderOutput(
            action_preds=head(self.predict_action, 1 if K == 3 else 0),
            rtg_preds=head(self.predict_rtg, 0) if mc.predict_rtg else None,
            state_preds=head(self.predict_future_states, 2) if mc.predict_future_states else None,
        )

    def memory_kv(self, memory: Tensor) -> list[tuple[Tensor, Tensor]]:
        """Each layer's cross-attention K/V of the static episode memory,
        projected once per episode."""
        return [
            (layer.cross_attn.k_proj(memory), layer.cross_attn.v_proj(memory))
            for layer in self.layers
        ]

    def decode_step(
        self,
        tokens: Tensor,  # [B, A, H] one timestep of one token type, after embed_ln
        token_type: int,
        t: int,
        cache: KVCache,
        memory_valid: Tensor,
        window: int,
        memory_kv: list[tuple[Tensor, Tensor]],
    ) -> tuple[Tensor, KVCache]:
        """Incremental decode of A new tokens: ``decode_step_groups`` with
        one group."""
        return self.decode_step_groups([(tokens, token_type, t)], cache, memory_valid, window, memory_kv)

    def decode_step_groups(
        self,
        groups,  # sequence of (tokens [B, A, H] post embed_ln, token_type int, t int)
        cache: KVCache,
        memory_valid: Tensor,
        window: int,
        memory_kv: list[tuple[Tensor, Tensor]],
        mask_override: Tensor | None = None,  # [Q, N] precomputed (int8/bool)
    ) -> tuple[Tensor, KVCache]:
        """Incremental decode of one or more A-token groups in one decoder
        pass; returns the layer-stack outputs [B, len(groups)*A, H]
        (group-major) and the cache, updated in place.

        Every group's K/V are written into the ring before attending. A t = -1
        group (the "previous action" block at episode start) writes junk K/V
        that stay masked: its slot keeps the label -1 until a real timestep
        overwrites it. The mask uses the true flat token indices on both sides,
        so the training-time predicate (ops/masks.py) applies verbatim.
        """
        mc = self.cfg.model
        K = mc.num_token_types
        A = groups[0][0].shape[1]
        writes = []
        for gi, (_, token_type, tg) in enumerate(groups):
            slot = tg % window
            if tg >= 0:
                cache.slot_t[slot] = tg
            writes.append((slot, token_type, gi * A))

        x = torch.cat([tokens for tokens, _, _ in groups], dim=1)
        if mask_override is not None:
            mask = mask_override
        else:
            mask = self._mask(groups, cache.slot_t, A, K, window, x.device)
        for li, layer in enumerate(self.layers):
            x = layer.decode_step(x, cache.k[li], cache.v[li], writes, mask, memory_valid, memory_kv[li])
        return x, cache

    def _mask(self, groups, slot_t: list[int], A: int, K: int, window: int, device) -> Tensor:
        """The [Q, window*K*A] visibility of the groups' queries over the
        ring's keys, from the slot -> timestep labels."""
        mc = self.cfg.model
        ar = lambda n: torch.arange(n, device=device)  # noqa: E731
        a_j = ar(A).repeat(window * K)
        k_j = ar(K).repeat_interleave(A).repeat(window)
        t_j = torch.tensor(slot_t, device=device).repeat_interleave(K * A)
        jj = t_j * (A * K) + a_j * K + k_j
        a_i = ar(A).repeat(len(groups))
        t_i = torch.tensor([tg for _, _, tg in groups], device=device).repeat_interleave(A)
        k_i = torch.tensor([tt for _, tt, _ in groups], device=device).repeat_interleave(A)
        ii = t_i * (A * K) + a_i * K + k_i
        m = masks.visible(
            ti=t_i[:, None], ai=a_i[:, None], ii=ii[:, None],
            tj=t_j[None, :], aj=a_j[None, :], kj=k_j[None, :], jj=jj[None, :],
            state_index=mc.state_token_index,
            attend_own_return_action=mc.attend_own_return_action,
            window=window,
        )
        return m & (t_j[None, :] >= 0)
