"""Multi-agent causal attention mask as a closed-form predicate
(port of ``ctrl_sim_tpu/ops/masks.py``; reference: the double loop of
utils/train_utils.py:82-130).

Token index j = t*(A*K) + a*K + k, with K token types per agent per step:

  visible(i, j) =
      (k_j == state_index AND t_j <= t_i)
      OR (j <= i AND (t_j < t_i OR a_j == a_i)
          AND NOT (strict AND t_j < t_i AND a_j != a_i AND k_j != state_index))

with an optional sliding ``window``: t_j > t_i - window. Integer predicates,
so the port's masks equal the JAX masks bit for bit.
"""

from __future__ import annotations

import torch

from benchmark.reference.sim.device import resolve_device

Tensor = torch.Tensor


def visible(
    ti: Tensor,
    ai: Tensor,
    ii: Tensor,
    tj: Tensor,
    aj: Tensor,
    kj: Tensor,
    jj: Tensor,
    state_index: int,
    attend_own_return_action: bool = False,
    window: int | None = None,
) -> Tensor:
    """The visibility predicate for query coords (ti, ai, index ii) attending
    key coords (tj, aj, kj, index jj). Broadcasts."""
    state_vis = (kj == state_index) & (tj <= ti)
    base = (jj <= ii) & ((tj < ti) | (aj == ai))
    if attend_own_return_action:
        strict = (tj < ti) & (aj != ai) & (kj != state_index)
        base = base & ~strict
    out = state_vis | base
    if window is not None:
        out = out & (tj > ti - window)
    return out


def stream_step_masks(
    steps: int,
    window: int,
    num_agents: int,
    num_types: int,
    state_index: int,
    attend_own_return_action: bool = False,
    device: torch.device | str | None = None,
) -> tuple[Tensor, Tensor]:
    """Per-step masks of the fused 2-pass streaming decode.

    The ring buffer's slot->timestep map is a closed form of the step: slot s
    at step t holds label t - ((t - s) mod window), or -1 before genesis.
    Returns ``(mask1 [T, 2A, N], mask2 [T, A, N])`` int8, N = window *
    num_types * num_agents: pass 1 = the t-1 action group + the t state
    group, pass 2 = the t rtg group (token type 1, the default layout).
    On the card unless ``device`` says otherwise."""
    device = resolve_device(device)
    A, K, w = num_agents, num_types, window
    ar = lambda n: torch.arange(n, device=device)  # noqa: E731
    ts = ar(steps)
    slot_label = ts[:, None] - torch.remainder(ts[:, None] - ar(w)[None, :], w)
    slot_label = torch.where(slot_label >= 0, slot_label, -1)  # [T, w]

    a_j = ar(A).repeat(w * K)  # [N]
    k_j = ar(K).repeat_interleave(A).repeat(w)
    t_j = slot_label.repeat_interleave(K * A, dim=1)  # [T, N]
    jj = t_j * (A * K) + a_j[None, :] * K + k_j[None, :]

    def build(t_i_rows: Tensor, k_i_rows: Tensor) -> Tensor:
        a_i = ar(A).repeat(t_i_rows.shape[1] // A)  # [Q]
        ii = t_i_rows * (A * K) + a_i[None, :] * K + k_i_rows
        m = visible(
            ti=t_i_rows[:, :, None],
            ai=a_i[None, :, None],
            ii=ii[:, :, None],
            tj=t_j[:, None, :],
            aj=a_j[None, None, :],
            kj=k_j[None, None, :],
            jj=jj[:, None, :],
            state_index=state_index,
            attend_own_return_action=attend_own_return_action,
            window=w,
        ) & (t_j[:, None, :] >= 0)
        return m.to(torch.int8)

    k_action = K - 1
    t1 = torch.cat([(ts - 1)[:, None].expand(steps, A), ts[:, None].expand(steps, A)], dim=1)
    k1 = torch.cat(
        [torch.full((steps, A), k_action, device=device),
         torch.full((steps, A), state_index, device=device)],
        dim=1,
    )
    mask1 = build(t1, k1)
    t2 = ts[:, None].expand(steps, A)
    mask2 = build(t2, torch.full((steps, A), 1, device=device))
    return mask1, mask2


def token_coords(index: Tensor, num_agents: int, num_types: int) -> tuple[Tensor, Tensor, Tensor]:
    """(t, a, k) coordinates of token indices."""
    t = index // (num_agents * num_types)
    a = (index // num_types) % num_agents
    k = index % num_types
    return t, a, k


def multi_agent_causal_mask(
    num_steps: int,
    num_agents: int,
    num_types: int,
    state_index: int = 0,
    attend_own_return_action: bool = False,
    window: int | None = None,
    device: torch.device | str | None = None,
) -> Tensor:
    """Dense [N, N] boolean mask (True = attend), N = steps*agents*types,
    on the card unless ``device`` says otherwise. Equivalent to
    get_causal_mask (utils/train_utils.py:82-130) with 0 -> True and
    -inf -> False."""
    idx = torch.arange(num_steps * num_agents * num_types, device=resolve_device(device))
    t, a, k = token_coords(idx, num_agents, num_types)
    return visible(
        t[:, None], a[:, None], idx[:, None],
        t[None, :], a[None, :], k[None, :], idx[None, :],
        state_index, attend_own_return_action, window,
    )
