"""The benchmark's own arithmetic: the card's published peaks, the union of
device intervals, the multi-agent causal mask counted from the token
layout, and dense-layer operation counts. The metric readers under
``metrics/`` build on it; nothing here reads the port, so a change to the
port cannot move the yardstick.

Peaks: NVIDIA H100 SXM data sheet, dense rates at the 700 W limit (the
card's power limit is written beside every share the benchmark reports).
"""

from __future__ import annotations

import sys

import numpy as np

PEAK_BYTES_PER_S = 3.35e12  # HBM3
PEAK_BF16_FLOPS = 989e12  # tensor cores, dense


def interval_union_ns(intervals, lo: int, hi: int) -> int:
    """Nanoseconds of [lo, hi) that at least one (start, end) interval
    covers; overlapping intervals count once."""
    return sum(end - start for start, end in merged_intervals(intervals, lo, hi))


def merged_intervals(intervals, lo: int, hi: int) -> list[tuple[int, int]]:
    """The intervals clipped to [lo, hi), sorted and merged where they
    overlap or touch."""
    out: list[tuple[int, int]] = []
    for start, end in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if end <= start:
            continue
        if out and start <= out[-1][1]:
            if end > out[-1][1]:
                out[-1] = (out[-1][0], end)
        else:
            out.append((start, end))
    return out


def idle_gaps(intervals, lo: int, hi: int) -> list[tuple[int, int]]:
    """The stretches of [lo, hi) that no interval covers."""
    gaps, cursor = [], lo
    for start, end in merged_intervals(intervals, lo, hi):
        if start > cursor:
            gaps.append((cursor, start))
        cursor = max(cursor, end)
    if cursor < hi:
        gaps.append((cursor, hi))
    return gaps


def visible(ti, ai, ii, tj, aj, kj, jj, state_index: int, own: bool = False, window: int | None = None):
    """CtRL-Sim's multi-agent causal mask (the reference repo's
    get_causal_mask) as a predicate on token coordinates, token index
    j = t * (A * K) + a * K + k: a query sees every agent's state token up
    to its own step, and otherwise the tokens before it of earlier steps or
    of its own agent (``own``: not the other agents' earlier non-state
    tokens); ``window`` keeps keys of the last ``window`` steps. Broadcasts
    over numpy arrays."""
    out = ((kj == state_index) & (tj <= ti)) | ((jj <= ii) & ((tj < ti) | (aj == ai))
                                               & ~(own & (tj < ti) & (aj != ai) & (kj != state_index)))
    if window is not None:
        out = out & (tj > ti - window)
    return out


def admitted_pairs(steps: int, agents: int, types: int, state_index: int, own: bool = False,
                   window: int | None = None) -> int:
    """The (query, key) pairs of one training sequence of steps x agents x
    types tokens that the mask admits."""
    idx = np.arange(steps * agents * types)
    t, a, k = idx // (agents * types), (idx // types) % agents, idx % types
    col = lambda x: x[:, None]  # noqa: E731
    return int(visible(col(t), col(a), col(idx), t, a, k, idx, state_index, own, window).sum())


def ring_labels(step: int, window: int) -> np.ndarray:
    """The step each slot of the streaming decode's ring of ``window``
    steps holds at ``step`` (-1 before the episode reaches it)."""
    s = np.arange(window)
    label = step - np.mod(step - s, window)
    return np.where(label >= 0, label, -1)


def stream_admitted(step: int, groups, agents: int, types: int, state_index: int, window: int,
                    own: bool = False) -> int:
    """Keys of the ring admitted over one lane's query rows of one decode
    pass at ``step``: ``groups`` lists (token type, step) of the pass's
    groups of ``agents`` rows each; the ring holds every slot's types and
    agents, labelled by ``ring_labels``."""
    label = ring_labels(step, window)
    tj = np.repeat(label, types * agents)
    kj = np.tile(np.repeat(np.arange(types), agents), window)
    aj = np.tile(np.arange(agents), window * types)
    jj = tj * (agents * types) + aj * types + kj
    ti = np.concatenate([np.full(agents, tg) for _, tg in groups])
    ki = np.concatenate([np.full(agents, kt) for kt, _ in groups])
    ai = np.tile(np.arange(agents), len(groups))
    ii = ti * (agents * types) + ai * types + ki
    col = lambda x: x[:, None]  # noqa: E731
    m = visible(col(ti), col(ai), col(ii), tj, aj, kj, jj, state_index, own, window) & (tj >= 0)
    return int(m.sum())


def dense(tokens: float, fan_in: int, fan_out: int) -> float:
    """Operations of a dense layer over ``tokens`` rows (a multiply and an
    add per weight)."""
    return 2.0 * tokens * fan_in * fan_out


def mlp(tokens: float, d_in: int, hidden: int, d_out: int) -> float:
    """The reference's MLPLayer: Linear, LayerNorm, ReLU, Linear."""
    return dense(tokens, d_in, hidden) + dense(tokens, hidden, d_out)


def map_encoder_flops(lanes: int, cfg: dict) -> float:
    """The per-polyline map encoder over ``lanes`` scenes: an MLP over
    every road point, single-query attention pooling with a learned seed,
    and the road-type fusion MLPs."""
    H, P, L = cfg["hidden_dim"], cfg["max_num_road_polylines"], cfg["max_num_road_pts_per_polyline"]
    pts, polys = lanes * P * L, lanes * P
    return (mlp(pts, cfg["map_attr"], H, H) + 2 * dense(pts, H, H) + 2 * dense(polys, H, H)
            + 2.0 * 2 * polys * L * H + mlp(polys, H, H, H) + mlp(polys, cfg["num_road_types"], H, H)
            + mlp(polys, 2 * H, H, H))


def encoder_layers_flops(lanes: int, memory: int, cfg: dict) -> float:
    """The transformer encoder layers over ``memory`` tokens a lane."""
    H, FF = cfg["hidden_dim"], cfg["dim_feedforward"]
    m = lanes * memory
    per_layer = 4 * dense(m, H, H) + 2.0 * 2 * lanes * memory * memory * H + dense(m, H, FF) + dense(m, FF, H)
    return cfg["num_transformer_encoder_layers"] * per_layer


def state_embed_flops(tokens: float, cfg: dict) -> float:
    H = cfg["hidden_dim"]
    return mlp(tokens, cfg["state_dim"], H, H) + mlp(tokens, cfg["goal_dim"], H, H) + dense(tokens, 2 * H, H)


def rtg_embed_flops(tokens: float, cfg: dict) -> float:
    """Return tokens: three lookups (CtRL-Sim) or three 1-wide dense
    layers (DT), then the 3H -> H fusion."""
    H = cfg["hidden_dim"]
    lookups = 0.0 if not cfg["decision_transformer"] else 3 * dense(tokens, 1, H)
    return lookups + dense(tokens, 3 * H, H)


def decoder_layer_flops(queries: float, self_pairs: float, memory_tokens: float, cfg: dict) -> float:
    """One decoder layer for ``queries`` new tokens: Q/K/V and output
    projections, self-attention over ``self_pairs`` admitted (query, key)
    pairs, cross-attention over ``memory_tokens`` a query (its K/V
    projected once, counted apart) and the feed-forward block."""
    H, FF = cfg["hidden_dim"], cfg["dim_feedforward"]
    return (4 * dense(queries, H, H) + 2.0 * 2 * self_pairs * H + 2 * dense(queries, H, H)
            + 2.0 * 2 * queries * memory_tokens * H + dense(queries, H, FF) + dense(queries, FF, H))


def heads_flops(rtg_rows: float, action_rows: float, future_rows: float, cfg: dict) -> float:
    H = cfg["hidden_dim"]
    actions = cfg["accel_discretization"] * cfg["steer_discretization"]
    out = mlp(action_rows, H, H, actions)
    if cfg["predict_rtg"]:
        out += mlp(rtg_rows, H, H, cfg["rtg_discretization"] * 3)
    if cfg["predict_future_states"]:
        out += mlp(future_rows, H, H, cfg["train_context_length"] * 2)
    return out


def least_s(flops: float, nbytes: float) -> float:
    """The least time of work on the card: the larger of its bytes at the
    memory rate and its operations at the bf16 tensor-core rate."""
    return max(nbytes / PEAK_BYTES_PER_S, flops / PEAK_BF16_FLOPS)


def train_attention_shape(cfg, traffic: dict) -> tuple[int, int, int]:
    """(rows a microbatch, tokens a sequence, admitted pairs a sequence) of
    the training decoder's self-attention, from the built configuration's
    token layout."""
    m, steps, agents = cfg.model, cfg.waymo.train_context_length, cfg.waymo.max_num_agents
    types = m.num_token_types
    pairs = admitted_pairs(steps, agents, types, m.state_token_index, m.attend_own_return_action)
    return traffic["global_batch"] // traffic["accum_steps"], steps * agents * types, pairs


def token_kind(k: int, model) -> str:
    """What token type ``k`` of the model's layout carries: the action is
    the last type, the state sits at ``state_token_index``, the return is
    the other."""
    if k == model.num_token_types - 1:
        return "action"
    return "state" if k == model.state_token_index else "rtg"


def decode_passes(cfg) -> list[list[tuple[int, int]]]:
    """The decode passes of one step of the streaming rollout, each the
    list of its groups of slot rows as (token type, step offset), worked
    out from the built configuration: the one-pass families write the t-1
    actions and this step's tokens in one pass (trajeglish its zero-action
    probe, IL the states, DT the returns and the states); CtRL-Sim fuses the
    t-1 actions with the t states, then the t returns, or with
    ``eval.streaming_passes`` = 3 decodes each in a pass of its own."""
    m = cfg.model
    action, state = (m.num_token_types - 1, -1), (m.state_token_index, 0)
    if m.trajeglish:
        return [[action, (0, 0)]]
    if m.il:
        return [[action, state]]
    if m.decision_transformer:
        return [[action, (0, 0), state]]
    rtg = (1 - m.state_token_index, 0)
    if cfg.eval.streaming_passes < 3:
        return [[action, state], [rtg]]
    return [[action], [state], [rtg]]


ELEMENT_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


def launches_agree(metric: str, found: int, counted: int) -> bool:
    """Whether the trace holds as many launches of a kernel as the
    configuration's layout counts for the window's work; where not, says
    so on standard error, and the metric's reader returns nothing."""
    if found != counted:
        print(f"{metric}: {found} launches in the trace against {counted} counted from the configuration; "
              "the metric is left out", file=sys.stderr)
    return found == counted
