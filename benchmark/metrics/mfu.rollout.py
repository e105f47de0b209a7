"""mfu.rollout: the whole rollout's share of the card's bf16 peak: the
model operations of every chunk completed in the traced window over the
window's length and 989 TFLOP/s.

A chunk's operations are counted from the cell's shapes and the built
configuration's decode passes (``yardstick.decode_passes``): once a chunk,
the map encoder over every road point, the initial states' embedding, the
encoder layers over the memory and each decoder layer's cross-attention
keys and values; each step, the embeddings of the step's new state and
return tokens, each decode pass's decoder layers (projections,
self-attention over the ring keys the mask admits, counted from the token
layout, cross-attention, feed-forward) and the heads. The env and the
contact solver are not model operations."""

from benchmark import yardstick as y


def chunk_flops(s: dict, cfg, lanes: int, slots: int) -> float:
    m = cfg.model
    H, window, types = s["hidden_dim"], s["train_context_length"], m.num_token_types
    memory = s["max_num_road_polylines"] + slots
    rows = lanes * slots
    embed = {"state": y.state_embed_flops(rows, s), "rtg": y.rtg_embed_flops(rows, s), "action": 0.0}
    once = (y.map_encoder_flops(lanes, s) + y.state_embed_flops(rows, s)
            + y.encoder_layers_flops(lanes, memory, s)
            + s["num_decoder_layers"] * 2 * y.dense(lanes * memory, H, H))
    passes = y.decode_passes(cfg)
    per_step = 0.0
    for t in range(s["steps"]):
        for groups in passes:
            per_step += sum(embed[y.token_kind(k, m)] for k, dt in groups if dt == 0)
            at = [(k, t + dt) for k, dt in groups]
            pairs = y.stream_admitted(t, at, slots, types, m.state_token_index, window, m.attend_own_return_action)
            per_step += s["num_decoder_layers"] * y.decoder_layer_flops(
                rows * len(groups), lanes * pairs, memory, s)
        per_step += y.heads_flops(rows, rows, 0, s)
    return once + per_step


def read(ctx):
    flops = chunk_flops(ctx.sizes, ctx.cfg, ctx.traffic["scenes"], ctx.cfg.eval.agent_slots)
    return 100.0 * ctx.counts["chunks"] * flops / ctx.trace.window_s / y.PEAK_BF16_FLOPS
