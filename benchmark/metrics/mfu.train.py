"""mfu.train: the whole train step's share of the card's bf16 peak: the
model operations of every step completed in the traced window over the
window's length and 989 TFLOP/s.

A step's operations are counted from the cell's shapes and the built
configuration's token layout: the forward pass of each microbatch (the map
encoder over every road point, the embeddings of the layout's state and
return tokens, the encoder layers over the map and initial-state memory,
each decoder layer's projections over every token, its self-attention over
the pairs the mask admits, its cross-attention and feed-forward, and the
heads), three times over for the forward and the backward; the optimizer's
elementwise work is left out."""

from benchmark import yardstick as y


def forward_flops(s: dict, cfg, rows: int, pairs: int) -> float:
    m = cfg.model
    agents, steps = s["max_num_agents"], s["train_context_length"]
    tokens = rows * steps * agents  # of each token type
    memory = s["max_num_road_polylines"] + agents
    H = s["hidden_dim"]
    embed = {"state": y.state_embed_flops(tokens, s), "rtg": y.rtg_embed_flops(tokens, s), "action": 0.0}
    types = m.num_token_types
    return (y.map_encoder_flops(rows, s) + sum(embed[y.token_kind(k, m)] for k in range(types))
            + y.encoder_layers_flops(rows, memory, s)
            + s["num_decoder_layers"] * (y.decoder_layer_flops(types * tokens, rows * pairs, memory, s)
                                         + 2 * y.dense(rows * memory, H, H))
            + y.heads_flops(tokens, tokens, tokens, s))


def read(ctx):
    rows, _, pairs = y.train_attention_shape(ctx.cfg, ctx.traffic)
    step = 3.0 * ctx.traffic["accum_steps"] * forward_flops(ctx.sizes, ctx.cfg, rows, pairs)
    return 100.0 * ctx.counts["steps"] * step / ctx.trace.window_s / y.PEAK_BF16_FLOPS
