"""k1_roofline_pct: kernel K1 (decode attention over the KV cache) as a
share of its roofline in the rollout cells: the least time of its launches
over their device time in the trace.

A launch attends Q new rows of each of B lanes over the ring of N = window
x token types x slots cached tokens, H wide: it reads q and writes its
output once (2 B Q H in the compute type), reads K and V once (2 B N H in
the cache's type) and the [Q, N] int8 mask, and does 4 B Q N H operations
(``yardstick.least_s``). Launches a step: one a decoder layer and decode
pass, Q = the pass's groups x slots, the passes worked out from the built
configuration (``yardstick.decode_passes``) and held against the number of
K1 launches in the trace."""

from benchmark import yardstick


def is_k1(name: str) -> bool:
    return "decode_attention" in name and "q8" not in name


def launch_least_s(lanes, q, n, h, act_bytes=2, cache_bytes=2):
    return yardstick.least_s(4.0 * lanes * q * n * h,
                             2 * lanes * q * h * act_bytes + 2 * lanes * n * h * cache_bytes + q * n)


def read(ctx):
    kernel_s = ctx.trace.kernel_seconds(is_k1)
    if kernel_s <= 0.0:
        return None
    m, s = ctx.cfg.model, ctx.sizes
    passes = yardstick.decode_passes(ctx.cfg)
    steps = ctx.counts["chunks"] * s["steps"]
    counted = steps * s["num_decoder_layers"] * len(passes)
    if not yardstick.launches_agree("k1_roofline_pct", ctx.trace.kernel_count(is_k1), counted):
        return None
    slots, lanes = ctx.cfg.eval.agent_slots, ctx.traffic["scenes"]
    n = s["train_context_length"] * m.num_token_types * slots
    act, cache = yardstick.ELEMENT_BYTES[m.compute_dtype], yardstick.ELEMENT_BYTES[m.kv_cache_dtype]
    per_step = s["num_decoder_layers"] * sum(
        launch_least_s(lanes, len(groups) * slots, n, s["hidden_dim"], act, cache) for groups in passes)
    return 100.0 * steps * per_step / kernel_s
