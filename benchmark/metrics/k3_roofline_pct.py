"""k3_roofline_pct: kernel K3 (flash attention forward of the training
decoder) as a share of its roofline in the train cells: the least time of
its launches over their device time in the trace.

A launch covers one microbatch of B rows and one decoder layer, T = steps
x agents x token types tokens, H wide: 4 H operations for each (query,
key) pair that the multi-agent causal mask admits (counted from the built
configuration's token layout, ``yardstick.train_attention_shape``); it
reads q, k, v and writes the output once (4 B T H in the compute type) and
writes the fp32 log-sum-exp (B heads T). Launches a step: decoder layers x
accumulation steps, held against the number of K3 launches in the trace."""

from benchmark import yardstick


def is_k3(name: str) -> bool:
    return "flash_fwd" in name


def read(ctx):
    kernel_s = ctx.trace.kernel_seconds(is_k3)
    if kernel_s <= 0.0:
        return None
    s = ctx.sizes
    launches = ctx.counts["steps"] * s["num_decoder_layers"] * ctx.traffic["accum_steps"]
    if not yardstick.launches_agree("k3_roofline_pct", ctx.trace.kernel_count(is_k3), launches):
        return None
    rows, tokens, pairs = yardstick.train_attention_shape(ctx.cfg, ctx.traffic)
    act = yardstick.ELEMENT_BYTES[ctx.cfg.model.compute_dtype]
    least = yardstick.least_s(4.0 * pairs * s["hidden_dim"] * rows,
                              4 * rows * tokens * s["hidden_dim"] * act + rows * s["num_heads"] * tokens * 4)
    return 100.0 * launches * least / kernel_s
