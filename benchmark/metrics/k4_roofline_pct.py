"""k4_roofline_pct: kernel K4 (flash attention backward of the training
decoder, its dq and dk/dv kernels together) as a share of its roofline in
the train cells: the least time of its launches over their device time in
the trace.

A launch covers one microbatch of B rows and one decoder layer: 10 H
operations for each (query, key) pair that the mask admits (the scores
again, dP, dS, dQ, dK and dV); it reads q, k, v, the output and its
gradient and writes dq, dk, dv once (8 B T H in the compute type), and
reads the fp32 log-sum-exp. Launches a step: decoder layers x accumulation
steps, held against the number of dk/dv kernels in the trace (one a
launch, beside its dq kernel)."""

from benchmark import yardstick


def is_k4(name: str) -> bool:
    return "flash_bwd" in name


def read(ctx):
    kernel_s = ctx.trace.kernel_seconds(is_k4)
    if kernel_s <= 0.0:
        return None
    s = ctx.sizes
    launches = ctx.counts["steps"] * s["num_decoder_layers"] * ctx.traffic["accum_steps"]
    found = ctx.trace.kernel_count(lambda name: is_k4(name) and "dkdv" in name)
    if not yardstick.launches_agree("k4_roofline_pct", found, launches):
        return None
    rows, tokens, pairs = yardstick.train_attention_shape(ctx.cfg, ctx.traffic)
    act = yardstick.ELEMENT_BYTES[ctx.cfg.model.compute_dtype]
    least = yardstick.least_s(10.0 * pairs * s["hidden_dim"] * rows,
                              8 * rows * tokens * s["hidden_dim"] * act + rows * s["num_heads"] * tokens * 4)
    return 100.0 * launches * least / kernel_s
