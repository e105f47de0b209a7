"""env_steps_per_s.traced: the streaming rollout's rate in the traced
window: the scene-steps of every chunk the window completed over the time
from its start to the end of its last chunk, the profiler running. The
host paces this loop (a chunk launches about 284,000 device operations),
so the rate follows the host's launch speed and reads lower under the
profiler than in an untraced window."""


def read(ctx):
    return ctx.counts["env_steps"] / ctx.counts["window_s"]
