"""device_us_per_env_step: the card's busy time a scene-step costs in the
rollout cells: the union of the device operations' intervals over the
traced window (each instant counted once), in microseconds, over the
scene-steps of every chunk the window completed. It leaves out the gaps in
which the device waits for the host, so the host's speed barely moves it:
it is the device work that sets the rate once the host no longer paces the
loop."""


def read(ctx):
    return 1e6 * ctx.trace.busy_s / ctx.counts["env_steps"]
