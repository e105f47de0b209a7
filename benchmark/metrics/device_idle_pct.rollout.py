"""device_idle_pct.rollout: the share of the traced window in which no
operation ran on the card, over the rollout cells' whole window (gaps
between chunks included): 100 x (window - union of the device operations'
intervals) / window, each instant counted once however many operations
overlap it."""


def read(ctx):
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
