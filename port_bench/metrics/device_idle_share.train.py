"""The share of the traced window in which nothing ran on the card: one
less the union of the profiler's device activity over the window."""


def read(ctx):
    return 100.0 * (1.0 - ctx.busy_s / ctx.window_s)
