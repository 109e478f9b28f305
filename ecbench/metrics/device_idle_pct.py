"""device_idle_pct.<mix>: the share of the window in which the card ran
no kernel, copy or fill (the union of the profiler trace's device
records)."""


def read(ctx):
    if ctx.trace is None:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.window_s)
