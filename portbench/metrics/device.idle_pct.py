"""device.idle_pct: the share of the profiled span in which no kernel, copy
or set runs on the card: 100 x (1 - the union of device intervals / the
span), not their sum."""


def read(ctx):
    if not ctx.trace.window_us or not ctx.trace.device:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_us() / ctx.trace.window_us)
