"""control.host_ms: host ms of the control span (FrankaOscEnv._control) a
profiled step."""


def read(ctx):
    spans = ctx.trace.spans_of("control")
    return ctx.trace.span_us("control") / 1e3 / ctx.profiled_steps if spans else None
