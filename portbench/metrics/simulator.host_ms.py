"""simulator.host_ms: host self ms of the Stepper.step span a profiled
step: its duration less that of the contact spans inside it."""


def read(ctx):
    if not ctx.trace.spans_of("simulator"):
        return None
    own = ctx.trace.span_us("simulator") - ctx.trace.nested_us("contact", "simulator")
    return own / 1e3 / ctx.profiled_steps
