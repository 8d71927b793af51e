"""soft.device_ms: device ms of the kernels, copies and sets launched while
the host was inside the port's sim.soft spans (the XPBD soft solve), a
profiled step. Nothing where the program has no such span or the trace no
device time."""


def read(ctx):
    if not ctx.trace.spans_of("sim.soft"):
        return None
    us = ctx.trace.device_us_launched_in("sim.soft")
    return us / 1e3 / ctx.profiled_steps if us else None
