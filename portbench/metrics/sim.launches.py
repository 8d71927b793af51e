"""sim.launches: host launch calls inside the port's sim.step spans a
profiled step: each launch (a correlation in the trace) whose call falls in
the span and that at least one kernel, copy or set on the device carries,
counted once. A CUDA graph's replay is one launch."""
from portbench.harness.spans import launches


def read(ctx):
    return launches(ctx, "sim.step")
