"""soft.launches: host launch calls inside the port's sim.soft spans a
profiled step, each launch that at least one device operation carries
counted once (harness/spans.py::launches)."""
from portbench.harness.spans import launches


def read(ctx):
    return launches(ctx, "sim.soft")
