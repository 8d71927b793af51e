"""sim.phase_d.host_ms: host ms inside the port's sim.phase_d spans
(physics/step.py, utils/trace.py) a profiled step."""
from portbench.harness.spans import host_ms


def read(ctx):
    return host_ms(ctx, "sim.phase_d")
