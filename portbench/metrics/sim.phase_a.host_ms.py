"""sim.phase_a.host_ms: host ms inside the port's sim.phase_a spans
(physics/step.py, utils/trace.py) a profiled step."""
from portbench.harness.spans import host_ms


def read(ctx):
    return host_ms(ctx, "sim.phase_a")
