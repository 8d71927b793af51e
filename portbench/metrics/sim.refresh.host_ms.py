"""sim.refresh.host_ms: host ms inside the port's sim.refresh spans (the
body-cache refresh, Stepper.refresh_body_state) a profiled step."""
from portbench.harness.spans import host_ms


def read(ctx):
    return host_ms(ctx, "sim.refresh")
