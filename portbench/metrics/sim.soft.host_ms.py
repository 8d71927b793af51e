"""sim.soft.host_ms: host ms inside the port's sim.soft spans (each rigid
substep's SoftStepper.substep call in Stepper.step, physics/step.py) a
profiled step."""
from portbench.harness.spans import host_ms


def read(ctx):
    return host_ms(ctx, "sim.soft")
