"""setup.soft_s: host seconds of the port's setup.soft stage in this
process: physics/soft.py build_soft_world and SoftStepper.__init__."""
from portbench.harness.spans import stage_s


def read(ctx):
    return stage_s("setup.soft")
