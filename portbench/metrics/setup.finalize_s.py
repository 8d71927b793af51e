"""setup.finalize_s: host seconds of the port's setup.finalize stage in this
process: SceneBuilder.finalize and Simulator.__init__."""
from portbench.harness.spans import stage_s


def read(ctx):
    return stage_s("setup.finalize")
