"""setup.build_s: host seconds of the port's setup.build stage in this
process: every SceneBuilder.create_env and create_actor call."""
from portbench.harness.spans import stage_s


def read(ctx):
    return stage_s("setup.build")
