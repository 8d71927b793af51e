"""setup_s: seconds from the process's start to the first step of the
window (loading, building the scene, the kernels' build on a first run,
warming up every shape the cell uses)."""


def read(ctx):
    return ctx.setup_s
