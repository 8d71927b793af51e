"""setup.render_s: host seconds of the port's setup.render stage in this
process: render/raster.py tables_from_scene, the render tables and their
copy to the card."""
from portbench.harness.spans import stage_s


def read(ctx):
    return stage_s("setup.render")
