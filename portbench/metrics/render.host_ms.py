"""render.host_ms: host ms inside the port's render spans
(render/raster.py render_camera_batch, whole) a profiled frame."""
from portbench.harness.spans import host_ms


def read(ctx):
    return host_ms(ctx, "render")
