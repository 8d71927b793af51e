"""render.roofline_pct: a frame's least time over its device time
(render.device_ms), as a percentage. The least time is the larger of the
frame's f32 operations / 67 TFLOP/s and its bytes / 3.35 TB/s, counted
from the shape of its work (harness/render_bound.py: envs, width, height,
shapes by kind and the ground, which the driver counts as `render.work`).
The shape poses (render.poses) run before the render span, outside the
device time read, and are less than 1% of the operations counted. Nothing
where the program has no render span or the trace no device time."""
from portbench.harness.render_bound import render_bound


def read(ctx):
    work = ctx.counts.get("render.work")
    if not work or not ctx.trace.spans_of("render"):
        return None
    device_us = ctx.trace.device_us_launched_in("render")
    if not device_us:
        return None
    least_ms = render_bound(**work)[0]
    return 100.0 * least_ms * 1e3 * ctx.profiled_steps / device_us
