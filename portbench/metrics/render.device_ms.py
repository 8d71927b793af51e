"""render.device_ms: device ms of the kernels, copies and sets launched while
the host was inside the port's render spans (render_camera_batch: the ray
directions, the ray-shape tests, the shading and the packing), a profiled
frame. Nothing where the program has no such span or the trace no device
time."""


def read(ctx):
    if not ctx.trace.spans_of("render"):
        return None
    us = ctx.trace.device_us_launched_in("render")
    return us / 1e3 / ctx.profiled_steps if us else None
