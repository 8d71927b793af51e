"""soft.roofline_pct: the XPBD soft solve's least time a step over its
device time (soft.device_ms), as a percentage. The least time is the
larger of the solve's f32 operations / 67 TFLOP/s and its bytes / 3.35
TB/s, counted from the shape of its work (harness/xpbd_bound.py: envs,
mesh, colliders, iterations and substeps, which the driver counts as
`soft.work`). Nothing where the program has no sim.soft span or the trace
no device time."""
from portbench.harness.xpbd_bound import xpbd_bound


def read(ctx):
    work = ctx.counts.get("soft.work")
    if not work or not ctx.trace.spans_of("sim.soft"):
        return None
    device_us = ctx.trace.device_us_launched_in("sim.soft")
    if not device_us:
        return None
    least_ms = xpbd_bound(**work)[0]
    return 100.0 * least_ms * 1e3 * ctx.profiled_steps / device_us
