"""sphere_world.roofline_pct: the sphere world's least time over its two
kernels' device time (sw_broadphase, sw_sweeps) in the profiled steps, as a
percentage. The least time of each profiled solve is the larger of its
f32 operations / 67 TFLOP/s and its bytes / 3.35 TB/s (harness/roofline.py,
on that solve's own inputs: active pairs change as the balls fall and
pile); for this world it is the operations' bound. Nothing when no solve
launched the kernels."""
from portbench.harness.roofline import sphere_world_bound

KERNELS = ("sw_broadphase", "sw_sweeps")


def read(ctx):
    solves = ctx.captured.get("sphere_world") or []
    device_us = ctx.trace.device_us(lambda n: any(k in n for k in KERNELS))
    if not solves or not device_us:
        return None
    least_ms = sum(sphere_world_bound(args)[0] for args in solves)
    return 100.0 * least_ms * 1e3 / device_us
