"""What the per-layer metrics read of the port's own spans and set-up stages
(its utils/trace.py). Each reader returns None where the program has no
such span or stage, as a port without utils/trace.py has not."""
from __future__ import annotations

from . import sides


def host_ms(ctx, name):
    """Host ms inside the spans of `name`, a profiled step."""
    if not ctx.trace.spans_of(name):
        return None
    return ctx.trace.span_us(name) / 1e3 / ctx.profiled_steps


def launches(ctx, name):
    """Host launch calls made inside the spans of `name`, a profiled step:
    the correlations of Trace.launch_ts whose call falls in such a span and
    that at least one device operation carries, each counted once."""
    spans = [(s, e) for _, s, e in ctx.trace.spans_of(name)]
    if not spans:
        return None
    carried = {corr for *_, corr in ctx.trace.device if corr is not None}
    n = sum(1 for corr, t in ctx.trace.launch_ts.items()
            if corr in carried and any(a <= t <= b for a, b in spans))
    return n / ctx.profiled_steps


def stage_s(name):
    """The port's stage_s[name]: host seconds of a set-up stage in this
    process."""
    module = f"{sides.PORT}.utils.trace"
    try:
        trace = sides.port("utils.trace")
    except ModuleNotFoundError as e:
        if e.name != module:
            raise
        return None
    return trace.stage_s.get(name)
