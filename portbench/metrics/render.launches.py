"""render.launches: host launch calls inside the port's render spans a
profiled frame, each launch that at least one device operation carries
counted once (harness/spans.py::launches)."""
from portbench.harness.spans import launches


def read(ctx):
    return launches(ctx, "render")
