"""control.ops: non-view PyTorch operators the control call dispatches in
a step (harness/opcount.py), counted on the window's last state outside
the profiled steps."""


def read(ctx):
    return ctx.counts.get("control.ops")
