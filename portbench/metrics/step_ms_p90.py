"""step_ms_p90: the 90th percentile (linear between order statistics) of
every step of the window, a step's time being the gap between the CUDA
events recorded on its stream at consecutive step boundaries."""
import numpy as np


def read(ctx):
    return float(np.percentile(ctx.window.step_ms, 90)) if ctx.window.step_ms else None
