"""95th percentile, over all steps of the window, of the interval
between consecutive step ends on the device timeline (CUDA events
recorded after each run_step, no extra synchronize)."""
import numpy as np


def read(ctx):
    return float(np.percentile(ctx.window.step_ms, 95))
