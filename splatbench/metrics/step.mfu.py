"""% of the card's float32 peak: the operations a step needs
(yardstick/counts.py step_ops over the step's views, the mean over the
sampled traced steps) at the window's steps a second."""
import statistics

from splatbench.yardstick.counts import step_ops


def read(ctx):
    if not ctx.on_card or not ctx.work or ctx.peaks is None:
        return None
    ops = statistics.mean(sum(step_ops(v) for v in w["views"])
                          for w in ctx.work)
    return 100.0 * ops * ctx.window.steps / ctx.window.seconds / ctx.peaks[1]
