"""% of the untraced window's time in which no operation runs on the
device: one minus the device's busy time a step (the union of the
operations' intervals in the traced steps, over their count) over the
window's mean step (CUDA events, no profiler). Tracing slows the host's
launches (by half in a host-bound step), so the traced window's own idle
share, busy_s over window_s, reads high."""
import statistics


def read(ctx):
    tr = ctx.trace
    if not ctx.on_card or tr is None or tr.steps < 1 or not ctx.window.step_ms:
        return None
    busy_ms = 1e3 * tr.busy_s() / tr.steps
    return 100.0 * (1.0 - busy_ms / statistics.fmean(ctx.window.step_ms))
