"""Scene-steps completed over the window: every run_step call times its
scenes, over the time from the window's first call to a synchronize
after its last (host clock)."""


def read(ctx):
    return ctx.steps_per_s
