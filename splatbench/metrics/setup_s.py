"""Process start to the window's first call: imports, the kernels'
build, the scene, the checked steps and the warm-up."""


def read(ctx):
    return ctx.window.setup_s
