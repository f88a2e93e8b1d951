"""Ground-truth uploads a scene-step in the window: calls of the
cameras' get_image (each a miss of the trainer's GT cache and a
host-to-device copy) over the steps times their scenes."""


def read(ctx):
    return ctx.window.uploads / (ctx.window.steps * ctx.window.scenes_per_step)
