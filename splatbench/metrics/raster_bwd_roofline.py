"""% of raster_bwd's roofline: the bound (yardstick/counts.py) of the
sampled traced steps over their launches' device time."""


def read(ctx):
    return ctx.kernel_roofline("raster_bwd_kernel", "raster_bwd")
