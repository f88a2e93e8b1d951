"""% of raster_fwd's roofline: the bound (yardstick/counts.py) of the
sampled traced steps over their launches' device time."""


def read(ctx):
    return ctx.kernel_roofline("raster_fwd_kernel", "raster_fwd")
