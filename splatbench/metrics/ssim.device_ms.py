"""Device ms of the program's SSIM (ops/ssim.py) forward and backward
alone at the cell's image size, by torch.profiler over 10 calls, times
the views a step renders (one a scene)."""
from splatbench.yardstick.profiling import ssim_device_ms


def read(ctx):
    if not ctx.on_card:
        return None
    ms = ssim_device_ms(ctx.program_ssim, ctx.scene["height"],
                        ctx.scene["width"], ctx.device, 10)
    return None if ms is None else ms * ctx.window.scenes_per_step
