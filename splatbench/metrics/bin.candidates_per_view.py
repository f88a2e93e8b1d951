"""The program's (Gaussian, tile) candidates a view: the port's counters
bin.candidates (the binning's stream totals, tile-bbox pairs before the
tile-ellipse cull) over bin.views (views binned)
(opensplat_tpu_torch/utils/metrics.py `counts()`, always on) at reading
time, so over every step of the run so far. The expand launch, the sort
and the raster kernels are sized by it. None where the program keeps no
such counters."""


def read(ctx):
    from opensplat_tpu_torch.utils.metrics import counts

    c = counts()
    views = c.get("bin.views", 0)
    if not views or "bin.candidates" not in c:
        return None
    return c["bin.candidates"] / views
