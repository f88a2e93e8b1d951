"""% of the program's project_gaussians calls that ran as the projection
kernel pair (one forward launch): the port's counters project.fused over
project.calls (opensplat_tpu_torch/utils/metrics.py `counts()`, always
on) at reading time, so over every call of the run so far. None where
the program keeps no such counters."""


def read(ctx):
    from opensplat_tpu_torch.utils.metrics import counts

    c = counts()
    calls = c.get("project.calls", 0)
    if not calls:
        return None
    return 100.0 * c.get("project.fused", 0) / calls
