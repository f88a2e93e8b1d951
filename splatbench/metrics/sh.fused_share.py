"""% of the program's render colour calls (ops/sh.py render_colours) that
ran as the SH kernel pair (one forward launch): the port's counters
sh.fused over sh.calls (opensplat_tpu_torch/utils/metrics.py `counts()`,
always on) at reading time, so over every call of the run so far. None
where the program keeps no such counters."""


def read(ctx):
    from opensplat_tpu_torch.utils.metrics import counts

    c = counts()
    calls = c.get("sh.calls", 0)
    if not calls:
        return None
    return 100.0 * c.get("sh.fused", 0) / calls
