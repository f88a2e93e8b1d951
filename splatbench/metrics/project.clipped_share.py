"""% of the rows the program projected that lay behind its clip plane
(camera depth <= clip_thresh, 0.01): the port's counters project.clipped
over project.rows (opensplat_tpu_torch/utils/metrics.py `counts()`,
always on) at reading time, so over every step of the run so far. The
rows in the clip slab (|depth| < clip_thresh) are among them: the
projection evaluates those at a safe depth. None where the program
keeps no such counters."""


def read(ctx):
    from opensplat_tpu_torch.utils.metrics import counts

    c = counts()
    rows = c.get("project.rows", 0)
    if not rows or "project.clipped" not in c:
        return None
    return 100.0 * c["project.clipped"] / rows
