"""% of the rows that the program's spherical harmonics evaluated that
no tile of their view reads: the port's counters bin.rows (rows binned,
views x Gaussians: every row that SH evaluates, since SH evaluates every
row of every view) less bin.rows_hit (rows with at least one candidate
tile) over bin.rows (opensplat_tpu_torch/utils/metrics.py `counts()`,
always on) at reading time, so over every step of the run so far. SH's
basis, its per-view product, the product of its backward and the
concatenation of its coefficients are spent on those rows for nothing;
it reads 0 once SH evaluates only the rows that reach a tile. None where
the program keeps no such counters."""


def read(ctx):
    from opensplat_tpu_torch.utils.metrics import counts

    c = counts()
    rows = c.get("bin.rows", 0)
    if not rows or "bin.rows_hit" not in c:
        return None
    return 100.0 * (rows - c["bin.rows_hit"]) / rows
