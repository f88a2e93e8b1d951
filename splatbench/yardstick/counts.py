"""Operations and bytes a training step needs, counted from the step's
mathematics and this step's data, whatever implements it.

The work of a view comes from the benchmark's own plain forward
(reference/render.py `Work`): the visible Gaussians, and per tile the
records that some pixel of the tile needs (alpha >= 1/255 before the
pixel stops), each pixel's needed records up to its own stop (`pairs`)
and each tile's records up to its last pixel's stop (`replay`).

The per-pair operations and the kernels' bytes are chip_smoke.py's
(`OPS_PER_PAIR_*`, `bounds`), frozen here; the per-Gaussian and
per-pixel counts are of the formulas, float32 operations each (a
division, square root, exponential or comparison counts as one)."""
from __future__ import annotations

OPS_PER_PAIR_FWD = 20  # sigma, exp, alpha, stop test, composite
OPS_PER_PAIR_BWD = 45  # replay + the nine gradient terms
# projection: camera transform 18, clamped Jacobian 18, J W 18, the
# quaternion's rotation 42, T R S 36, exp(scale) 3, cov2d 17, conic 8,
# radius 10, the pixel centre 37, sigmoid 3: 210 forward, twice that
# backward
OPS_PROJECTION = 210 * 3
# SH degree 3: view direction 13, basis 47, contraction 96, +0.5 and
# clamp 6 forward; the coefficients' gradient 48 + 3 backward
OPS_SH3 = 162 + 51
# SSIM per pixel and channel: five 11-tap separable blurs (2 x 11
# multiply-adds each) and the map forward, 242; the map's gradient and
# the three blurs that reach the rendered image backward, 162
OPS_SSIM = 242 + 162
OPS_L1 = 3 + 2  # difference, abs and the sum; the sign backward
# Adam per parameter element: both moments 7, bias corrections 2, sqrt,
# eps, divide, learning rate, mask, update 6
OPS_ADAM = 15


def step_ops(work: dict) -> float:
    """Float32 operations one training step of a view needs."""
    pixels = work["height"] * work["width"]
    return (work["visible"] * (OPS_PROJECTION + OPS_SH3)
            + work["pairs"] * (OPS_PER_PAIR_FWD + OPS_PER_PAIR_BWD)
            + pixels * 3 * (OPS_SSIM + OPS_L1)
            + work["alive"] * work["params_per_gaussian"] * OPS_ADAM)


def raster_work(work: dict) -> dict:
    """{kernel: (bytes, operations)} of the forward and backward
    rasterizers: the visible Gaussians' table (xys, conics, opacity,
    colours) read once, the records' ids up to each tile's replay limit,
    the tile ranges, the image (and final T) written or read, the
    per-pixel stop written, and in the backward a nine-float row written
    per record replayed."""
    pixels = work["height"] * work["width"]
    n_tiles = work["n_tiles"]
    table = work["visible"] * 36
    common = table + work["replay"] * 4 + n_tiles * 8 + n_tiles * 256 * 4
    return {
        "raster_fwd": (common + pixels * 16,
                       work["pairs"] * OPS_PER_PAIR_FWD),
        "raster_bwd": (common + pixels * 20 + work["replay"] * 36,
                       work["pairs"] * OPS_PER_PAIR_BWD),
    }


def bound_seconds(nbytes: float, ops: float, peaks) -> float:
    """The least time the card could take: the larger of the bytes over
    the memory rate and the operations over the float32 rate."""
    bw, flops = peaks
    return max(nbytes / bw, ops / flops)
