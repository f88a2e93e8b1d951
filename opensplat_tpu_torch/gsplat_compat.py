"""gsplat-compatible functional API on torch tensors.

Counterpart of opensplat_tpu/gsplat_compat.py. The reference vendors
gsplat and exposes 11 kernel entry points (rasterizer/gsplat/ext.cpp:4-18);
this module provides the same capabilities on the port's ops. The
*_backward functions mirror the reference's pairs and take their
gradients with torch.autograd.grad through the forward (the JAX copy uses
jax.vjp). Every function runs on its inputs' device.

Entry point mapping (reference -> here):
  project_gaussians_forward   -> project_gaussians_forward
  project_gaussians_backward  -> project_gaussians_backward
  rasterize_forward           -> rasterize_forward   (dense renderer)
  rasterize_backward          -> rasterize_backward
  nd_rasterize_forward        -> nd_rasterize_forward (tiled renderer)
  nd_rasterize_backward       -> nd_rasterize_backward
  compute_sh_forward          -> compute_sh_forward
  compute_sh_backward         -> compute_sh_backward
  compute_cov2d_bounds        -> compute_cov2d_bounds (ops.projection)
  map_gaussian_to_intersects  -> map_gaussian_to_intersects
  get_tile_bin_edges          -> get_tile_bin_edges

map_gaussian_to_intersects returns the reference's int64 keys
(tile << 32) | depth_bits (forward.cu:132-137), sorted; the JAX copy
returns them as (I, 2) int32 pairs because the TPU has no 64-bit sort.
The JAX copy's `max_isects` budget has no counterpart: the port sizes
the tile stream exactly.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .ops.binning import bin_gaussians, num_tiles
from .ops.projection import (
    ProjectedGaussians,
    compute_cov2d_bounds,  # noqa: F401  (re-exported entry point)
    project_gaussians,
)
from .ops.rasterize import rasterize
from .ops.rasterize_tiled import rasterize_tiled
from .ops.sh import spherical_harmonics
from .ops.tensor_math import quat_to_rotmat

__all__ = [
    "project_gaussians_forward",
    "project_gaussians_backward",
    "rasterize_forward",
    "rasterize_backward",
    "nd_rasterize_forward",
    "nd_rasterize_backward",
    "compute_sh_forward",
    "compute_sh_backward",
    "compute_cov2d_bounds",
    "map_gaussian_to_intersects",
    "get_tile_bin_edges",
]

INT32_MAX = 2**31 - 1


def _grads(outputs, inputs, cotangents):
    """torch.autograd.grad of `outputs` against `inputs` (zeros where an
    input does not reach them)."""
    got = torch.autograd.grad(outputs, inputs, cotangents, allow_unused=True)
    return tuple(torch.zeros_like(x) if g is None else g
                 for x, g in zip(inputs, got))


def _leaves(*xs):
    return [x.detach().clone().requires_grad_(True) for x in xs]


def _cov3d(scales, glob_scale, quats):
    """Packed upper-triangular 3D covariance (N, 6), the reference's cov3d
    layout (forward.cu:450-470)."""
    R = quat_to_rotmat(quats)
    M = R * (glob_scale * scales)[:, None, :]
    cov = M @ M.transpose(-1, -2)
    return torch.stack([cov[:, 0, 0], cov[:, 0, 1], cov[:, 0, 2],
                        cov[:, 1, 1], cov[:, 1, 2], cov[:, 2, 2]], dim=-1)


def project_gaussians_forward(
    means3d, scales, glob_scale, quats, viewmat, projmat,
    fx, fy, cx, cy, img_height, img_width, clip_thresh=0.01,
):
    """(cov3d, xys, depths, radii, conics, num_tiles_hit) — the reference's
    project_gaussians_forward_tensor outputs (bindings.cu:133-207)."""
    proj = project_gaussians(
        means3d, scales, glob_scale, quats, viewmat, projmat,
        fx, fy, cx, cy, img_height, img_width, clip_thresh=clip_thresh,
    )
    cov3d = _cov3d(scales, glob_scale, quats)
    return (cov3d, proj.xys, proj.depths, proj.radii, proj.conics,
            proj.num_tiles_hit)


def project_gaussians_backward(
    means3d, scales, glob_scale, quats, viewmat, projmat,
    fx, fy, cx, cy, img_height, img_width,
    cov3d, radii, conics, v_xy, v_depth, v_conic,
):
    """(v_mean3d, v_scale, v_quat): the parameter gradients of the
    reference's hand-written VJPs (backward.cu:357-542), here by autograd
    through the same forward. The reference's intermediate covariance
    gradients are not returned."""
    with torch.enable_grad():
        m, s, q = _leaves(means3d, scales, quats)
        proj = project_gaussians(m, s, glob_scale, q, viewmat, projmat,
                                 fx, fy, cx, cy, img_height, img_width)
        return _grads((proj.xys, proj.depths, proj.conics), (m, s, q),
                      (v_xy, v_depth, v_conic))


def rasterize_forward(
    xys, depths, radii, conics, num_tiles_hit, colors, opacity,
    img_height, img_width, background,
):
    """(out_img, final_Ts) — rasterize_forward_tensor (bindings.cu:338-...)
    on the dense renderer; the sort happens inside (the reference's
    RasterizeGaussians autograd wrapper, rasterize_gaussians.cpp:39-91)."""
    return rasterize(xys, conics, colors, opacity.reshape(-1), depths,
                     radii > 0, background, img_height, img_width)


def rasterize_backward(
    xys, depths, radii, conics, num_tiles_hit, colors, opacity,
    img_height, img_width, background, v_out_img, v_out_alpha=None,
):
    """(v_xy, v_conic, v_colors, v_opacity) like rasterize_backward_tensor
    (bindings.cu:569-...)."""
    if v_out_alpha is None:
        v_out_alpha = torch.zeros((img_height, img_width),
                                  dtype=torch.float32, device=xys.device)
    with torch.enable_grad():
        leaves = _leaves(xys, conics, colors, opacity)
        out = rasterize_forward(leaves[0], depths, radii, leaves[1],
                                num_tiles_hit, leaves[2], leaves[3],
                                img_height, img_width, background)
        return _grads(out, leaves, (v_out_img, v_out_alpha))


def nd_rasterize_forward(
    xys, depths, radii, conics, num_tiles_hit, colors, opacity,
    img_height, img_width, background,
):
    """Channel-generic rasterization on the tiled renderer (work
    proportional to the intersection count, like the reference's
    nd_rasterize_forward, forward.cu:174-254). colors: (N, CH) for any
    CH; background: (CH,). Returns (out_img (H, W, CH), final_Ts (H, W))."""
    proj = _proj_like(xys, depths, radii, num_tiles_hit.to(torch.int32),
                      img_height, img_width)
    return rasterize_tiled(
        xys, conics, colors, opacity.reshape(-1), depths, radii,
        proj.num_tiles_hit, proj.tile_min, proj.tile_max,
        torch.as_tensor(background, dtype=torch.float32, device=xys.device),
        img_height, img_width,
    )


def nd_rasterize_backward(
    xys, depths, radii, conics, num_tiles_hit, colors, opacity,
    img_height, img_width, background, v_out_img, v_out_alpha=None,
):
    """(v_xy, v_conic, v_colors, v_opacity) for any channel count
    (backward.cu:15-129), through the tiled renderer's backward."""
    if v_out_alpha is None:
        v_out_alpha = torch.zeros((img_height, img_width),
                                  dtype=torch.float32, device=xys.device)
    with torch.enable_grad():
        leaves = _leaves(xys, conics, colors, opacity)
        out = nd_rasterize_forward(leaves[0], depths, radii, leaves[1],
                                   num_tiles_hit, leaves[2], leaves[3],
                                   img_height, img_width, background)
        return _grads(out, leaves, (v_out_img, v_out_alpha))


def compute_sh_forward(degrees_to_use, viewdirs, coeffs):
    """RGB from SH coefficients (N, bases, 3) (sh.cuh:218-238)."""
    return spherical_harmonics(degrees_to_use, viewdirs, coeffs)


def compute_sh_backward(degrees_to_use, viewdirs, coeffs, v_colors):
    """v_coeffs = basis x v_colors outer product (sh.cuh:240-260)."""
    with torch.enable_grad():
        (c,) = _leaves(coeffs)
        out = spherical_harmonics(degrees_to_use, viewdirs, c)
        return _grads(out, (c,), v_colors)[0]


def map_gaussian_to_intersects(
    num_points, num_intersects, xys, depths, radii, cum_tiles_hit,
    tile_bounds,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(isect_ids_sorted, gaussian_ids_sorted): every (Gaussian, tile) pair
    of each Gaussian's tile bbox, as the reference's 64-bit keys
    (tile_id << 32) | depth_bits (forward.cu:107-143; depth_bits the
    float32 bit pattern of the camera-space depth, monotone for positive
    depths) sorted, and their Gaussian ids. Binned by the expansion kernel
    without the cull. Past the true count (num_intersects may exceed it)
    come the sentinel key (n_tiles << 32) | INT32_MAX and id num_points."""
    tb_x, tb_y = int(tile_bounds[0]), int(tile_bounds[1])
    height, width = tb_y * 16, tb_x * 16
    nth = torch.diff(cum_tiles_hit, prepend=cum_tiles_hit.new_zeros(1))
    proj = _proj_like(xys, depths, radii, nth.to(torch.int32), height,
                      width)
    with torch.no_grad():
        binned = bin_gaussians(proj, height, width)
    total = binned.n_cands
    if num_intersects < total:
        raise ValueError(f"num_intersects={num_intersects} is below the "
                         f"{total} tile-bbox intersections")
    n_tiles = tb_x * tb_y
    dev = xys.device
    tile = torch.searchsorted(binned.tile_end.long(),
                              torch.arange(total, device=dev), right=True)
    gids = binned.gauss_ids.long()
    depth_bits = (depths.detach().to(torch.float32).contiguous()
                  .view(torch.int32).long() & 0xFFFFFFFF)
    keys = torch.full((int(num_intersects),), (n_tiles << 32) | INT32_MAX,
                      dtype=torch.int64, device=dev)
    keys[:total] = (tile << 32) | depth_bits[gids]
    ids = torch.full((int(num_intersects),), int(num_points),
                     dtype=torch.int32, device=dev)
    ids[:total] = binned.gauss_ids
    return keys, ids


def get_tile_bin_edges(num_intersects, isect_ids_sorted,
                       num_tiles: Optional[int] = None) -> torch.Tensor:
    """(T, 2) [start, end) ranges of each tile in a stream of sorted int64
    keys (forward.cu:148-169). Without `num_tiles`, T is the largest tile
    id of the first num_intersects keys plus one."""
    tile_ids = isect_ids_sorted >> 32
    if num_tiles is None:
        num_tiles = (int(tile_ids[:num_intersects].max()) + 1
                     if num_intersects else 0)
    tile_range = torch.arange(num_tiles, dtype=torch.int64,
                              device=tile_ids.device)
    start = torch.searchsorted(tile_ids, tile_range)
    end = torch.searchsorted(tile_ids, tile_range, right=True)
    return torch.stack([start, end], dim=-1).to(torch.int32)


def _proj_like(xys, depths, radii, num_tiles_hit, height, width):
    """Rebuild the tile bboxes binning needs from gsplat-style inputs."""
    tb_x, tb_y = num_tiles(height, width)
    r = radii.to(torch.float32)
    tcx = xys[:, 0].detach() / 16.0
    tcy = xys[:, 1].detach() / 16.0

    def tile(v, hi):  # truncation toward zero, as the JAX astype(int32)
        return torch.clamp(v.to(torch.int32), 0, hi)

    zeros = torch.zeros((xys.shape[0], 3), dtype=torch.float32,
                        device=xys.device)
    return ProjectedGaussians(
        xys=xys.detach(),
        depths=depths,
        cam_depths=depths,
        radii=radii,
        conics=zeros,
        cov2d=zeros,
        num_tiles_hit=num_tiles_hit,
        tile_min=torch.stack([tile(tcx - r / 16.0, tb_x),
                              tile(tcy - r / 16.0, tb_y)], dim=-1),
        tile_max=torch.stack([tile(tcx + r / 16.0 + 1.0, tb_x),
                              tile(tcy + r / 16.0 + 1.0, tb_y)], dim=-1),
        mask=radii > 0,
    )
