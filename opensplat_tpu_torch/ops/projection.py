"""EWA 3D->2D Gaussian projection on tensors.

Counterpart of opensplat_tpu/ops/projection.py in its "gpu" mode, the
one training uses (the "cpu" conformance mode comes with the renderers
that need it), band rendering included (`fov_width`/`fov_height`,
`row_offset`): near-plane cull,
quat -> R -> cov3d, EWA cov2d with FOV clamping and the +0.3 px blur,
conic and 3-sigma radius, NDC -> pixel centre, and the per-Gaussian tile
bounding box (opacity-aware when `opacities` is given). Elementwise over
the Gaussian axis. On the card `project_gaussians` is the projection
kernel pair (ops/kernels/project.py, csrc/project.cu): one launch
forward, and a backward derived by hand, one launch; on the CPU it is
`_project_views` below, the plain version, whose gradients come from
torch autograd, as the JAX package takes them from jax.grad. The
tensor's device alone selects.

A row in the clip slab (|z| < clip_thresh) is culled and evaluated at
depth 1, as the benchmark's reference does and as gsplat's kernel skips
it: its outputs stay finite and its gradient is 0. The JAX package
clamps |z| only to 1e-8, where the 2D covariance overflows float32; the
two differ on such rows alone. Counters (utils/metrics.py):
`project.rows`, the rows projected (views x Gaussians),
`project.clipped`, the rows behind the clip plane (z <= clip_thresh),
counted by the binning of the projection (`take_in_front`),
`project.calls`, the calls of `project_gaussians`, and `project.fused`,
those that launched the kernel.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..utils.metrics import count, host_sync
from .kernels import project as kproject
from .tensor_math import quat_to_rotmat
from .views import per_view

BLOCK_X = 16  # tile geometry, shared with the rasterizer
BLOCK_Y = 16


class ProjectedGaussians(NamedTuple):
    xys: torch.Tensor  # (N, 2) pixel-space centres
    depths: torch.Tensor  # (N,) camera-space z
    cam_depths: torch.Tensor  # (N,) NDC z
    radii: torch.Tensor  # (N,) int32, 0 for culled
    conics: torch.Tensor  # (N, 3) upper-tri inverse cov2d
    cov2d: torch.Tensor  # (N, 3) upper-tri cov2d
    num_tiles_hit: torch.Tensor  # (N,) int32 tile-bbox area
    tile_min: torch.Tensor  # (N, 2) int32 inclusive (x, y)
    tile_max: torch.Tensor  # (N, 2) int32 exclusive (x, y)
    mask: torch.Tensor  # (N,) bool visibility


# The last projection's rows in front of the clip plane (z > clip_thresh),
# on the device, until the binning of that projection takes them
# (`take_in_front`).
_in_front: Optional[torch.Tensor] = None


def take_in_front(like: torch.Tensor) -> Optional[torch.Tensor]:
    """The last projection's (V, N) in-front mask, handed over once, if
    it projected as many rows as `like` has elements, on its device;
    else None. Binning counts the rest as `project.clipped` in its one
    host read, so a projection that nothing bins has its clipped rows
    counted by no one."""
    global _in_front
    front, _in_front = _in_front, None
    if (front is None or front.numel() != like.numel()
            or front.device != like.device):
        return None
    return front


def project_gaussians(
    means: torch.Tensor,
    scales: torch.Tensor,
    glob_scale: float,
    quats: torch.Tensor,
    viewmat: torch.Tensor,
    projmat: torch.Tensor,
    fx: float,
    fy: float,
    cx: float,
    cy: float,
    img_height: int,
    img_width: int,
    clip_thresh: float = 0.01,
    valid_mask: Optional[torch.Tensor] = None,
    opacities: Optional[torch.Tensor] = None,
    alpha_thresh: float = 1.0 / 255.0,
    fov_width: Optional[int] = None,
    fov_height: Optional[int] = None,
    row_offset: Optional[int] = None,
) -> ProjectedGaussians:
    """Project N 3D Gaussians to screen space; same contract as the JAX
    project_gaussians with mode="gpu" (means (N,3), scales exponentiated
    (N,3), quats wxyz (N,4), viewmat world->camera, projmat full
    projection). fov_width/fov_height: the size of the whole image when
    this call renders a band of it, so that the EWA clamp is the whole
    frame's (as in the JAX package, whose bands shift cy and build
    projmat for the band). row_offset: this call projects rows
    [row_offset, row_offset + img_height) of the fov_width x fov_height
    frame that projmat, cx and cy describe (parallel/gaussian_shard.py):
    the centres are the frame's minus row_offset, an exact subtraction
    for a multiple of 16, so a band renders its rows of the frame to the
    bit; the tile grid is the band's.

    Views: viewmat and projmat (V, 4, 4) with V values each of fx, fy,
    cx and cy project V views at once; the Gaussians' tensors are one
    state's (N, ...) or V states' (V, N, ...), valid_mask and opacities
    likewise, and every output gains the leading V. On the card one
    thread a (view, row) computes every output from that view's scalars
    and matrices alone; in the plain version the two products with the
    view's matrices run once a view (views.per_view) and everything else
    is elementwise: either way each view's outputs are the bits of its
    own call, and the single view is this path at V = 1."""
    batched = viewmat.dim() == 3
    if not batched:
        means, scales, quats = means[None], scales[None], quats[None]
        viewmat, projmat = viewmat[None], projmat[None]
        fx, fy, cx, cy = [fx], [fy], [cx], [cy]
        if valid_mask is not None:
            valid_mask = valid_mask[None]
        if opacities is not None:
            opacities = opacities[None]
    args = (means.to(torch.float32), scales, glob_scale, quats, viewmat,
            projmat, fx, fy, cx, cy, img_height, img_width, clip_thresh,
            valid_mask, opacities, alpha_thresh, fov_width, fov_height,
            row_offset)
    count("project.calls")
    if means.is_cuda:
        before = kproject.run_forward.launches
        *fields, front = kproject.project(*args)
        out = ProjectedGaussians(*fields)
        global _in_front
        _in_front = front
        count("project.rows", front.numel())
        if kproject.run_forward.launches != before:
            count("project.fused")
    else:
        out = _project_views(*args)
    # a single view drops the view axis by squeeze, whose backward
    # reshapes the gradient (t[0]'s scatters it into zeros)
    return out if batched else ProjectedGaussians(*(t.squeeze(0)
                                                    for t in out))


def _view_col(vals, device) -> torch.Tensor:
    """V per-view scalars as a float32 (V, 1) column, each rounded as a
    Python scalar operand is."""
    vals = [float(v) for v in vals]
    with host_sync("view_cols", device):
        col = torch.tensor(vals, dtype=torch.float32, device=device)
    return col[:, None]


def _project_views(means, scales, glob_scale, quats, viewmat, projmat, fx,
                   fy, cx, cy, img_height, img_width, clip_thresh,
                   valid_mask, opacities, alpha_thresh, fov_width,
                   fov_height, row_offset) -> ProjectedGaussians:
    dev = means.device
    views = viewmat.shape[0]
    col = lambda vals: _view_col(vals, dev)
    R_vm = viewmat[:, :3, :3]
    p_view = per_view(lambda m, vm: m @ vm[:3, :3].T + vm[:3, 3], views,
                      means, viewmat)  # (V, N, 3)
    z = p_view[..., 2]

    fov_w = fov_width if fov_width is not None else img_width
    fov_h = fov_height if fov_height is not None else img_height
    lim_x = col(1.3 * (0.5 * fov_w / f) for f in fx)
    lim_y = col(1.3 * (0.5 * fov_h / f) for f in fy)
    # a row in the clip slab is culled; its terms are evaluated at depth
    # 1, so that they stay finite and its gradient is 0 (near depth 0 the
    # 2D covariance's a * c overflows float32 and the conic turns NaN)
    slab = z.abs() < clip_thresh
    z_safe = torch.where(slab, 1.0, z)
    tx = z * torch.clamp(p_view[..., 0] / z_safe, -lim_x, lim_x)
    ty = z * torch.clamp(p_view[..., 1] / z_safe, -lim_y, lim_y)
    rz = 1.0 / z_safe
    rz2 = rz * rz

    fx_c, fy_c = col(fx), col(fy)
    j00 = fx_c * rz
    j02 = -fx_c * tx * rz2
    j11 = fy_c * rz
    j12 = -fy_c * ty * rz2
    t_row0 = [j00 * R_vm[:, 0, k, None] + j02 * R_vm[:, 2, k, None]
              for k in range(3)]
    t_row1 = [j11 * R_vm[:, 1, k, None] + j12 * R_vm[:, 2, k, None]
              for k in range(3)]

    R = quat_to_rotmat(quats)
    s_cols = [glob_scale * scales[..., j] for j in range(3)]
    v0 = [
        (t_row0[0] * R[..., 0, j] + t_row0[1] * R[..., 1, j]
         + t_row0[2] * R[..., 2, j]) * s_cols[j]
        for j in range(3)
    ]
    v1 = [
        (t_row1[0] * R[..., 0, j] + t_row1[1] * R[..., 1, j]
         + t_row1[2] * R[..., 2, j]) * s_cols[j]
        for j in range(3)
    ]
    a = v0[0] * v0[0] + v0[1] * v0[1] + v0[2] * v0[2] + 0.3
    b_off = v0[0] * v1[0] + v0[1] * v1[1] + v0[2] * v1[2]
    c = v1[0] * v1[0] + v1[1] * v1[1] + v1[2] * v1[2] + 0.3

    det = a * c - b_off * b_off
    det_ok = det != 0.0
    det = torch.where(det_ok, det, torch.ones_like(det))
    inv_det = 1.0 / det
    conics = torch.stack([c * inv_det, -b_off * inv_det, a * inv_det], dim=-1)

    mid = 0.5 * (a + c)
    sq = torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    v_max = mid + sq
    radius_f = torch.ceil(3.0 * torch.sqrt(v_max))

    p_hom = per_view(lambda m, pm: m @ pm[:, :3].T + pm[:, 3], views,
                     means, projmat)
    w_hom = torch.where(slab, 1.0, p_hom[..., 3])
    rw = 1.0 / (w_hom + 1e-6)
    p_proj = p_hom[..., :3] * rw[..., None]
    if row_offset is None:
        u = 0.5 * img_width * p_proj[..., 0] + col(cx) - 0.5
        v = 0.5 * img_height * p_proj[..., 1] + col(cy) - 0.5
    else:
        u = 0.5 * (fov_width or img_width) * p_proj[..., 0] + col(cx) - 0.5
        v = 0.5 * fov_height * p_proj[..., 1] + col(cy) - 0.5 - row_offset
    xys = torch.stack([u, v], dim=-1)

    # tile bbox: integer geometry, no gradient
    tb_x = (img_width + BLOCK_X - 1) // BLOCK_X
    tb_y = (img_height + BLOCK_Y - 1) // BLOCK_Y
    with torch.no_grad():
        tcx = u / BLOCK_X
        tcy = v / BLOCK_Y
        radius_d = radius_f.detach()
        if opacities is not None:
            # opacity-aware bbox (binning only; radii keep 3 sigma)
            s_max = torch.log(
                torch.clamp(opacities.reshape(opacities.shape[0], -1),
                            min=1e-12) / alpha_thresh
            )
            r_alpha = torch.sqrt(2.0 * torch.clamp(s_max, min=0.0) * v_max) + 1.0
            bbox_radius = torch.where(
                s_max > 0.0, torch.minimum(radius_d, torch.ceil(r_alpha)),
                torch.zeros_like(radius_d),
            )
        else:
            bbox_radius = radius_d

        def tile_bbox(r):
            trx = r / BLOCK_X
            try_ = r / BLOCK_Y
            # int cast truncates toward zero; negatives clamp to 0
            tmin_x = torch.clamp((tcx - trx).to(torch.int32), 0, tb_x)
            tmax_x = torch.clamp((tcx + trx + 1.0).to(torch.int32), 0, tb_x)
            tmin_y = torch.clamp((tcy - try_).to(torch.int32), 0, tb_y)
            tmax_y = torch.clamp((tcy + try_ + 1.0).to(torch.int32), 0, tb_y)
            return tmin_x, tmax_x, tmin_y, tmax_y

        tmin_x, tmax_x, tmin_y, tmax_y = tile_bbox(bbox_radius)
        tile_area = (tmax_x - tmin_x) * (tmax_y - tmin_y)
        if opacities is None:
            vis_area = tile_area
        else:
            q0, q1, q2, q3 = tile_bbox(radius_d)
            vis_area = (q1 - q0) * (q3 - q2)

        front = z > clip_thresh
        mask = front & det_ok & (vis_area > 0)
        if valid_mask is not None:
            mask = mask & valid_mask
        radii = torch.where(mask, radius_d.to(torch.int32), 0).to(torch.int32)
        num_tiles_hit = torch.where(mask, tile_area, 0).to(torch.int32)

    global _in_front
    _in_front = front
    count("project.rows", z.numel())
    return ProjectedGaussians(
        xys=xys,
        depths=z,
        cam_depths=p_proj[..., 2],
        radii=radii,
        conics=conics,
        cov2d=torch.stack([a, b_off, c], dim=-1),
        num_tiles_hit=num_tiles_hit,
        tile_min=torch.stack([tmin_x, tmin_y], dim=-1),
        tile_max=torch.stack([tmax_x, tmax_y], dim=-1),
        mask=mask,
    )


def compute_cov2d_bounds(cov2d: torch.Tensor):
    """(conics, radii, valid) from packed 2D covariances (N, 3) = (a, b, c)
    (reference compute_cov2d_bounds_tensor)."""
    a, b, c = cov2d[:, 0], cov2d[:, 1], cov2d[:, 2]
    det = a * c - b * b
    valid = det != 0.0
    det_safe = torch.where(valid, det, torch.ones_like(det))
    inv_det = 1.0 / det_safe
    conics = torch.stack([c * inv_det, -b * inv_det, a * inv_det], dim=-1)
    conics = torch.where(valid[:, None], conics, torch.zeros_like(conics))
    mid = 0.5 * (a + c)
    sq = torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    radii = torch.ceil(3.0 * torch.sqrt(mid + sq))
    radii = torch.where(valid, radii, torch.zeros_like(radii))
    return conics, radii, valid
