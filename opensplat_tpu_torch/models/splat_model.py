"""Scene forward pass: camera -> projection -> SH colours -> rasterize.

Counterpart of opensplat_tpu/models/splat_model.py: render_forward
(Model::forward, model.cpp:83-225) with the fast renderer (the port's
kernels) or the conformance renderers (dense and tiled), and
render_depth. The gradient of the loss with respect to the screen-space
centres (xys.retain_grad() in the reference, model.cpp:171) comes
through an additive `xys_shift`, as in the JAX package.

A batch of V views of one size (V cameras over one state, or V scenes
with stacked states: the JAX package's vmapped steps) renders in one
pass with the fast renderer: one launch of each kernel for every view.
The single view is that path at V = 1, so a view of a batch and a
single render run the same operations on the same values.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .._device import resolve_device
from ..ops.binning import count_isects
from ..ops.camera import camera_matrices
from ..ops.kernels.integration import rasterize_fast
from ..ops.projection import ProjectedGaussians, project_gaussians
from ..ops.rasterize import rasterize
from ..ops.rasterize_tiled import rasterize_tiled
from ..ops.sh import spherical_harmonics
from ..utils.metrics import span
from .gaussians import GaussianParams

# NerfStudio default background (model.hpp:54)
DEFAULT_BACKGROUND = (0.6130, 0.0101, 0.3984)


class RenderOutputs(NamedTuple):
    """A batch of V views gives each field a leading V."""
    rgb: torch.Tensor  # (H, W, 3)
    final_t: torch.Tensor  # (H, W)
    radii: torch.Tensor  # (C,) int32
    mask: torch.Tensor  # (C,) bool visible
    xys: torch.Tensor  # (C, 2)
    depths: torch.Tensor  # (C,)
    n_isects: torch.Tensor  # () kept intersections (tiled: candidates)
    n_cands: torch.Tensor  # () candidate (tile-bbox) pairs (0 for dense)
    n_grads: torch.Tensor  # () compact gradient-stream size (JAX meaning;
    #                        fast only)


def _project(params: GaussianParams, alive, viewmat, full_proj, fx, fy, cx,
             cy, height, width, fov_width=None, fov_height=None,
             row_offset=None) -> ProjectedGaussians:
    return project_gaussians(
        params.means,
        torch.exp(params.scales),
        1.0,
        params.quats / torch.linalg.norm(params.quats, dim=-1, keepdim=True),
        viewmat,
        full_proj,
        fx, fy, cx, cy, height, width,
        valid_mask=alive,
        # opacity-aware tile bboxes (binning only)
        opacities=torch.sigmoid(params.opacities).detach(),
        fov_width=fov_width,
        fov_height=fov_height,
        row_offset=row_offset,
    )


def _views_first(params: GaussianParams, alive, views: Optional[int]):
    """The parameters and alive mask with a leading state axis: V
    stacked states stay (V, C, ...), one state becomes (1, C, ...)."""
    if views is not None and params.means.dim() == 3:
        return params, alive
    return GaussianParams(**{k: v[None] for k, v in
                             params.as_dict().items()}), alive[None]


def render_forward(
    params: GaussianParams,
    alive: torch.Tensor,
    cam_to_world: torch.Tensor,
    fx,
    fy,
    cx,
    cy,
    height: int,
    width: int,
    sh_degrees_to_use: int,
    background: torch.Tensor,
    xys_shift: Optional[torch.Tensor] = None,
    renderer: str = "fast",
    device="cuda",
    fov_width: Optional[int] = None,
    fov_height: Optional[int] = None,
    row_offset: Optional[int] = None,
) -> RenderOutputs:
    """renderer "fast" (the JAX package's "pallas") runs the port's
    kernels; "dense" and "tiled" are the conformance renderers
    (ops/rasterize.py, ops/rasterize_tiled.py). A band of a larger
    image: fov_width/fov_height give the whole frame's size for the EWA
    clamp (the JAX package's bands shift cy as well); with row_offset
    the call renders rows [row_offset, row_offset + height) of the
    fov_width x fov_height frame (cx, cy the frame's), which equal the
    frame's own render of those rows (ops/projection.py).

    V views: cam_to_world (V, 4, 4), fx, fy, cx, cy V values each, the
    parameters one state's (C, ...) or V stacked states' (V, C, ...),
    alive (C,) or (V, C), xys_shift (V, C, 2), background (3,) or
    (V, 3). "fast" renders them in one pass; "dense" and "tiled" (the
    conformance paths) render view by view."""
    dev = resolve_device(device)
    if renderer not in ("fast", "dense", "tiled"):
        raise ValueError(f"unknown renderer {renderer!r}")
    views = cam_to_world.shape[0] if cam_to_world.dim() == 3 else None
    if views is not None and renderer != "fast":
        return _render_each(params, alive, cam_to_world, fx, fy, cx, cy,
                            height, width, sh_degrees_to_use, background,
                            xys_shift, renderer, dev, fov_width, fov_height,
                            row_offset)
    if views is None:
        cam_to_world, fx, fy, cx, cy = (cam_to_world[None], [fx], [fy],
                                        [cx], [cy])
        if xys_shift is not None:
            xys_shift = xys_shift[None]
    params, alive = _views_first(params, alive, views)
    frame = (width, height) if row_offset is None else (
        fov_width or width, fov_height)
    with span("render.project"):
        viewmat, full_proj, cam_pos = camera_matrices(
            cam_to_world.to(dev), fx, fy, *frame)
        opac = torch.sigmoid(params.opacities)
        proj = _project(params, alive, viewmat, full_proj, fx, fy, cx, cy,
                        height, width, fov_width, fov_height, row_offset)
        xys = proj.xys if xys_shift is None else proj.xys + xys_shift

        # SH view directions from detached means (model.cpp:176-177)
        viewdirs = params.means.detach() - cam_pos[:, None, :]
        viewdirs = viewdirs / torch.clamp(
            torch.linalg.norm(viewdirs, dim=-1, keepdim=True), min=1e-12)
        coeffs = torch.cat([params.features_dc[..., None, :],
                            params.features_rest], dim=-2)
        rgbs = torch.clamp(
            spherical_harmonics(sh_degrees_to_use, viewdirs, coeffs) + 0.5,
            min=0.0)  # model.cpp:192

    background = background.to(dev)
    if renderer == "fast":
        n_cands = count_isects(proj)
        rgb, final_t, n_isects, n_grads = rasterize_fast(
            xys, proj.conics, rgbs, opac, proj.depths, proj.radii,
            proj.num_tiles_hit, proj.tile_min, proj.tile_max, background,
            height, width, return_isects=True, device=dev)
    else:  # one view (a batch renders view by view, _render_each)
        proj = ProjectedGaussians(*(t[0] for t in proj))
        xys, rgbs, opac = xys[0], rgbs[0], opac[0]
        zero = torch.zeros((), dtype=torch.int64, device=dev)
        n_cands = n_isects = n_grads = zero
        if renderer == "dense":
            rgb, final_t = rasterize(xys, proj.conics, rgbs, opac,
                                     proj.depths, proj.mask, background,
                                     height, width)
        else:
            n_cands = n_isects = count_isects(proj)
            rgb, final_t = rasterize_tiled(
                xys, proj.conics, rgbs, opac, proj.depths, proj.radii,
                proj.num_tiles_hit, proj.tile_min, proj.tile_max,
                background, height, width)
    out = RenderOutputs(
        rgb=torch.clamp(rgb, max=1.0),  # model.cpp:222
        final_t=final_t,
        radii=proj.radii,
        mask=proj.mask,
        xys=xys,
        depths=proj.depths,
        n_isects=n_isects,
        n_cands=n_cands,
        n_grads=n_grads,
    )
    if views is None and renderer == "fast":
        out = RenderOutputs(*(t[0] for t in out))
    return out


def _render_each(params, alive, cam_to_world, fx, fy, cx, cy, height, width,
                 sh_deg, background, xys_shift, renderer, dev, fov_width,
                 fov_height, row_offset) -> RenderOutputs:
    """V views rendered one at a time (the conformance renderers), the
    outputs stacked."""
    stacked = params.means.dim() == 3
    outs = []
    for v in range(cam_to_world.shape[0]):
        p = GaussianParams(**{k: t[v] for k, t in params.as_dict().items()}
                           ) if stacked else params
        outs.append(render_forward(
            p, alive[v] if alive.dim() == 2 else alive, cam_to_world[v],
            fx[v], fy[v], cx[v], cy[v], height, width, sh_deg,
            background[v] if background.dim() == 2 else background,
            None if xys_shift is None else xys_shift[v], renderer, dev,
            fov_width, fov_height, row_offset))
    return RenderOutputs(*(torch.stack(ts) for ts in zip(*outs)))


def render_depth(
    params: GaussianParams,
    alive: torch.Tensor,
    cam_to_world: torch.Tensor,
    fx: float,
    fy: float,
    cx: float,
    cy: float,
    height: int,
    width: int,
    mode: str = "expected",
    device="cuda",
):
    """Depth-map render on the channel-generic tiled path (the nd_
    rasterization the reference exposes through gsplat,
    forward.cu:174-254), camera-space depth as the single channel.

    mode="accumulated": sum_i alpha_i T_i d_i (raw compositing weights);
    mode="expected":    accumulated / (1 - final_T), the expected depth
                        per pixel; pixels nothing hit are 0.

    Returns (depth (H, W), alpha (H, W)) with alpha = 1 - final_T.
    Differentiable: depth flows to the means through the projection."""
    if mode not in ("expected", "accumulated"):
        raise ValueError(f"unknown depth mode {mode!r}")
    dev = resolve_device(device)
    viewmat, full_proj, _ = camera_matrices(cam_to_world.to(dev), fx, fy,
                                            width, height)
    proj = _project(params, alive, viewmat, full_proj, fx, fy, cx, cy,
                    height, width)
    acc, final_t = rasterize_tiled(
        proj.xys, proj.conics,
        # CH = 1: camera-space z (ProjectedGaussians.depths; .cam_depths
        # is NDC z)
        proj.depths[:, None],
        torch.sigmoid(params.opacities), proj.depths, proj.radii,
        proj.num_tiles_hit, proj.tile_min, proj.tile_max,
        torch.zeros((1,), dtype=torch.float32, device=dev), height, width)
    depth = acc[..., 0]
    alpha = 1.0 - final_t
    if mode == "expected":
        depth = torch.where(alpha > 1e-6,
                            depth / torch.clamp(alpha, min=1e-6), 0.0)
    return depth, alpha
