"""Scene forward pass: camera -> projection -> SH colours -> rasterize.

Counterpart of opensplat_tpu/models/splat_model.py::render_forward
(Model::forward, model.cpp:83-225) on the kernel path. The gradient of
the loss with respect to the screen-space centres (xys.retain_grad() in
the reference, model.cpp:171) comes through an additive `xys_shift`, as
in the JAX package.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .._device import resolve_device
from ..ops.binning import count_isects
from ..ops.camera import camera_matrices
from ..ops.kernels.integration import rasterize_fast
from ..ops.projection import project_gaussians
from ..ops.sh import spherical_harmonics
from .gaussians import GaussianParams

# NerfStudio default background (model.hpp:54)
DEFAULT_BACKGROUND = (0.6130, 0.0101, 0.3984)


class RenderOutputs(NamedTuple):
    rgb: torch.Tensor  # (H, W, 3)
    final_t: torch.Tensor  # (H, W)
    radii: torch.Tensor  # (C,) int32
    mask: torch.Tensor  # (C,) bool visible
    xys: torch.Tensor  # (C, 2)
    depths: torch.Tensor  # (C,)
    n_isects: torch.Tensor  # () kept intersections
    n_cands: torch.Tensor  # () candidate (tile-bbox) pairs
    n_grads: torch.Tensor  # () compact gradient-stream size (JAX meaning)


def render_forward(
    params: GaussianParams,
    alive: torch.Tensor,
    cam_to_world: torch.Tensor,
    fx: float,
    fy: float,
    cx: float,
    cy: float,
    height: int,
    width: int,
    sh_degrees_to_use: int,
    background: torch.Tensor,
    xys_shift: Optional[torch.Tensor] = None,
    renderer: str = "fast",
    device="cuda",
) -> RenderOutputs:
    """renderer "fast" (the JAX package's "pallas") runs the port's
    kernels; the dense and tiled conformance renderers come in a later
    slice."""
    dev = resolve_device(device)
    if renderer in ("dense", "tiled"):
        raise NotImplementedError(
            f"renderer={renderer!r}: the conformance renderers are ported in "
            "a later slice; use renderer='fast'")
    if renderer != "fast":
        raise ValueError(f"unknown renderer {renderer!r}")
    viewmat, full_proj, cam_pos = camera_matrices(
        cam_to_world.to(dev), fx, fy, width, height)
    opac = torch.sigmoid(params.opacities)
    proj = project_gaussians(
        params.means,
        torch.exp(params.scales),
        1.0,
        params.quats / torch.linalg.norm(params.quats, dim=-1, keepdim=True),
        viewmat,
        full_proj,
        fx, fy, cx, cy, height, width,
        valid_mask=alive,
        opacities=opac.detach(),  # opacity-aware tile bboxes (binning only)
    )
    xys = proj.xys if xys_shift is None else proj.xys + xys_shift

    # SH view directions from detached means (model.cpp:176-177)
    viewdirs = params.means.detach() - cam_pos
    viewdirs = viewdirs / torch.clamp(
        torch.linalg.norm(viewdirs, dim=-1, keepdim=True), min=1e-12)
    coeffs = torch.cat([params.features_dc[:, None, :], params.features_rest],
                       dim=1)
    rgbs = torch.clamp(
        spherical_harmonics(sh_degrees_to_use, viewdirs, coeffs) + 0.5,
        min=0.0)  # model.cpp:192

    n_cands = count_isects(proj)
    rgb, final_t, n_isects, n_grads = rasterize_fast(
        xys, proj.conics, rgbs, opac, proj.depths, proj.radii,
        proj.num_tiles_hit, proj.tile_min, proj.tile_max,
        background.to(dev), height, width, return_isects=True, device=dev)
    return RenderOutputs(
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
