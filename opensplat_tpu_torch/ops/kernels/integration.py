"""rasterize_fast: the differentiable tile rasterizer on the four kernels.

Counterpart of opensplat_tpu/ops/pallas/integration.py::rasterize_pallas
with the same contract: (img, final_t[, n_isects, n_grads]) and
gradients for xys, conics, colors, opacities and background. Binning
(expansion kernel + sort) runs without gradient; the forward kernel
renders; the backward kernel writes one gradient row per record at the
record's candidate row (`cand_index`, the tile sort's permutation), so
each Gaussian's rows are one contiguous segment of the Gaussian-major
candidate layout, and the segment-sum kernel reduces them per Gaussian
with no second sort. Streams are sized exactly, so there are no budgets
to overflow.
"""
from __future__ import annotations

import torch

from ..._device import resolve_device
from ...utils.metrics import span
from ..binning import bin_gaussians
from ..projection import ProjectedGaussians
from .raster import compact_grad_layout, rasterize_backward, rasterize_forward
from .segsum import segment_sum


class _RasterizeBinned(torch.autograd.Function):
    """The V views' fields flattened view-major (V * C, ...), one
    forward, backward and segment-sum launch for all of them."""

    @staticmethod
    def forward(ctx, xys, conics, colors, opac, background, gauss_ids,
                tile_start, tile_end, cand_index, cand_start, cand_count,
                height, width, views):
        args = [t.detach().to(torch.float32).contiguous()
                for t in (xys, conics, opac, colors, background)]
        img, final_t, fidx = rasterize_forward(
            gauss_ids, tile_start, tile_end, args[0], args[1], args[2],
            args[3], args[4], height, width, views)
        _, n_grads = compact_grad_layout(tile_start, tile_end, fidx, views)
        ctx.save_for_backward(*args, gauss_ids, tile_start, tile_end,
                              cand_index, cand_start, cand_count, final_t,
                              fidx)
        ctx.hw = (height, width, views)
        ctx.mark_non_differentiable(n_grads)
        return img, final_t, n_grads

    @staticmethod
    def backward(ctx, v_img, v_ft, _v_n):
        (xys, conics, opac, colors, background, gauss_ids, tile_start,
         tile_end, cand_index, cand_start, cand_count, final_t,
         fidx) = ctx.saved_tensors
        height, width, views = ctx.hw
        if v_img is None:
            v_img = torch.zeros(final_t.shape + (3,), device=xys.device)
        if v_ft is None:
            v_ft = torch.zeros_like(final_t)
        v_img = v_img.to(torch.float32).contiguous()
        v_ft = v_ft.to(torch.float32).contiguous()
        rows = rasterize_backward(
            gauss_ids, tile_start, tile_end, xys, conics, opac, colors,
            background, final_t, fidx, v_img, v_ft, cand_index, height,
            width, views)
        acc = segment_sum(rows, cand_start, cand_count)
        v_bg = None
        if ctx.needs_input_grad[4]:
            v_bg = torch.einsum("vhw,vhwc->vc", final_t, v_img)
            if background.dim() == 1:
                v_bg = v_bg.sum(0)
        return (acc[:, 0:2], acc[:, 2:5], acc[:, 6:9], acc[:, 5], v_bg,
                None, None, None, None, None, None, None, None, None)


def rasterize_fast(
    xys: torch.Tensor,
    conics: torch.Tensor,
    colors: torch.Tensor,
    opacities: torch.Tensor,
    depths: torch.Tensor,
    radii: torch.Tensor,
    num_tiles_hit: torch.Tensor,
    tile_min: torch.Tensor,
    tile_max: torch.Tensor,
    background: torch.Tensor,
    height: int,
    width: int,
    return_isects: bool = False,
    device="cuda",
):
    """Tile rasterization on the port's kernels; rasterize_pallas
    contract. With return_isects two outputs are appended: the kept
    intersection count n_isects and the compact gradient-stream size
    n_grads (JAX meaning, K = 256). Inputs must lie on `device`.

    V views of one image size go through one launch of each kernel:
    per-Gaussian inputs with a leading view axis (V, C, ...) (opacities
    may be one state's (C,) or (C, 1)), background (3,) or (V, 3); the
    outputs gain the view axis: (V, H, W, 3), (V, H, W) and the counts
    (V,). The single view is this path at V = 1."""
    dev = resolve_device(device)
    if xys.device.type != dev.type:
        raise ValueError(
            f"rasterize_fast: inputs are on {xys.device}, device={device!r}")
    batched = xys.dim() == 3
    if not batched:
        xys, conics, colors, depths, radii, num_tiles_hit, tile_min, \
            tile_max = (t[None] for t in (
                xys, conics, colors, depths, radii, num_tiles_hit, tile_min,
                tile_max))
    views, c = xys.shape[:2]
    opac = opacities.reshape(-1, c)
    if opac.shape[0] != views:  # one state's opacities, every view's
        opac = opac.expand(views, c)
    proj = ProjectedGaussians(
        xys=xys.detach(), depths=depths, cam_depths=depths, radii=radii,
        conics=conics.detach(), cov2d=conics.detach(),
        num_tiles_hit=num_tiles_hit, tile_min=tile_min, tile_max=tile_max,
        mask=radii > 0,
    )
    with torch.no_grad():
        binned = bin_gaussians(proj, height, width, opac.detach())
    with span("render.raster"):
        img, final_t, n_grads = _RasterizeBinned.apply(
            xys.reshape(-1, 2), conics.reshape(-1, 3), colors.reshape(-1, 3),
            opac.reshape(-1), background.to(torch.float32),
            binned.gauss_ids, binned.tile_start, binned.tile_end,
            binned.cand_index, binned.cand_start, binned.cand_count, height,
            width, views)
    n_isects = binned.n_isects
    if not batched:
        img, final_t, n_isects, n_grads = (
            img[0], final_t[0], n_isects[0], n_grads[0])
    if return_isects:
        return img, final_t, n_isects, n_grads
    return img, final_t
