"""A batch of D cameras in one training step on one device.

Counterpart of opensplat_tpu/parallel/sharded_train.py. The D cameras
render as one batch of views over the shared state (render_forward with
D cameras, as the JAX package vmaps them): with the fast renderer one
launch of each kernel serves all D. Semantics, as in the JAX package:
  * the loss is the MEAN over the batch, so a step matches a D-camera
    reference average rather than D sequential steps (standard DP);
  * densify statistics reproduce D sequential reference steps
    (model.cpp:317-337, the first-accumulation quirk included: camera 0
    plays "the first step after a refine"): each camera gets its own
    xys_shift, and its gradient norms are multiplied by D to undo the
    mean's 1/D.
"""
from __future__ import annotations

from functools import partial
from typing import Sequence

import torch

from ..config import TrainConfig
from ..models.gaussians import DensifyStats, TrainState
from ..ops.ssim import psnr
from ..train import render_views, step_core


@torch.no_grad()
def accumulate_stats_batched(stats: DensifyStats, g_xys_b: torch.Tensor,
                             radii_b: torch.Tensor, height: int,
                             width: int) -> DensifyStats:
    """Fold a D-camera batch into the densify statistics with the
    reference's sequential-step semantics: g_xys_b (D, C, 2) are the
    gradients of the MEAN loss, radii_b (D, C). On the first
    accumulation after a refine camera 0 sets the norms of ALL Gaussians
    and counts start at 1 (model.cpp:321-323); cameras 1..D-1 add only
    where visible."""
    d = g_xys_b.shape[0]
    visible_b = radii_b > 0
    norms_b = torch.linalg.norm(g_xys_b, dim=-1) * d
    masked = torch.where(visible_b, norms_b, 0.0)
    init = ~stats.initialized
    norm_init = norms_b[0] + masked[1:].sum(0)
    norm_cont = stats.xys_grad_norm + masked.sum(0)
    counts_init = 1.0 + visible_b[1:].sum(0).to(torch.float32)
    counts_cont = stats.vis_counts + visible_b.sum(0).to(torch.float32)
    size_b = radii_b.to(torch.float32) / float(max(height, width))
    max2d_add = torch.where(visible_b, size_b, 0.0).amax(0)
    return DensifyStats(
        xys_grad_norm=torch.where(init, norm_init, norm_cont),
        vis_counts=torch.where(init, counts_init, counts_cont),
        max_2d_size=torch.maximum(stats.max_2d_size, max2d_add),
        initialized=torch.ones_like(stats.initialized),
    )


def batch_loss(d_total: int):
    """step_core's reduce for a camera batch: the views' losses summed in
    view order and divided by d_total, the cameras of the whole step."""
    def reduce(losses):
        loss = 0.0
        for view_loss in losses:
            loss = loss + view_loss
        return loss / d_total
    return reduce


def batch_demand(out) -> torch.Tensor:
    """(3,) int64: the largest [n_cands, n_isects, n_grads] over the
    views of a batch's render outputs."""
    return torch.stack([t.to(torch.int64) for t in
                        (out.n_cands, out.n_isects, out.n_grads)], 1).amax(0)


def batched_train_step(state: TrainState, cam_to_world: torch.Tensor,
                       fx: Sequence[float], fy: Sequence[float],
                       cx: Sequence[float], cy: Sequence[float],
                       gt_images: torch.Tensor, means_lr: float, height: int,
                       width: int, sh_deg: int, cfg: TrainConfig,
                       accumulate: bool, renderer: str = "fast"):
    """One step on D cameras (cam_to_world (D, 4, 4), intrinsics D
    floats each, gt_images (D, H, W, 3)). Updates `state` in place, as
    train_step_impl does, and returns (state, metrics): loss (the mean),
    psnr (the mean), n_visible (visible (camera, Gaussian) pairs),
    n_alive and demand (3,)."""
    d = len(fx)

    def report(out, loss):
        return {
            "loss": loss,
            "psnr": psnr(out.rgb, gt_images).mean(),
            "n_visible": (out.radii > 0).sum(),
            "n_alive": state.alive.sum(),
            "demand": batch_demand(out),
        }
    return state, step_core(
        state, render_views(state, cam_to_world, fx, fy, cx, cy, height,
                            width, sh_deg, renderer),
        gt_images, cfg, means_lr,
        partial(accumulate_stats_batched, height=height, width=width)
        if accumulate else None, report, views=(d,), reduce=batch_loss(d))
