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

from typing import Sequence

import torch

from ..config import TrainConfig
from ..models.gaussians import DensifyStats, GaussianParams, TrainState
from ..models.splat_model import DEFAULT_BACKGROUND, render_forward
from ..ops.ssim import main_loss, psnr
from ..optim.adam import adam_update
from ..train import leaf_grads, learning_rates


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


def render_batch_grads(state: TrainState, cam_to_world: torch.Tensor,
                       fx: Sequence[float], fy: Sequence[float],
                       cx: Sequence[float], cy: Sequence[float],
                       gt_images: torch.Tensor, height: int, width: int,
                       sh_deg: int, cfg: TrainConfig, renderer: str,
                       d_total: int):
    """Render the cameras of this device in one autograd graph and take
    the gradients of sum(losses) / d_total. Returns (that loss, the
    parameter gradients by name, the per-camera xys gradients (D, C, 2),
    radii (D, C), per-camera PSNR (D,), demand (3,) int64 = the largest
    [n_cands, n_isects, n_grads] over the cameras)."""
    dev = state.device
    capacity = state.alive.shape[0]
    background = torch.tensor(DEFAULT_BACKGROUND, dtype=torch.float32,
                              device=dev)
    leaves = {k: v.detach().requires_grad_(True)
              for k, v in state.params.as_dict().items()}
    d = len(fx)
    shifts = torch.zeros((d, capacity, 2), dtype=torch.float32, device=dev,
                         requires_grad=True)
    out = render_forward(
        GaussianParams(**leaves), state.alive, cam_to_world, fx, fy, cx, cy,
        height, width, sh_deg, background, xys_shift=shifts,
        renderer=renderer, device=dev)
    loss = 0.0
    for view_loss in main_loss(out.rgb, gt_images, cfg.ssim_weight):
        loss = loss + view_loss
    loss = loss / d_total
    g_params, g_shifts = leaf_grads(loss, leaves, shifts)
    with torch.no_grad():
        psnrs = psnr(out.rgb, gt_images)
        demand = torch.stack([t.to(torch.int64) for t in
                              (out.n_cands, out.n_isects, out.n_grads)], 1)
    return (loss.detach(), g_params, g_shifts, out.radii, psnrs,
            demand.amax(0))


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
    loss, g_params, g_xys, radii, psnr_b, demand = render_batch_grads(
        state, cam_to_world, fx, fy, cx, cy, gt_images, height, width,
        sh_deg, cfg, renderer, d)
    adam_update(state.params.as_dict(), g_params, state.opt,
                learning_rates(cfg, means_lr), state.alive)
    if accumulate:
        state.stats = accumulate_stats_batched(state.stats, g_xys, radii,
                                               height, width)
    metrics = {
        "loss": loss,
        "psnr": psnr_b.mean(),
        "n_visible": (radii > 0).sum(),
        "n_alive": state.alive.sum(),
        "demand": demand,
    }
    return state, metrics
