"""Camera-data-parallel training over ranks, on the fast renderer.

Counterpart of opensplat_tpu/parallel/dp_trainer.py. Each rank renders
its own d_local cameras of the step's batch with the port's kernels, in
one autograd graph; the only collectives are one gradient sum over the
`data` axis (every parameter group in one all_reduce) and a few small
sums and maxima for the densify statistics and the metrics. Parameters
and Adam state are replicated: every rank applies the same Adam update
to the same summed gradient, so the replicas stay equal to the bit.
Densify statistics reproduce D sequential reference steps
(model.cpp:317-337, the first-accumulation quirk with global camera 0 as
"the first step"). Demand is the maximum over ranks.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from ..config import TrainConfig
from ..models.gaussians import PARAM_NAMES, DensifyStats, TrainState
from ..optim.adam import adam_update, means_lr_schedule
from ..train import (StepOutcome, Trainer, get_downscale_factor,
                     learning_rates, sh_degrees_for_step)
from .distributed import process_camera_slice
from .mesh import Mesh, make_mesh, replicate
from .sharded_train import render_batch_grads


@torch.no_grad()
def _fold_stats_dp(stats: DensifyStats, g_xys_local: torch.Tensor,
                   radii_local: torch.Tensor, height: int, width: int,
                   d_total: int, mesh: Mesh) -> DensifyStats:
    """The densify-stat fold of a camera batch dealt over the `data` axis
    (g_xys_local (dl, C, 2): this rank's cameras' gradients of the global
    mean loss; radii_local (dl, C)), with the sequential reference's
    semantics. Global camera 0 (data index 0, local slot 0) is the
    reference's "first accumulation after refine": its norms set ALL
    Gaussians' and counts start at 1 (model.cpp:321-323); later cameras
    add only where visible. Term for term the JAX fold's psum/pmax of
    rank-0-masked terms."""
    norms = torch.linalg.norm(g_xys_local, dim=-1) * d_total  # (dl, C)
    visible = radii_local > 0
    masked = torch.where(visible, norms, 0.0)
    is0 = float(mesh.index["data"] == 0)
    sum_masked, sum_vis, cam0_norm, cam0_masked, cam0_vis = mesh.psum(
        torch.stack([masked.sum(0), visible.sum(0).to(torch.float32),
                     norms[0] * is0, masked[0] * is0,
                     visible[0].to(torch.float32) * is0]), "data")
    size = radii_local.to(torch.float32) / float(max(height, width))
    max2d_add = mesh.pmax(torch.where(visible, size, 0.0).amax(0), "data")
    init = ~stats.initialized
    return DensifyStats(
        xys_grad_norm=torch.where(init, cam0_norm + (sum_masked - cam0_masked),
                                  stats.xys_grad_norm + sum_masked),
        vis_counts=torch.where(init, 1.0 + (sum_vis - cam0_vis),
                               stats.vis_counts + sum_vis),
        max_2d_size=torch.maximum(stats.max_2d_size, max2d_add),
        initialized=torch.ones_like(stats.initialized),
    )


def dp_train_step(state: TrainState, cam_to_world: torch.Tensor,
                  fx: Sequence[float], fy: Sequence[float],
                  cx: Sequence[float], cy: Sequence[float],
                  gt_images: torch.Tensor, means_lr: float, mesh: Mesh,
                  height: int, width: int, sh_deg: int, cfg: TrainConfig,
                  accumulate: bool, renderer: str = "fast"):
    """One camera-DP step. This rank's cameras: cam_to_world (dl, 4, 4),
    intrinsics dl floats each, gt_images (dl, H, W, 3); the batch is
    D = n_data * dl cameras. Every rank of the mesh calls it together.
    Updates `state` in place and returns (state, metrics): loss (the
    batch mean), psnr (the mean), n_visible (visible (camera, Gaussian)
    pairs over the batch), n_alive, demand (3,) int64 (the maximum over
    ranks), all equal on every rank."""
    d_total = mesh.shape["data"] * len(fx)
    loss_part, g_params, g_xys, radii, psnr_l, demand = render_batch_grads(
        state, cam_to_world, fx, fy, cx, cy, gt_images, height, width,
        sh_deg, cfg, renderer, d_total)
    # THE collective of DP: one gradient all_reduce over `data`
    summed = mesh.psum_many([g_params[k] for k in PARAM_NAMES], "data")
    g_params = dict(zip(PARAM_NAMES, summed))
    loss, psnr_sum = mesh.psum(torch.stack([loss_part, psnr_l.sum()]), "data")
    n_visible = mesh.psum((radii > 0).sum(), "data")
    adam_update(state.params.as_dict(), g_params, state.opt,
                learning_rates(cfg, means_lr), state.alive)
    if accumulate:
        state.stats = _fold_stats_dp(state.stats, g_xys, radii, height,
                                     width, d_total, mesh)
    metrics = {
        "loss": loss,
        "psnr": psnr_sum / d_total,
        "n_visible": n_visible,
        "n_alive": state.alive.sum(),
        "demand": mesh.pmax(demand, "data"),
    }
    return state, metrics


class DPTrainer(Trainer):
    """Trainer that runs camera-DP steps over the ranks of a mesh.

    Drop-in for Trainer (the same run_step/render/refine surface, from
    the CLI's --data-parallel): every step samples n_data * d_local
    cameras (the same on every rank: same sampler seed), renders this
    rank's d_local of them, sums gradients over the ranks and runs the
    refine machine on the replicated state, identically on every rank.
    Cameras are bucketed by image size so a batch is always one size
    (Trainer._sample_batch). Every rank of the mesh must drive it in
    step."""

    def __init__(self, state: TrainState, cameras: List, cfg: TrainConfig,
                 renderer: str = "fast", mesh: Optional[Mesh] = None,
                 n_data: Optional[int] = None, d_local: int = 1,
                 device="cuda"):
        super().__init__(state, cameras, cfg, renderer=renderer,
                         device=device)
        self.mesh = mesh if mesh is not None else make_mesh(n_data=n_data)
        if self.mesh.shape["model"] != 1:
            raise ValueError("DPTrainer: the mesh's model axis must be 1 "
                             "(GSTrainer shards the Gaussians)")
        self.n_data = self.mesh.shape["data"]
        self.d_local = d_local
        self.d_total = self.n_data * d_local
        # every rank starts from rank 0's state, so the replicas agree
        self.state = replicate(self.mesh, self.state)

    def run_step(self, step: int) -> StepOutcome:
        cfg = self.cfg
        factor = get_downscale_factor(step, cfg)
        (h, w), batch = self._sample_batch(factor)
        self.last_hw = (h, w)
        start, count = process_camera_slice(self.d_total, self.mesh)
        mine = batch[start:start + count]
        cams = [c for c, _ in mine]
        c2w = torch.as_tensor(
            np.stack([np.asarray(c.cam_to_world, np.float32) for c in cams]),
            device=self.device)
        self.state, metrics = dp_train_step(
            self.state, c2w, [c.fx / factor for c in cams],
            [c.fy / factor for c in cams], [c.cx / factor for c in cams],
            [c.cy / factor for c in cams],
            torch.stack([g for _, g in mine]),
            means_lr_schedule(cfg.lr_means, cfg.lr_means_final,
                              cfg.num_iters, step - 1),
            self.mesh, h, w, sh_degrees_for_step(step, cfg), cfg,
            accumulate=step < cfg.stop_split_at, renderer=self.renderer)
        self._note_demand(step, (h, w), metrics["demand"])
        if step % cfg.refine_every == 0 and step > cfg.warmup_length:
            self._refine(step)
        return StepOutcome(metrics)
