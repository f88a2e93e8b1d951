"""Gaussian-sharded rendering and training: the capacity axis lives
across the ranks of the mesh's `model` axis, for scenes too large for
one card's memory.

Counterpart of opensplat_tpu/parallel/gaussian_shard.py, one process per
rank (parallel/mesh.py):
  * every rank OWNS a capacity shard (params, Adam state, densify stats:
    memory scales 1/M);
  * per camera, each rank projects ITS shard against the whole frame and
    takes its visible rows; one small all_reduce finds the largest
    visible count V over the shards (one host read), and each rank packs
    its visible rows, padded with invisible ones to V, into one (V, K)
    float32 block (every parameter group, the xys shift and the alive
    flag). The JAX package compacts to a static budget V regrown from
    `max_shard_visible`; the port sizes V exactly each step;
  * ONE all-gather along `model` assembles the (M*V)-row visible set,
    and each rank rasterizes its own TILE-ROW BAND of the image against
    it: band_h rows from row m * band_h of the whole frame (render_
    forward's row_offset: the frame's projection with the centres moved
    up by the offset, an exact subtraction, and the frame's EWA clamp).
    The JAX package shifts cy and projects for the band instead, which
    rounds the centres differently, so its bands agree with the whole
    render to ~1e-5 but not bit for bit; the port's bands equal the
    whole frame's rows bit for bit;
  * the bands are gathered, rows past the image are cropped, and every
    rank computes the SAME whole-image loss (SSIM's 11x11 window crosses
    band edges; the JAX package computes the loss outside shard_map);
  * backward: the band gather's backward takes the rank's own band (the
    loss is replicated, so nothing is summed); the visible-set gather's
    backward sums every band's contribution and hands each owner its
    rows (reduce-scatter), and the row selection scatters them into the
    shard; densify statistics stay shard-local (each xys shift's
    gradient comes home the same way).

The hybrid (dpgs_train_step, n_data x n_model ranks) takes one camera
per data row: the same band render within each row, then the parameter
gradients summed over `data` and the densify statistics folded by
dp_trainer._fold_stats_dp (the rank-grid form of the JAX package's
_fold_stats_dp_batched: over ranks the batch axis is the data axis).

Refine keeps the unsharded semantics: the state is gathered, the ported
refine runs identically on every rank (its noise is a function of (seed,
step)) and each rank takes its shard back. Capacity grows in multiples
of lcm(capacity_round, M) so that shards stay equal.
"""
from __future__ import annotations

import math
from functools import partial
from typing import List, NamedTuple, Optional

import torch

from ..config import TrainConfig
from ..models.densify import accumulate_stats
from ..models.gaussians import (GaussianParams, TrainState, grow_capacity,
                                round_capacity, state_map)
from ..models.splat_model import render_forward
from ..ops.camera import camera_matrices
from ..ops.projection import project_gaussians
from ..ops.ssim import psnr
from ..train import Trainer, background, step_core
from .dp_trainer import _fold_stats_dp, sum_over_data
from .mesh import (Mesh, all_gather_replicated, all_gather_rows, make_mesh,
                   replicate, shard_params)


def shard_state(mesh: Mesh, state: TrainState) -> TrainState:
    """This rank's capacity shard of a whole state (model index m: rows
    [m C/M, (m+1) C/M) of every (C, ...) leaf)."""
    return shard_params(mesh, state, "model")


def unshard_state(mesh: Mesh, shard: TrainState) -> TrainState:
    """The whole state, gathered over the `model` axis on every rank of
    the data row (exact). Every rank of the row must call it."""
    return state_map(lambda x: mesh.all_gather(x, "model"), shard,
                     capacity_only=True)


def band_height(height: int, n_model: int) -> int:
    """Rows per rank's band, tile-aligned and padded so n_model bands
    cover any image height (the canvas is n_model * band_height rows;
    rows >= height are cropped after reassembly: tiles are independent,
    so the cropped region equals an unpadded render and the pad rows get
    no gradient)."""
    return 16 * ((height + 16 * n_model - 1) // (16 * n_model))


def _pack(params: GaussianParams, xys_shift, alive) -> torch.Tensor:
    c = alive.shape[0]
    return torch.cat([params.means, params.scales, params.quats,
                      params.features_dc, params.features_rest.reshape(c, -1),
                      params.opacities, xys_shift,
                      alive.to(torch.float32)[:, None]], dim=1)


def _unpack(g: torch.Tensor, n_rest: int):
    cols = g.split([3, 3, 4, 3, 3 * n_rest, 1, 2, 1], dim=1)
    params = GaussianParams(
        means=cols[0], scales=cols[1], quats=cols[2], features_dc=cols[3],
        features_rest=cols[4].reshape(g.shape[0], n_rest, 3),
        opacities=cols[5])
    return params, cols[6], cols[7][:, 0] > 0.5


def _gs_render_core(params: GaussianParams, alive: torch.Tensor,
                    xys_shift: torch.Tensor, cam_to_world: torch.Tensor,
                    fx: float, fy: float, cx: float, cy: float, height: int,
                    width: int, sh_deg: int, background: torch.Tensor,
                    renderer: str, mesh: Mesh):
    """Select, gather and render this rank's band. params/alive/xys_shift
    are the rank's shard. Returns (band rgb (band_h, W, 3), the shard's
    whole-frame radii, V = the largest visible count over the shards,
    demand (3,) int64 = the largest [n_cands, n_isects, n_grads] over
    the bands)."""
    dev = alive.device
    m = mesh.index["model"]
    band_h = band_height(height, mesh.shape["model"])
    with torch.no_grad():
        # whole-frame visibility of MY shard; for my rows its radii are
        # the unsharded render's, so the stats need no collective
        viewmat, projmat, _ = camera_matrices(cam_to_world.to(dev), fx, fy,
                                              width, height)
        proj = project_gaussians(
            params.means, torch.exp(params.scales), 1.0,
            params.quats / torch.linalg.norm(params.quats, dim=-1,
                                             keepdim=True),
            viewmat, projmat, fx, fy, cx, cy, height, width,
            valid_mask=alive)
        visible = proj.mask & alive
        v = int(mesh.pmax(visible.sum(), "model"))
        # visible rows first, in index order, padded with invisible ones
        idx = torch.cat([torch.nonzero(visible).squeeze(1),
                         torch.nonzero(~visible).squeeze(1)])[:v]
    sub = _pack(params, xys_shift, visible).index_select(0, idx)
    g_params, g_shift, g_alive = _unpack(
        all_gather_rows(sub, mesh, "model"), params.features_rest.shape[1])
    out = render_forward(
        g_params, g_alive, cam_to_world, fx, fy, cx, cy, band_h, width,
        sh_deg, background, xys_shift=g_shift, renderer=renderer,
        device=dev, fov_height=height, row_offset=m * band_h)
    demand = mesh.pmax(torch.stack([t.to(torch.int64) for t in
                                    (out.n_cands, out.n_isects,
                                     out.n_grads)]), "model")
    return out.rgb, proj.radii, v, demand


@torch.no_grad()
def gs_render(state: TrainState, cam_to_world: torch.Tensor, fx: float,
              fy: float, cx: float, cy: float, mesh: Mesh, height: int,
              width: int, sh_deg: int, renderer: str = "fast"):
    """Inference render of the Gaussian-sharded state. Every rank of the
    data row calls it and gets the whole image: (rgb (H, W, 3), V = the
    largest visible count over the shards, demand (3,) int64)."""
    dev = state.device
    band, _, v, demand = _gs_render_core(
        state.params, state.alive,
        torch.zeros((state.alive.shape[0], 2), device=dev), cam_to_world,
        fx, fy, cx, cy, height, width, sh_deg, background(dev), renderer,
        mesh)
    return mesh.all_gather(band, "model")[:height], v, demand


class _Frame(NamedTuple):
    """The banded render as step_core sees it: the whole image (in the
    graph, on every rank of the row), the shard's radii, V and demand."""
    rgb: torch.Tensor
    radii: torch.Tensor
    visible: int
    demand: torch.Tensor


def _band_render(state: TrainState, cam_to_world, fx, fy, cx, cy,
                 height: int, width: int, sh_deg: int, renderer: str,
                 mesh: Mesh):
    """step_core's render on the Gaussian-sharded state: this rank's
    band of one camera, the bands gathered into the whole image."""
    def render(params, shift, bg):
        band, radii, v, demand = _gs_render_core(
            params, state.alive, shift, cam_to_world, fx, fy, cx, cy, height,
            width, sh_deg, bg, renderer, mesh)
        return _Frame(all_gather_replicated(band, mesh, "model")[:height],
                      radii, v, demand)
    return render


def gs_train_step(state: TrainState, cam_to_world: torch.Tensor, fx: float,
                  fy: float, cx: float, cy: float, gt_image: torch.Tensor,
                  means_lr: float, mesh: Mesh, height: int, width: int,
                  sh_deg: int, cfg: TrainConfig, accumulate: bool,
                  renderer: str = "fast"):
    """One training step on the Gaussian-sharded state (this rank's
    shard, updated in place): banded render, gradients home to the
    owner shards, shard-local Adam and densify statistics. Every rank of
    the mesh calls it with the same camera. Metrics, equal on every
    rank: loss, psnr, n_visible, n_alive (whole model), max_shard_visible
    (V) and demand (4,) int64 [n_cands, n_isects, n_grads, V]."""
    def report(out, loss):
        n_visible, n_alive = mesh.psum(torch.stack(
            [(out.radii > 0).sum(), state.alive.sum()]), "model")
        return {
            "loss": loss,
            "psnr": psnr(out.rgb, gt_image),
            "n_visible": n_visible,
            "n_alive": n_alive,
            "max_shard_visible": out.visible,
            "demand": torch.cat([out.demand,
                                 out.demand.new_tensor([out.visible])]),
        }
    return state, step_core(
        state, _band_render(state, cam_to_world, fx, fy, cx, cy, height,
                            width, sh_deg, renderer, mesh),
        gt_image, cfg, means_lr,
        partial(accumulate_stats, height=height, width=width)
        if accumulate else None, report)


def dpgs_train_step(state: TrainState, cam_to_world: torch.Tensor,
                    fx: float, fy: float, cx: float, cy: float,
                    gt_image: torch.Tensor, means_lr: float, mesh: Mesh,
                    height: int, width: int, sh_deg: int, cfg: TrainConfig,
                    accumulate: bool, renderer: str = "fast"):
    """Hybrid camera-DP x Gaussian-MP step on an (n_data, n_model) mesh:
    one camera per data row (this rank's row's camera), the Gaussians
    sharded over `model` and replicated over `data`. The band render and
    the reduce-scatter run within each row; the parameter gradients are
    then summed over `data`, and the densify statistics take the
    D-sequential-reference fold over `data`. Updates the shard in place;
    metrics as gs_train_step's, over the whole batch (loss and psnr the
    means, n_visible the Gaussians visible to any camera)."""
    d_total = mesh.shape["data"]

    def fold(stats, g_xys, radii):
        return _fold_stats_dp(stats, g_xys[None], radii[None], height, width,
                              d_total, mesh)

    def report(out, loss_part):
        loss, psnr_sum = mesh.psum(torch.stack(
            [loss_part, psnr(out.rgb, gt_image)]), "data")
        seen = mesh.pmax((out.radii > 0).to(torch.int64), "data")
        n_visible, n_alive = mesh.psum(torch.stack(
            [seen.sum(), state.alive.sum()]), "model")
        demand4 = mesh.pmax(torch.cat([out.demand,
                                       out.demand.new_tensor([out.visible])]),
                            "data")
        return {
            "loss": loss,
            "psnr": psnr_sum / d_total,
            "n_visible": n_visible,
            "n_alive": n_alive,
            "max_shard_visible": demand4[3],
            "demand": demand4,
        }
    return state, step_core(
        state, _band_render(state, cam_to_world, fx, fy, cx, cy, height,
                            width, sh_deg, renderer, mesh),
        gt_image, cfg, means_lr, fold if accumulate else None, report,
        reduce=lambda loss: loss / d_total,
        sum_grads=partial(sum_over_data, mesh=mesh))


class GSTrainer(Trainer):
    """Trainer on Gaussian-sharded state (CLI --model-parallel).

    Drop-in for Trainer with the capacity axis sharded over the mesh's
    `model` ranks: each step gathers the visible rows, renders one image
    band per rank, returns the gradients to their owner shards and runs
    Adam and the densify statistics shard-local. With n_data > 1 the mesh
    is (data, model) and every step takes n_data cameras: hybrid
    camera-DP x Gaussian-MP through dpgs_train_step (CLI: --data-parallel
    D --model-parallel M together). `state` is this rank's shard;
    full_state() gathers the whole model. Every rank of the mesh must
    drive it in step."""

    def __init__(self, state: TrainState, cameras: List, cfg: TrainConfig,
                 renderer: str = "fast", mesh: Optional[Mesh] = None,
                 n_model: Optional[int] = None, n_data: int = 1,
                 device="cuda"):
        super().__init__(state, cameras, cfg, renderer=renderer,
                         device=device)
        if mesh is None:
            mesh = make_mesh(n_data=n_data, n_model=n_model or 1)
        self.mesh = mesh
        self.n_model = mesh.shape["model"]
        self.n_data = mesh.shape["data"]
        self.d_total = self.n_data  # one camera per data row
        cap = state.alive.shape[0]
        if cap % self._capacity_rounding():
            state = grow_capacity(
                state, round_capacity(cap + 1, self._capacity_rounding()))
        # every rank starts from rank 0's state, then keeps its shard
        self.state = shard_state(mesh, replicate(mesh, state))
        self._train_step = partial(
            dpgs_train_step if self.n_data > 1 else gs_train_step, mesh=mesh)

    def _capacity_rounding(self) -> int:
        return math.lcm(self.cfg.capacity_round, self.n_model)

    def full_state(self) -> TrainState:
        return unshard_state(self.mesh, self.state)

    def _draw(self, factor: int):
        """With n_data > 1 this rank's data row's camera of the step's
        batch, else Trainer's draw."""
        if self.n_data == 1:
            return super()._draw(factor)
        _, batch = self._sample_batch(factor)
        return batch[self.mesh.index["data"]]

    def _refine(self, step: int):
        """Trainer._refine on the gathered state, run alike on every rank,
        then this rank's shard of the result."""
        self.state = self.full_state()
        super()._refine(step)
        self.state = shard_state(self.mesh, self.state)

    def _render(self, cam_to_world, fx, fy, cx, cy, height, width, sh_deg):
        """gs_render: every rank of the data row calls it and gets the
        whole image."""
        return gs_render(self.state, cam_to_world, fx, fy, cx, cy, self.mesh,
                         height, width, sh_deg, self.renderer)[0]
