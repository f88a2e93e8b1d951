"""Densify / duplicate / cull / alpha-reset under fixed capacity.

Counterpart of opensplat_tpu/models/densify.py (Model::afterTrain,
model.cpp:311-494): the thresholds, the 1.6 split factor, two samples per
split, split-parent culling and the reset schedule are the reference's.
New Gaussians are written into dead capacity slots and culled ones are
masked dead; the host decides which refine to run (densify, reset and
their flags are functions of the step) and grows capacity first with
`count_refine_needs` and `grow_capacity`. Refine is host-driven: it reads
slot counts back (torch.nonzero), which syncs with the device.

The reference's quirks, kept as the JAX package keeps them:
  * on the first accumulation after a refine, vis_counts is set to 1 for
    ALL Gaussians, visible or not (model.cpp:321-323);
  * split sample positions use the PRE-shrink scales, the dup test the
    POST-shrink scales (model.cpp:360-378 execution order);
  * the opacity/size cull applies to the just-added Gaussians too
    (model.cpp:429), and the huge-cull's screen-size test reads the
    pre-refine max_2d_size;
  * free slots are taken in index order: children of splits first (all
    first children, then all second children), then duplicates.

Split noise is two (C, 3) standard-normal draws from a torch.Generator
(the JAX package folds the step into its PRNG key, which no torch
generator reproduces); `refine_step` also takes the draws directly.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..ops.tensor_math import quat_to_rotmat
from ..optim.adam import AdamState
from .gaussians import DensifyStats, GaussianParams, TrainState, zero_stats


@torch.no_grad()
def accumulate_stats(stats: DensifyStats, xys_grad: torch.Tensor,
                     radii: torch.Tensor, height: int,
                     width: int) -> DensifyStats:
    """On the first accumulation after a refine, vis_counts is 1 for ALL
    Gaussians, visible or not (model.cpp:321-323). Stacked states' stats
    (V, C) with initialized (V,) take (V, C, 2) gradients and (V, C)
    radii, each scene's row as its own call."""
    visible = radii > 0
    grads = torch.linalg.norm(xys_grad, dim=-1)
    init = (~stats.initialized)[..., None]
    new_norm = torch.where(
        init, grads,
        torch.where(visible, stats.xys_grad_norm + grads, stats.xys_grad_norm))
    new_counts = torch.where(
        init, torch.ones_like(stats.vis_counts),
        torch.where(visible, stats.vis_counts + 1.0, stats.vis_counts))
    size = radii.to(torch.float32) / float(max(height, width))
    new_max2d = torch.where(visible, torch.maximum(stats.max_2d_size, size),
                            stats.max_2d_size)
    return DensifyStats(
        xys_grad_norm=new_norm,
        vis_counts=new_counts,
        max_2d_size=new_max2d,
        initialized=torch.ones_like(stats.initialized),
    )


def _split_dup_masks(params: GaussianParams, stats: DensifyStats,
                     alive: torch.Tensor, maxwh: float, cfg,
                     use_screen_size: bool):
    avg = stats.xys_grad_norm / torch.clamp(stats.vis_counts, min=1.0) \
        * 0.5 * maxwh
    high = (avg > cfg.densify_grad_thresh) & alive
    scale_max = torch.exp(params.scales).amax(dim=-1)
    splits = scale_max > cfg.densify_size_thresh
    if use_screen_size:
        splits = splits | (stats.max_2d_size > cfg.split_screen_size)
    splits = splits & high
    # the dup test runs on post-shrink scales (model.cpp:374-378)
    scale_max_after = torch.where(splits, scale_max / cfg.split_size_fac,
                                  scale_max)
    dups = (scale_max_after <= cfg.densify_size_thresh) & high
    return splits, dups


@torch.no_grad()
def count_refine_needs(state: TrainState, maxwh: float, cfg,
                       use_screen_size: bool) -> Tuple[int, int, int]:
    """(n_alive, n_free, n_needed), so the host can grow capacity first."""
    splits, dups = _split_dup_masks(state.params, state.stats, state.alive,
                                    maxwh, cfg, use_screen_size)
    n_alive = int(state.alive.sum())
    c = state.alive.shape[0]
    needed = cfg.n_split_samples * int(splits.sum()) + int(dups.sum())
    return n_alive, c - n_alive, needed


def _scatter_rows(arr: torch.Tensor, rows: torch.Tensor, dst: torch.Tensor,
                  values: torch.Tensor) -> torch.Tensor:
    """A copy of arr with arr[dst] = values[rows]; the caller has already
    dropped the rows whose destination is the sentinel C."""
    out = arr.clone()
    out[dst] = values[rows]
    return out


def _place_candidates(params: GaussianParams, mu: Dict[str, torch.Tensor],
                      nu: Dict[str, torch.Tensor], alive: torch.Tensor,
                      dst: torch.Tensor, cand: GaussianParams):
    """Write candidate Gaussians into free slots dst (C = dropped) and zero
    their Adam moments."""
    c = alive.shape[0]
    rows = torch.nonzero(dst < c).squeeze(1)
    d = dst[rows]
    cd = cand.as_dict()
    new_params = GaussianParams(**{
        k: _scatter_rows(v, rows, d, cd[k])
        for k, v in params.as_dict().items()})
    new_mu, new_nu = {}, {}
    for k in mu:
        new_mu[k] = mu[k].clone()
        new_mu[k][d] = 0.0
        new_nu[k] = nu[k].clone()
        new_nu[k][d] = 0.0
    new_alive = alive.clone()
    new_alive[d] = True
    return new_params, new_mu, new_nu, new_alive


def _f32(x: float, device) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=device)


@torch.no_grad()
def refine_step(
    state: TrainState,
    maxwh: float,
    cfg,
    use_screen_size: bool,
    do_densification: bool,
    do_cull_huge: bool,
    do_reset: bool,
    generator: Optional[torch.Generator] = None,
    noise: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> Tuple[TrainState, dict]:
    """One refine (the body of model.cpp:339-494). Returns a new state and
    metrics as 0-d tensors: added, dropped, culled, n_splits, n_dups (when
    densifying) and n_alive.

    The flags are host-known functions of the step and config:
      do_densification = step < stop_split_at and
                         step % reset_interval > num_cameras + refine_every
      do_cull_huge     = step > refine_every * reset_alpha_every
      do_reset         = step < stop_split_at and
                         step % reset_interval == refine_every
      use_screen_size  = step < stop_screen_size_at
    Split noise: `noise` = (eps0, eps1), two (C, 3) float32 tensors on the
    state's device, or else two standard-normal draws from `generator`."""
    params = state.params
    alive = state.alive
    mu, nu = state.opt.mu, state.opt.nu
    dev = state.device
    c = alive.shape[0]
    metrics = {}

    if do_densification:
        splits, dups = _split_dup_masks(params, state.stats, alive, maxwh,
                                        cfg, use_screen_size)
        n_splits = splits.sum()
        n_dups = dups.sum()
        if noise is None:
            noise = tuple(torch.randn((c, 3), generator=generator,
                                      device=dev) for _ in range(2))
        for eps in noise:
            if eps.shape != (c, 3) or eps.device != dev:
                raise ValueError(f"refine_step: noise must be ({c}, 3) on "
                                 f"{dev}, got {tuple(eps.shape)} on "
                                 f"{eps.device}")

        # children sampled with PRE-shrink scales (model.cpp:360-365)
        old_scales_exp = torch.exp(params.scales)
        qn = params.quats / torch.linalg.norm(params.quats, dim=-1,
                                              keepdim=True)
        rots = quat_to_rotmat(qn)  # (C, 3, 3)
        shrunk_log = params.scales - torch.log(_f32(cfg.split_size_fac, dev))

        def split_children(eps):
            offsets = torch.einsum("cij,cj->ci", rots, old_scales_exp * eps)
            return GaussianParams(
                means=params.means + offsets, scales=shrunk_log,
                quats=params.quats, features_dc=params.features_dc,
                features_rest=params.features_rest,
                opacities=params.opacities)

        child0 = split_children(noise[0])
        child1 = split_children(noise[1])
        # shrink split parents (model.cpp:374); duplicates copy the
        # post-shrink values (model.cpp:380-385)
        params = GaussianParams(**{
            **params.as_dict(),
            "scales": torch.where(splits[:, None], shrunk_log, params.scales)})
        dup_cand = params

        # slot allocation: dead slots in index order, sentinel C = dropped
        free = torch.nonzero(~alive).squeeze(1)
        free = torch.cat([free, free.new_full((1,), c)])
        n_free = free.shape[0] - 1

        def take_free(i):
            return free[i.clamp(0, n_free)]

        split_rank = torch.cumsum(splits.long(), 0) - 1
        dup_rank = torch.cumsum(dups.long(), 0) - 1
        dst0 = torch.where(splits, take_free(split_rank), c)
        dst1 = torch.where(splits, take_free(n_splits + split_rank), c)
        dstd = torch.where(dups, take_free(2 * n_splits + dup_rank), c)
        for dst, cand in ((dst0, child0), (dst1, child1), (dstd, dup_cand)):
            params, mu, nu, alive = _place_candidates(params, mu, nu, alive,
                                                      dst, cand)

        # dropped candidates (capacity overflow; the host grows first)
        placed = (((dst0 < c) & splits).sum() + ((dst1 < c) & splits).sum()
                  + ((dstd < c) & dups).sum())
        metrics["added"] = placed
        metrics["dropped"] = cfg.n_split_samples * n_splits + n_dups - placed

        # cull (model.cpp:425-462): old AND new Gaussians
        culls = (torch.sigmoid(params.opacities[:, 0])
                 < cfg.cull_alpha_thresh) & alive
        culls = culls | splits  # split parents are replaced by children
        if do_cull_huge:
            huge = torch.exp(params.scales).amax(dim=-1) > cfg.cull_scale_thresh
            if use_screen_size:
                # the pre-refine stats; new slots had max_2d_size 0
                huge = huge | (state.stats.max_2d_size > cfg.cull_screen_size)
            culls = culls | (huge & alive)
        alive = alive & ~culls
        metrics["culled"] = culls.sum()
        metrics["n_splits"] = n_splits
        metrics["n_dups"] = n_dups

    if do_reset:
        # alpha reset (model.cpp:464-479)
        reset_logit = torch.log(_f32(cfg.cull_alpha_thresh * 2.0, dev)
                                / (1.0 - cfg.cull_alpha_thresh * 2.0))
        params = GaussianParams(**{
            **params.as_dict(),
            "opacities": torch.minimum(params.opacities, reset_logit)})
        mu = {**mu, "opacities": torch.zeros_like(mu["opacities"])}
        nu = {**nu, "opacities": torch.zeros_like(nu["opacities"])}

    metrics["n_alive"] = alive.sum()
    return TrainState(
        params=params,
        alive=alive,
        opt=AdamState(mu=mu, nu=nu, count=state.opt.count),
        stats=zero_stats(c, dev),  # model.cpp:482-484
    ), metrics
