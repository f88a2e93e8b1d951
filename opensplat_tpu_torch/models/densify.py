"""Per-step densification statistics.

Counterpart of opensplat_tpu/models/densify.py::accumulate_stats
(model.cpp:317-337). refine_step and count_refine_needs come with the
next port slice.
"""
from __future__ import annotations

import torch

from .gaussians import DensifyStats


@torch.no_grad()
def accumulate_stats(stats: DensifyStats, xys_grad: torch.Tensor,
                     radii: torch.Tensor, height: int,
                     width: int) -> DensifyStats:
    """On the first accumulation after a refine, vis_counts is 1 for ALL
    Gaussians, visible or not (model.cpp:321-323)."""
    visible = radii > 0
    grads = torch.linalg.norm(xys_grad, dim=-1)
    init = ~stats.initialized
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
