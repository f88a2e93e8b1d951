"""Tile/depth binning: expand Gaussians to (Gaussian, tile) intersections,
sort by (tile, depth), and find per-tile ranges.

Counterpart of opensplat_tpu/ops/binning.py on its kernel path
(bin_gaussians with the expansion kernel: with the exact tile-ellipse
cull when given opacities, else the reference's full tile-bbox
intersections). The JAX package sizes the stream by a static budget for jit; here
it is sized exactly, with one device-to-host read of the candidate total
per call, as the reference does (rasterize_gaussians.cpp:62-63).

The sort is one stable torch.sort of the int64 key (tile << 32) |
depth_bits. The candidate stream is Gaussian-major, so stable order among
equal keys is ascending Gaussian id: the same order as the JAX package's
3-key (tile, depth, gid) sort. Culled rows carry the sentinel key and
sort to the tail, past every tile's range.

The sort's permutation is kept as `cand_index`: stream position i holds
candidate row cand_index[i], and Gaussian g's candidate rows are
cand_start[g] .. cand_start[g] + cand_count[g]. The backward writes each
record's gradient row at its candidate row, so the per-Gaussian segment
sum reads contiguous segments and needs no second sort.

A batch of V views of one image size (V scenes, or V cameras over one
state: the JAX package's vmapped steps) bins as one stream: the
projected fields (V, C, ...) are flattened view-major to (V * C, ...),
view v's tiles are v * T .. v * T + T - 1 of one key space, and one
cumsum, one host read of the total, one expand launch, one sort and one
searchsorted over V * T + 1 bounds serve every view. Each view's ranges,
records and order are those of binning the view alone.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..utils.metrics import host_sync, span
from .kernels.expand import expand
from .projection import BLOCK_X, BLOCK_Y, ProjectedGaussians
from .rasterize import ALPHA_THRESH


class BinnedGaussians(NamedTuple):
    """With V views, C below is V * C_view and T is V * T_view; n_isects
    and isect_counts are per view: (V,) and (V, C_view)."""
    gauss_ids: torch.Tensor  # (I,) int32 sorted by (tile, depth); C = culled
    tile_start: torch.Tensor  # (T,) int32
    tile_end: torch.Tensor  # (T,) int32
    n_isects: torch.Tensor  # () int64 kept intersections (post-cull)
    n_cands: int  # candidate rows (tile-bbox pairs) = I
    isect_counts: torch.Tensor  # (C,) int32 kept rows per Gaussian
    cand_index: torch.Tensor  # (I,) int32 candidate row of stream position
    cand_start: torch.Tensor  # (C,) int64 first candidate row per Gaussian
    cand_count: torch.Tensor  # (C,) int32 candidate rows per Gaussian


def num_tiles(height: int, width: int):
    return (
        (width + BLOCK_X - 1) // BLOCK_X,
        (height + BLOCK_Y - 1) // BLOCK_Y,
    )


def count_isects(proj: ProjectedGaussians) -> torch.Tensor:
    """Candidate (tile-bbox) count without binning: the JAX package's
    count_isects at align=1, sum(num_tiles_hit); (V,) per view for
    projections with a leading view axis."""
    return proj.num_tiles_hit.long().sum(-1)


def bin_gaussians(proj: ProjectedGaussians, height: int, width: int,
                  opacities: Optional[torch.Tensor] = None
                  ) -> BinnedGaussians:
    """With `opacities`, bin with the exact tile-ellipse cull: (Gaussian,
    tile) pairs whose alpha provably stays below ALPHA_THRESH over the
    whole tile are dropped; the rasterized output is unchanged. Without,
    every pair of each Gaussian's tile bbox is kept (forward.cu:87-94,
    the JAX bin_gaussians(opacities=None)); isect_counts is then
    num_tiles_hit. Projections with a leading view axis (V, C, ...) bin
    as one stream of V views (opacities (C,) shared or (V, C))."""
    with span("render.bin"):
        return _bin(proj, height, width, opacities)


def _bin(proj, height, width, opacities) -> BinnedGaussians:
    tb_x, tb_y = num_tiles(height, width)
    n_tiles = tb_x * tb_y
    dev = proj.xys.device
    batched = proj.num_tiles_hit.dim() == 2
    views = proj.num_tiles_hit.shape[0] if batched else 1
    per_view = proj.num_tiles_hit.shape[-1]
    cnt = proj.num_tiles_hit.reshape(-1).to(torch.int32).contiguous()
    cum = torch.cumsum(cnt.long(), 0)
    total = 0
    if cnt.numel():
        with host_sync("stream_total", dev):  # the one host read per call
            total = int(cum[-1])
    if total >= 2**31 or cnt.numel() >= 2**31:
        raise ValueError(
            f"bin_gaussians: {total} candidate rows of {cnt.numel()} "
            f"Gaussians; the stream and the Gaussians of all views must "
            f"each number below 2^31 (int32 ids)")
    starts = (cum - cnt.long()).contiguous()
    s_max = None
    if opacities is not None:
        s_max = torch.log(torch.clamp(
            opacities.reshape(-1).to(torch.float32), min=1e-12)
            / ALPHA_THRESH)
        if s_max.numel() != cnt.numel():  # one state's, every view's
            s_max = s_max.repeat(views)
        s_max = s_max.contiguous()

    def flat(t, dtype, cols):
        return t.detach().to(dtype).reshape(-1, cols).contiguous()

    keys, gids, kept = expand(
        cnt, starts, total,
        flat(proj.tile_min, torch.int32, 2),
        flat(proj.tile_max, torch.int32, 2),
        proj.depths.detach().to(torch.float32).reshape(-1).contiguous(),
        flat(proj.xys, torch.float32, 2),
        flat(proj.conics, torch.float32, 3),
        s_max, tb_x, n_tiles, per_view)
    keys_sorted, perm = torch.sort(keys, stable=True)
    gauss_ids = gids[perm]
    bounds = torch.arange(views * n_tiles + 1, dtype=torch.int64,
                          device=dev) << 32
    edges = torch.searchsorted(keys_sorted, bounds).to(torch.int32)
    n_isects = kept.reshape(views, per_view).long().sum(1)
    return BinnedGaussians(
        gauss_ids=gauss_ids.contiguous(),
        tile_start=edges[:-1].contiguous(),
        tile_end=edges[1:].contiguous(),
        n_isects=n_isects if batched else n_isects[0],
        n_cands=total,
        isect_counts=kept.reshape(views, per_view) if batched else kept,
        cand_index=perm.to(torch.int32),
        cand_start=starts,
        cand_count=cnt,
    )
