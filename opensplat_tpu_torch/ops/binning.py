"""Tile/depth binning: expand Gaussians to (Gaussian, tile) intersections,
sort by (tile, depth), and find per-tile ranges.

Counterpart of opensplat_tpu/ops/binning.py on its kernel path
(bin_gaussians with the expansion kernel and the exact tile-ellipse
cull). The JAX package sizes the stream by a static budget for jit; here
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
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .kernels.expand import expand
from .projection import BLOCK_X, BLOCK_Y, ProjectedGaussians
from .rasterize import ALPHA_THRESH


class BinnedGaussians(NamedTuple):
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
    count_isects at align=1, sum(num_tiles_hit)."""
    return torch.sum(proj.num_tiles_hit.long())


def bin_gaussians(proj: ProjectedGaussians, height: int, width: int,
                  opacities: torch.Tensor) -> BinnedGaussians:
    """Bin with the exact tile-ellipse cull: (Gaussian, tile) pairs whose
    alpha provably stays below ALPHA_THRESH over the whole tile are
    dropped; the rasterized output is unchanged."""
    tb_x, tb_y = num_tiles(height, width)
    n_tiles = tb_x * tb_y
    dev = proj.xys.device
    cnt = proj.num_tiles_hit.to(torch.int32).contiguous()
    cum = torch.cumsum(cnt.long(), 0)
    total = int(cum[-1]) if cnt.numel() else 0  # the one host read per call
    starts = (cum - cnt.long()).contiguous()
    s_max = torch.log(
        torch.clamp(opacities.reshape(-1).to(torch.float32), min=1e-12)
        / ALPHA_THRESH
    )
    keys, gids, kept = expand(
        cnt, starts, total,
        proj.tile_min.to(torch.int32).contiguous(),
        proj.tile_max.to(torch.int32).contiguous(),
        proj.depths.detach().to(torch.float32).contiguous(),
        proj.xys.detach().to(torch.float32).contiguous(),
        proj.conics.detach().to(torch.float32).contiguous(),
        s_max.contiguous(), tb_x, n_tiles,
    )
    keys_sorted, perm = torch.sort(keys, stable=True)
    gauss_ids = gids[perm]
    bounds = torch.arange(n_tiles + 1, dtype=torch.int64, device=dev) << 32
    edges = torch.searchsorted(keys_sorted, bounds).to(torch.int32)
    return BinnedGaussians(
        gauss_ids=gauss_ids.contiguous(),
        tile_start=edges[:-1].contiguous(),
        tile_end=edges[1:].contiguous(),
        n_isects=torch.sum(kept.long()),
        n_cands=total,
        isect_counts=kept,
        cand_index=perm.to(torch.int32),
        cand_start=starts,
        cand_count=cnt,
    )
