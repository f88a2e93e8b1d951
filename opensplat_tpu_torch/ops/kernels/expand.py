"""Candidate expansion with the exact tile-ellipse cull (kernel 1).

Replaces opensplat_tpu/ops/pallas/expand.py::_expand_kernel
(pallas_expand_bin). CUDA source: csrc/expand.cu, bound by bytes. It is
candidate-row-parallel, as the TPU kernel is: one CTA of 256 threads per
block of 128 Gaussians stages their fields in shared memory, and
consecutive threads take consecutive rows of the block's contiguous row
window, so a large Gaussian spreads over the CTA and the stores are
coalesced (see the source note). The block windows come from `starts` and `cnt` on the
device. `expand_plain` is the same function in plain PyTorch; the wrapper
takes it only for CPU tensors. With s_max None both keep every row: the
reference's unculled tile-bbox intersections (the JAX package's
pallas_expand_bin(..., cull=False)).

The C Gaussians may be V views' projections concatenated view-major,
`per_view` a view (default: one view of C): Gaussian g belongs to view
v = g // per_view, and its tiles are numbered v * n_tiles + tile, so
one launch and one sort serve every view (the vmapped batch axis that
Pallas maps onto the TPU kernel's grid).

Outputs, for a stream of `total` candidate rows ordered Gaussian-major:
  keys (total,) int64  ((v * n_tiles + tile) << 32) | depth_bits, or the
                       sentinel ((V * n_tiles) << 32) | INT32_MAX for
                       culled rows
  gids (total,) int32  Gaussian id, or C for culled rows
  kept (C,) int32      rows kept per Gaussian
"""
from __future__ import annotations

import torch

from ..projection import BLOCK_X, BLOCK_Y
from ..rasterize import sigma_at
from . import _lib

INT32_MAX = 2**31 - 1


def _q16(v: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(v * 4.0), -32768.0, 32767.0)


def _bf16(v: torch.Tensor) -> torch.Tensor:
    return v.to(torch.bfloat16).to(torch.float32)  # round to nearest even


def min_sigma_over_tile(mx, my, A, B, C, tx, ty, pos_slack: float = 0.13):
    """Conservative lower bound of the Gaussian exponent over the tile's
    pixel rectangle, operation for operation as
    opensplat_tpu/ops/binning.py::_min_sigma_over_tile (A, B, C rounded
    to bf16 by the caller; the bound subtracts 2.1 * 2^-8 * S_corner)."""
    dhi_x = mx - tx * float(BLOCK_X) + pos_slack
    dlo_x = dhi_x - float(BLOCK_X - 1) - 2.0 * pos_slack
    dhi_y = my - ty * float(BLOCK_Y) + pos_slack
    dlo_y = dhi_y - float(BLOCK_Y - 1) - 2.0 * pos_slack
    inside = (dlo_x <= 0.0) & (dhi_x >= 0.0) & (dlo_y <= 0.0) & (dhi_y >= 0.0)
    c_safe = torch.clamp(C, min=1e-12)
    a_safe = torch.clamp(A, min=1e-12)

    def edge_x(xe):
        dy = torch.clamp(-B * xe / c_safe, dlo_y, dhi_y)
        return sigma_at(A, B, C, xe, dy)

    def edge_y(ye):
        dx = torch.clamp(-B * ye / a_safe, dlo_x, dhi_x)
        return sigma_at(A, B, C, dx, ye)

    m = torch.minimum(torch.minimum(edge_x(dlo_x), edge_x(dhi_x)),
                      torch.minimum(edge_y(dlo_y), edge_y(dhi_y)))
    s_corner = 0.5 * (A * torch.maximum(dlo_x * dlo_x, dhi_x * dhi_x)
                      + C * torch.maximum(dlo_y * dlo_y, dhi_y * dhi_y))
    return torch.where(inside, torch.zeros_like(m),
                       m - (2.1 * 2.0 ** -8) * s_corner)


def expand_plain(cnt, starts, total: int, tile_min, tile_max, depths, xys,
                 conics, s_max, tb_x: int, n_tiles: int, per_view=None):
    c = cnt.shape[0]
    per_view = _views(c, per_view)
    dev = cnt.device
    g = torch.repeat_interleave(torch.arange(c, device=dev), cnt.long(),
                                output_size=total)
    off = torch.arange(total, device=dev) - starts[g]
    tmin = tile_min.long()
    bw = torch.clamp(tile_max[:, 0].long() - tmin[:, 0], min=1)[g]
    tx = tmin[g, 0] + off % bw
    ty = tmin[g, 1] + off // bw

    if s_max is None:
        keep = torch.ones_like(g, dtype=torch.bool)
    else:
        mxq = _q16(xys[:, 0])
        myq = _q16(xys[:, 1])
        saturated = ((mxq >= 32767.0) | (mxq <= -32768.0)
                     | (myq >= 32767.0) | (myq <= -32768.0))[g]
        cb = _bf16(conics)
        ms = min_sigma_over_tile((mxq * 0.25)[g], (myq * 0.25)[g], cb[g, 0],
                                 cb[g, 1], cb[g, 2], tx.to(torch.float32),
                                 ty.to(torch.float32))
        keep = saturated | ((_bf16(s_max)[g] - ms) >= -0.05)

    depth_bits = depths.contiguous().view(torch.int32).long() & 0xFFFFFFFF
    sentinel = ((c // per_view * n_tiles) << 32) | INT32_MAX
    tile = (g // per_view) * n_tiles + ty * tb_x + tx
    keys = torch.where(keep, (tile << 32) | depth_bits[g],
                       torch.full_like(tx, sentinel))
    gids = torch.where(keep, g, torch.full_like(g, c)).to(torch.int32)
    kc = torch.cat([torch.zeros(1, dtype=torch.long, device=dev),
                    torch.cumsum(keep.long(), 0)])
    kept = (kc[starts + cnt.long()] - kc[starts]).to(torch.int32)
    return keys, gids, kept


def _views(c: int, per_view) -> int:
    """Gaussians a view: C (one view) by default; C must be whole views."""
    if per_view is None:
        return max(c, 1)
    if per_view < 1 or c % per_view:
        raise ValueError(f"expand: {c} Gaussians are not whole views of "
                         f"{per_view}")
    return int(per_view)


def expand(cnt, starts, total: int, tile_min, tile_max, depths, xys, conics,
           s_max, tb_x: int, n_tiles: int, per_view=None):
    """cnt (C,) int32 tile-bbox areas; starts (C,) int64 exclusive cumsum
    of cnt; total = sum(cnt); tile_min/max (C, 2) int32; depths (C,),
    xys (C, 2), conics (C, 3), s_max (C,) float32, or None to keep
    every row (no cull); per_view: Gaussians a view (C by default)."""
    if not cnt.is_cuda:
        return expand_plain(cnt, starts, total, tile_min, tile_max, depths,
                            xys, conics, s_max, tb_x, n_tiles, per_view)
    c = cnt.shape[0]
    per_view = _views(c, per_view)
    _lib.check(cnt, "cnt", torch.int32, (c,))
    _lib.check(starts, "starts", torch.int64, (c,))
    _lib.check(tile_min, "tile_min", torch.int32, (c, 2))
    _lib.check(tile_max, "tile_max", torch.int32, (c, 2))
    _lib.check(depths, "depths", torch.float32, (c,))
    _lib.check(xys, "xys", torch.float32, (c, 2))
    _lib.check(conics, "conics", torch.float32, (c, 3))
    if s_max is not None:
        _lib.check(s_max, "s_max", torch.float32, (c,))
    keys = torch.empty((total,), dtype=torch.int64, device=cnt.device)
    gids = torch.empty((total,), dtype=torch.int32, device=cnt.device)
    kept = torch.empty((c,), dtype=torch.int32, device=cnt.device)
    p = _lib.ptr
    with _lib.timed("expand"):
        _lib.launch("osk_expand", c, per_view, p(cnt), p(starts),
                    p(tile_min), p(tile_max), p(depths), p(xys), p(conics),
                    None if s_max is None else p(s_max), tb_x, n_tiles,
                    int(s_max is not None), p(keys), p(gids), p(kept))
    expand.launches += 1
    return keys, gids, kept


expand.launches = 0


def kernel_info() -> dict:
    """The expansion kernel's build, from the CUDA runtime: Gaussians and
    threads per CTA, registers per thread, shared memory per CTA in bytes
    and resident CTAs per SM."""
    return _lib.kernel_info("osk_expand_info", (
        "gaussians_per_cta", "threads", "registers", "shared_bytes",
        "ctas_per_sm"))
