"""Tile-binned rasterizer over the sorted intersection stream (plain
PyTorch around the expansion and segment-sum kernels).

Counterpart of opensplat_tpu/ops/rasterize_tiled.py: the same semantics
and gradients as the dense renderer (ops/rasterize.py), with work
proportional to the intersection count as in the reference CUDA kernel
(forward.cu:256-378), and channel-generic (colours (N, CH), the
reference's nd_ functions).

Binning is the port's bin_gaussians with the exact tile-ellipse cull,
sized exactly: the expansion kernel, one sort, the tile ranges. The cull
drops only (Gaussian, tile) pairs whose alpha stays below 1/255 over the
whole tile, so the image is the one the JAX package's unculled, budgeted
stream gives. The stream, sorted by (tile, depth), is scanned in chunks
of `chunk_size`; within a chunk every record composites into its tile's
16x16 = 256 pixels as a (K, 256) block, front to back as a segmented
(per tile run) cumulative sum in log space. The per-tile carry (T, done,
colour, final_idx) lives in (tiles, 256) tensors written at run
boundaries with unique indices (rows of records that write nothing go
to per-row spare rows past the tiles), so every step is deterministic
and uses no atomics.

Early termination follows the reference: the forward records per pixel
the global stream index of the record that crossed T <= 1e-4
(`final_idx`, the CUDA kernel's final_index, forward.cu:367-377) — the
first stop of a tile run, found by integer prefix sums within the chunk.
The backward replays back to front and recovers T by division from the
final T (backward.cu:161-355, gsplat_cpu.cpp:313-372) with the 0.99
clamp. Each record's gradient row is written at its candidate row
(`cand_index`), and the per-Gaussian sums come from the segment-sum
kernel over each Gaussian's contiguous candidate rows, in 9-column
groups (2 + 3 + 1 + CH columns padded to a multiple of 9). On CUDA
tensors the expansion and segment-sum kernels launch or raise.
"""
from __future__ import annotations

from typing import Tuple

import torch

from .binning import bin_gaussians, num_tiles
from .kernels.raster import image_to_tiles, tiles_to_image
from .kernels.segsum import segment_sum
from .projection import BLOCK_X, BLOCK_Y, ProjectedGaussians
from .rasterize import (ALPHA_THRESH, BWD_ALPHA_CLAMP, FWD_ALPHA_CLAMP,
                        T_EPS, sigma_at)

PIX_PER_TILE = BLOCK_X * BLOCK_Y  # 256
NO_STOP = 2**62  # final_idx of a pixel that never stops
SEG_COLS = 9  # the segment-sum kernel's row width


def _geometry(gid, tid, xys, conics, opac, tb_x, n_tiles, c):
    """Per-record Gaussian data and the (K, 256) sigma block."""
    g = torch.clamp(gid, max=c - 1)
    t = torch.clamp(tid, max=n_tiles - 1)
    gx, gy = xys[g, 0][:, None], xys[g, 1][:, None]
    A, B, C = (conics[g, i][:, None] for i in range(3))
    op = opac[g][:, None]
    p = torch.arange(PIX_PER_TILE, device=gid.device)
    px = ((t % tb_x) * BLOCK_X)[:, None] + (p % BLOCK_X)[None, :]
    py = ((t // tb_x) * BLOCK_Y)[:, None] + (p // BLOCK_X)[None, :]
    dx = gx - px.to(torch.float32)
    dy = gy - py.to(torch.float32)
    return g, t, dx, dy, sigma_at(A, B, C, dx, dy), op, A, B, C


def _segment_bounds(tid):
    """Within-chunk run boundaries of the sorted tile ids."""
    seg_start = torch.searchsorted(tid, tid)
    seg_end = torch.searchsorted(tid, tid, right=True) - 1
    idx = torch.arange(tid.shape[0], device=tid.device)
    return seg_start, seg_end, idx == seg_start, idx == seg_end


def _excl_cumsum(x):
    c = torch.cumsum(x, 0)
    return c - x, c  # (exclusive, inclusive)


def _write_rows(valid, t, n_tiles):
    """Row of each record's carry write: its tile where `valid`, else a
    spare row of its own past the tiles (unique indices either way)."""
    spare = n_tiles + torch.arange(t.shape[0], device=t.device)
    return torch.where(valid, t, spare)


def _forward_chunk(state, gid, tid, base_idx, xys, conics, colors, opac,
                   tb_x, n_tiles, c):
    T_state, done_state, out_state, final_idx = state
    valid = gid < c
    g, t, dx, dy, sigma, op, A, B, C = _geometry(
        gid, tid, xys, conics, opac, tb_x, n_tiles, c)
    seg_start, seg_end, _, is_last = _segment_bounds(tid)

    T_in = T_state[t]  # (K, 256)
    done_in = done_state[t]
    alpha = torch.clamp(op * torch.exp(-sigma), max=FWD_ALPHA_CLAMP)
    used = (valid[:, None] & (sigma >= 0.0) & (alpha >= ALPHA_THRESH)
            & ~done_in)
    a_f = torch.where(used, alpha, 0.0)
    excl, _ = _excl_cumsum(torch.log1p(-a_f))
    Tb = T_in * torch.exp(excl - excl[seg_start])
    stop = used & (Tb * (1.0 - a_f) <= T_EPS)

    # the first stop of each (run, pixel): its global record index
    gi = (base_idx + torch.arange(gid.shape[0], device=gid.device))[:, None]
    s_excl, s_incl = _excl_cumsum(stop.to(torch.int64))
    first = stop & (s_excl == s_excl[seg_start])
    f_excl, f_incl = _excl_cumsum(torch.where(first, gi, 0))
    seg_stop_any = s_incl[seg_end] > s_excl[seg_start]
    fidx = torch.where(seg_stop_any, f_incl[seg_end] - f_excl[seg_start],
                       final_idx[t])

    # composited set: used and strictly before the pixel's first stop
    a_eff = torch.where(used & (gi < fidx), a_f, 0.0)
    excl_e, incl_e = _excl_cumsum(torch.log1p(-a_eff))
    base_e = excl_e[seg_start]
    vis = a_eff * (T_in * torch.exp(excl_e - base_e))
    contrib = vis[:, :, None] * colors[g][:, None, :]  # (K, 256, CH)
    c_excl, c_incl = _excl_cumsum(contrib)
    seg_contrib = c_incl - c_excl[seg_start]

    w = _write_rows(valid & is_last, t, n_tiles)
    out_state[w] = out_state[t] + seg_contrib
    T_state[w] = T_in * torch.exp(incl_e - base_e)
    done_state[w] = done_in | seg_stop_any
    final_idx[w] = fidx


def _finite(v):
    # degenerate splats can overflow the float32 chain; a nonfinite row
    # would poison its Gaussian's parameters through Adam
    return torch.where(torch.isfinite(v), v, 0.0)


def _backward_chunk(state, gid, tid, base_idx, xys, conics, colors, opac,
                    v_out_t, v_oa_t, T_final_t, bg_dot_t, final_idx, tb_x,
                    n_tiles, c):
    """One chunk of the reverse replay; returns the records' gradient
    rows (K, 6 + CH): v_xy, v_conic, v_opacity, v_colour."""
    T_run_state, buffer_state = state
    valid = gid < c
    g, t, dx, dy, sigma, op, A, B, C = _geometry(
        gid, tid, xys, conics, opac, tb_x, n_tiles, c)
    seg_start, seg_end, is_first, _ = _segment_bounds(tid)
    gi = (base_idx + torch.arange(gid.shape[0], device=gid.device))[:, None]

    vis_u = torch.exp(-sigma)
    alpha_f = torch.clamp(op * vis_u, max=FWD_ALPHA_CLAMP)
    comp = (valid[:, None] & (sigma >= 0.0) & (alpha_f >= ALPHA_THRESH)
            & (gi < final_idx[t]))
    alpha_b = torch.where(comp, torch.clamp(op * vis_u, max=BWD_ALPHA_CLAMP),
                          0.0)
    lra = -torch.log1p(-alpha_b)  # log(ra)

    # within-run inclusive suffix sums (back-to-front order)
    rev_excl, rev_incl = _excl_cumsum(torch.flip(lra, [0]))
    sfx_incl = torch.flip(rev_incl, [0])
    sfx_base = torch.flip(rev_excl, [0])[seg_end]  # beyond the run's end
    T_run = T_run_state[t]
    T_k = T_run * torch.exp(sfx_incl - sfx_base)  # T after *= ra
    fac = alpha_b * T_k  # (K, 256)
    col = colors[g]  # (K, CH)
    contrib = fac[:, :, None] * col[:, None, :]

    crev_excl, crev_incl = _excl_cumsum(torch.flip(contrib, [0]))
    csfx_excl = torch.flip(crev_excl, [0])  # sum over later records
    buffer_k = buffer_state[t] + (csfx_excl - csfx_excl[seg_end])

    ra = torch.exp(lra)
    v_out = v_out_t[t]  # (K, 256, CH)
    T_final = T_final_t[t]
    v_alpha = (
        torch.sum((col[:, None, :] * T_k[:, :, None]
                   - buffer_k * ra[:, :, None]) * v_out, -1)
        - T_final * ra * v_oa_t[t]
        - T_final * ra * bg_dot_t[t]
    )
    v_alpha = torch.where(comp, v_alpha, 0.0)
    v_sigma = -op * vis_u * v_alpha

    rows = torch.cat([
        torch.stack([torch.sum(v_sigma * (A * dx + B * dy), 1),
                     torch.sum(v_sigma * (B * dx + C * dy), 1)], -1),
        0.5 * torch.stack([torch.sum(v_sigma * dx * dx, 1),
                           torch.sum(v_sigma * dx * dy, 1),
                           torch.sum(v_sigma * dy * dy, 1)], -1),
        torch.sum(vis_u * v_alpha, 1)[:, None],
        torch.einsum("kp,kpc->kc", fac, v_out),
    ], 1)

    # carry updates at run-first rows (unique tiles)
    seg_total_lra = sfx_incl[seg_start] - sfx_base
    seg_total_contrib = (torch.flip(crev_incl, [0])[seg_start]
                         - torch.flip(crev_excl, [0])[seg_end])
    w = _write_rows(valid & is_first, t, n_tiles)
    T_run_state[w] = T_run * torch.exp(seg_total_lra)
    buffer_state[w] = buffer_state[t] + seg_total_contrib
    return _finite(rows)


def _segment_sums(rows, cand_index, cand_start, cand_count, n_cands):
    """Per-Gaussian sums of the records' rows (R, W): each row goes to its
    candidate row, and the segment-sum kernel sums each Gaussian's
    contiguous candidate rows, 9 columns at a time."""
    width = rows.shape[1]
    groups = -(-width // SEG_COLS)
    sums = []
    for k in range(groups):
        cols = rows[:, k * SEG_COLS:(k + 1) * SEG_COLS]
        cand = rows.new_zeros((n_cands, SEG_COLS))
        cand[cand_index, :cols.shape[1]] = cols  # a permutation's rows
        sums.append(segment_sum(cand, cand_start, cand_count))
    return torch.cat(sums, 1)[:, :width]


class _RasterizeBinned(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xys, conics, colors, opac, background, gauss_ids,
                tile_ids, cand_index, cand_start, cand_count, n_cands,
                height, width, chunk_size):
        xys, conics, colors, opac, background = (
            x.detach().to(torch.float32).contiguous()
            for x in (xys, conics, colors, opac, background))
        tb_x, tb_y = num_tiles(height, width)
        n_tiles = tb_x * tb_y
        c = xys.shape[0]
        dev = xys.device
        rows = n_tiles + chunk_size  # the tiles, then the spare rows
        ch = colors.shape[-1]
        state = (
            torch.ones((rows, PIX_PER_TILE), device=dev),
            torch.zeros((rows, PIX_PER_TILE), dtype=torch.bool, device=dev),
            torch.zeros((rows, PIX_PER_TILE, ch), device=dev),
            torch.full((rows, PIX_PER_TILE), NO_STOP, dtype=torch.int64,
                       device=dev),
        )
        for base in range(0, gauss_ids.shape[0], chunk_size):
            _forward_chunk(state, gauss_ids[base:base + chunk_size],
                           tile_ids[base:base + chunk_size], base, xys,
                           conics, colors, opac, tb_x, n_tiles, c)
        T_state, _, out_state, final_idx = (s[:n_tiles] for s in state)
        out = out_state + T_state[..., None] * background[None, None, :]
        ctx.save_for_backward(xys, conics, colors, opac, background,
                              gauss_ids, tile_ids, cand_index, cand_start,
                              cand_count, T_state, final_idx)
        ctx.static = (n_cands, height, width, chunk_size)
        return (tiles_to_image(out, tb_x, tb_y, height, width),
                tiles_to_image(T_state, tb_x, tb_y, height, width))

    @staticmethod
    def backward(ctx, v_img, v_ft):
        (xys, conics, colors, opac, background, gauss_ids, tile_ids,
         cand_index, cand_start, cand_count, T_final_state,
         final_idx) = ctx.saved_tensors
        n_cands, height, width, chunk_size = ctx.static
        tb_x, tb_y = num_tiles(height, width)
        n_tiles = tb_x * tb_y
        c = xys.shape[0]
        dev = xys.device
        ch = colors.shape[-1]
        if v_img is None:
            v_img = torch.zeros((height, width, ch), device=dev)
        if v_ft is None:
            v_ft = torch.zeros((height, width), device=dev)
        v_img = v_img.to(torch.float32)
        v_out_t = image_to_tiles(v_img, tb_x, tb_y, height, width)
        v_oa_t = image_to_tiles(v_ft.to(torch.float32), tb_x, tb_y, height,
                                width)
        T_final_img = tiles_to_image(T_final_state, tb_x, tb_y, height,
                                     width)
        bg_dot_t = v_out_t @ background
        rows = n_tiles + chunk_size
        state = (
            torch.cat([T_final_state,
                       T_final_state.new_ones((chunk_size, PIX_PER_TILE))]),
            torch.zeros((rows, PIX_PER_TILE, ch), device=dev),
        )
        n = gauss_ids.shape[0]
        grad_rows = torch.zeros((n, 6 + ch), device=dev)
        for base in reversed(range(0, n, chunk_size)):
            grad_rows[base:base + chunk_size] = _backward_chunk(
                state, gauss_ids[base:base + chunk_size],
                tile_ids[base:base + chunk_size], base, xys, conics, colors,
                opac, v_out_t, v_oa_t, T_final_state, bg_dot_t, final_idx,
                tb_x, n_tiles, c)
        kept = cand_index.shape[0]
        acc = _segment_sums(grad_rows[:kept], cand_index.long(), cand_start,
                            cand_count, n_cands)
        v_bg = torch.einsum("hw,hwc->c", T_final_img, v_img)
        return (acc[:, 0:2], acc[:, 2:5], acc[:, 6:], acc[:, 5], v_bg,
                None, None, None, None, None, None, None, None, None)


def rasterize_tiled(
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
    chunk_size: int = 256,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Tile-binned rasterization: the semantics and gradients of
    rasterize() (ops/rasterize.py), colours (N, CH) and background (CH,).
    Runs on the inputs' device. The stream is sized exactly (one host
    read of the candidate total and one of the kept count), so the JAX
    package's intersection budget has no counterpart."""
    opac = opacities.reshape(-1)
    proj = ProjectedGaussians(
        xys=xys.detach(), depths=depths, cam_depths=depths, radii=radii,
        conics=conics.detach(), cov2d=conics.detach(),
        num_tiles_hit=num_tiles_hit, tile_min=tile_min, tile_max=tile_max,
        mask=radii > 0,
    )
    with torch.no_grad():
        binned = bin_gaussians(proj, height, width, opac.detach())
        kept = int(binned.tile_end[-1]) if binned.tile_end.numel() else 0
        c = xys.shape[0]
        n_pad = -(-kept // chunk_size) * chunk_size
        pos = torch.arange(n_pad, device=xys.device)
        # culled rows sort past every tile: the stream's first `kept` rows
        # are the kept records, and pos -> its tile by the tile ranges
        tile_ids = torch.searchsorted(binned.tile_end.long(), pos, right=True)
        gauss_ids = torch.full((n_pad,), c, dtype=torch.int64,
                               device=xys.device)
        gauss_ids[:kept] = binned.gauss_ids[:kept].long()
    return _RasterizeBinned.apply(
        xys, conics, colors, opac, background.to(torch.float32), gauss_ids,
        tile_ids, binned.cand_index[:kept], binned.cand_start,
        binned.cand_count, binned.n_cands, height, width, chunk_size)
