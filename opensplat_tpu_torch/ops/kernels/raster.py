"""Tile rasterizer forward (kernel 2) and backward (kernel 3).

Replaces opensplat_tpu/ops/pallas/raster.py::_fwd_kernel
(pallas_rasterize_forward) and ::_bwd_kernel (pallas_rasterize_backward).
CUDA sources: csrc/raster_fwd.cu and csrc/raster_bwd.cu, one thread per
pixel, records gathered by gauss_id into shared memory in chunks (64 in
the forward, 32 in the backward); both are bound by the (pixel, record)
arithmetic (see the source notes). The forward computes a chunk's alphas
in one branch-free block, then composites them in order without
branches, one CTA per tile. The backward replays records back to
front and reduces each record's nine gradient sums as moments of v_sigma
and fac over the tile's pixels, recombined in tile-local coordinates
(`moment_terms`), as the JAX kernel does.
`rasterize_forward_plain` and `rasterize_backward_plain` are the same
functions in plain PyTorch, record by record over all tiles at once in
the kernels' order and arithmetic (the backward's moments included); the
wrappers take them only for CPU tensors. `rasterize_backward_direct`
takes the nine sums term by term in float64: the reference that the
moment form is held to.

Semantics (opensplat_tpu/ops/rasterize.py, reference forward.cu and
backward.cu): alpha = min(0.999, op * exp(-sigma)) with records below
1/255 or with sigma < 0 skipped; a pixel stops at the first record where
T * (1 - alpha) <= 1e-4, which is not composited and whose stream index
is the pixel's final_idx (2^30 when it never stops). The backward replays
back to front from final_idx, recovers T by division with the 0.99
clamp, zeroes nonfinite per-record sums, and writes one (9,) row per
record — v_x, v_y, v_A, v_B, v_C, v_opacity, v_r, v_g, v_b — at the row
`out_index` gives it: the record's candidate row, so that each
Gaussian's rows lie contiguous for the segment sum.
"""
from __future__ import annotations

import torch

from ..binning import num_tiles
from ..projection import BLOCK_X, BLOCK_Y
from ..rasterize import (ALPHA_THRESH, BWD_ALPHA_CLAMP, FWD_ALPHA_CLAMP,
                         T_EPS, sigma_at)
from . import _lib

PIX = BLOCK_X * BLOCK_Y
K = 256  # the JAX kernels' record chunk: n_grads counts K-wide chunks
STOP_SENTINEL = 2**30


def tiles_to_image(tiled, tb_x, tb_y, height, width):
    """(T, 256, ...) -> (H, W, ...) crop."""
    extra = tuple(tiled.shape[2:])
    img = tiled.reshape((tb_y, tb_x, BLOCK_Y, BLOCK_X) + extra)
    img = img.movedim(2, 1).reshape((tb_y * BLOCK_Y, tb_x * BLOCK_X) + extra)
    return img[:height, :width]


def image_to_tiles(img, tb_x, tb_y, height, width):
    """(H, W, ...) -> (T, 256, ...) zero-pad."""
    extra = tuple(img.shape[2:])
    pad = img.new_zeros((tb_y * BLOCK_Y, tb_x * BLOCK_X) + extra)
    pad[:height, :width] = img
    pad = pad.reshape((tb_y, BLOCK_Y, tb_x, BLOCK_X) + extra)
    return pad.movedim(1, 2).reshape((tb_y * tb_x, PIX) + extra)


def _pixel_coords(n_tiles, tb_x, device):
    t = torch.arange(n_tiles, device=device)[:, None]
    p = torch.arange(PIX, device=device)[None, :]
    px = ((t % tb_x) * BLOCK_X + p % BLOCK_X).to(torch.float32)
    py = ((t // tb_x) * BLOCK_Y + p // BLOCK_X).to(torch.float32)
    return px, py  # (T, 256)


def _records(k, tile_start, tile_end, gauss_ids, fields):
    """Record k of every tile: (T,) stream index, validity, and each
    per-Gaussian field gathered as (T, 1)."""
    idx = tile_start.long() + k
    valid = idx < tile_end.long()
    n = gauss_ids.shape[0]
    g = torch.where(valid, gauss_ids[idx.clamp(max=max(n - 1, 0))].long(), 0)
    return idx, valid, [f[g][:, None] for f in fields]


def _fields(xys, conics, opac, colors):
    return (xys[:, 0], xys[:, 1], conics[:, 0], conics[:, 1], conics[:, 2],
            opac.reshape(-1), colors[:, 0], colors[:, 1], colors[:, 2])


def rasterize_forward_plain(gauss_ids, tile_start, tile_end, xys, conics,
                            opac, colors, background, height, width):
    """Record by record over all tiles at once, in the kernel's order and
    with its arithmetic (each pixel a lane of a (T, 256) tensor)."""
    tb_x, tb_y = num_tiles(height, width)
    n_tiles = tb_x * tb_y
    dev = xys.device
    px, py = _pixel_coords(n_tiles, tb_x, dev)
    T = torch.ones((n_tiles, PIX), device=dev)
    rgb = [torch.zeros((n_tiles, PIX), device=dev) for _ in range(3)]
    fidx = torch.full((n_tiles, PIX), STOP_SENTINEL, dtype=torch.long,
                      device=dev)
    done = torch.zeros((n_tiles, PIX), dtype=torch.bool, device=dev)
    counts = (tile_end - tile_start).long()
    longest = int(counts.max()) if n_tiles and gauss_ids.numel() else 0
    fields = _fields(xys, conics, opac, colors)
    for k in range(longest):
        if k % 64 == 0 and bool(done.all()):
            break
        idx, valid, (x, y, A, B, C, op, cr, cg, cb) = _records(
            k, tile_start, tile_end, gauss_ids, fields)
        sigma = sigma_at(A, B, C, x - px, y - py)
        raw = op * torch.exp(-sigma)
        used = valid[:, None] & (sigma >= 0.0) & (raw >= ALPHA_THRESH) & ~done
        alpha = torch.clamp(raw, max=FWD_ALPHA_CLAMP)
        next_t = T * (1.0 - alpha)
        stop = used & (next_t <= T_EPS)
        fidx = torch.where(stop, idx[:, None], fidx)
        done = done | stop
        comp = used & ~stop
        vis = alpha * T
        rgb = [torch.where(comp, acc + vis * col, acc)
               for acc, col in zip(rgb, (cr, cg, cb))]
        T = torch.where(comp, next_t, T)
    out = torch.stack(rgb, -1) + T[..., None] * background[None, None, :]
    img = tiles_to_image(out, tb_x, tb_y, height, width)
    final_t = tiles_to_image(T, tb_x, tb_y, height, width)
    return img, final_t, fidx.to(torch.int32)


def rasterize_forward(gauss_ids, tile_start, tile_end, xys, conics, opac,
                      colors, background, height: int, width: int):
    """Returns (img (H, W, 3), final_t (H, W), final_idx (T, 256) int32)."""
    if not xys.is_cuda:
        return rasterize_forward_plain(gauss_ids, tile_start, tile_end, xys,
                                       conics, opac, colors, background,
                                       height, width)
    tb_x, tb_y = num_tiles(height, width)
    n_tiles = tb_x * tb_y
    c = xys.shape[0]
    _check_common(gauss_ids, tile_start, tile_end, xys, conics, opac, colors,
                  background, n_tiles, c)
    dev = xys.device
    img = torch.empty((height, width, 3), dtype=torch.float32, device=dev)
    final_t = torch.empty((height, width), dtype=torch.float32, device=dev)
    fidx = torch.empty((n_tiles, PIX), dtype=torch.int32, device=dev)
    p = _lib.ptr
    with _lib.timed("raster_fwd"):
        _lib.launch("osk_raster_fwd", n_tiles, p(tile_start), p(tile_end),
                    p(gauss_ids), p(xys), p(conics), p(opac), p(colors),
                    p(background), height, width, tb_x, p(img), p(final_t),
                    p(fidx))
    rasterize_forward.launches += 1
    return img, final_t, fidx


rasterize_forward.launches = 0


def _pixel_replay(tile_start, tile_end, final_idx):
    """(T, 256) int64: the records each pixel composites, from its tile's
    start up to its final_idx (the whole tile where it never stopped)."""
    start = tile_start.long()
    count = tile_end.long() - start
    f = final_idx.reshape(start.shape[0], -1).long()
    eff = torch.where(f >= STOP_SENTINEL, count[:, None], f - start[:, None])
    return torch.minimum(eff, count[:, None])


def records_replayed(tile_start, tile_end, final_idx) -> int:
    """Records the tiles replay before their last pixel stops: per tile
    the largest replay over its pixels, summed over tiles."""
    return int(_pixel_replay(tile_start, tile_end, final_idx).amax(1).sum())


def pairs_replayed(tile_start, tile_end, final_idx) -> int:
    """(pixel, record) pairs the pixels replay, each pixel up to its own
    stop: the work the function needs, where records_replayed x 256 is
    the work of a tile that runs until its last pixel stops."""
    return int(_pixel_replay(tile_start, tile_end, final_idx).sum())


def compact_grad_layout(tile_start, tile_end, final_idx):
    """(comp_start (T,) int32, n_grads () int64): the JAX backward's
    compact gradient-stream layout (raster.py::compact_grad_layout) with
    K = 256 — each tile emits cdiv(glim - floor_K(start), K) K-wide
    chunks, glim being its replay limit. The port writes records at their
    stream index instead; n_grads is reported with the JAX meaning."""
    start = tile_start.long()
    glim = start + _pixel_replay(tile_start, tile_end, final_idx).amax(1)
    base0 = start - start % K
    nch = torch.where(glim > base0, (glim - base0 + K - 1) // K, 0)
    sizes = nch * K
    ccum = torch.cumsum(sizes, 0)
    return (ccum - sizes).to(torch.int32), ccum[-1]


def _moment_features(device):
    """(256, 6) per-pixel features [1, qx, qy, qx^2, qy^2, qx*qy], qx and
    qy the pixel's offset from its tile's centre (the same for every
    tile)."""
    p = torch.arange(PIX, device=device)
    qx = (p % BLOCK_X).to(torch.float32) - 0.5 * (BLOCK_X - 1)
    qy = (p // BLOCK_X).to(torch.float32) - 0.5 * (BLOCK_Y - 1)
    return torch.stack([torch.ones_like(qx), qx, qy, qx * qx, qy * qy,
                        qx * qy], 1)


def _tile_centres(n_tiles, tb_x, device):
    t = torch.arange(n_tiles, device=device)
    tcx = ((t % tb_x) * BLOCK_X).to(torch.float32) + 0.5 * (BLOCK_X - 1)
    tcy = ((t // tb_x) * BLOCK_Y).to(torch.float32) + 0.5 * (BLOCK_Y - 1)
    return tcx[:, None], tcy[:, None]  # (T, 1)


def moment_terms(m, x, y, A, B, C, op, tcx, tcy):
    """The nine gradient terms (..., 9) of a record from its pixel
    moments m (..., 9) = [m0, m_x, m_y, m_xx, m_yy, m_xy] of v_sigma and
    [g_r, g_g, g_b] of fac, recombined in tile-local coordinates
    (dx = xr - qx): the JAX kernel's algebra (raster.py, _BWD_MOMENTS).
    Nonfinite terms are 0."""
    m0, mx, my, mxx, myy, mxy = (m[..., j] for j in range(6))
    xr = x - tcx
    yr = y - tcy
    sx = xr * m0 - mx  # sum_p v_sigma dx
    sy = yr * m0 - my
    terms = torch.stack([
        A * sx + B * sy,
        B * sx + C * sy,
        0.5 * (xr * xr * m0 - 2.0 * xr * mx + mxx),
        0.5 * (xr * yr * m0 - xr * my - yr * mx + mxy),
        0.5 * (yr * yr * m0 - 2.0 * yr * my + myy),
        -m0 / torch.clamp(op, min=1e-12),
        m[..., 6], m[..., 7], m[..., 8],
    ], dim=-1)
    return torch.where(torch.isfinite(terms), terms, 0.0)


def rasterize_backward_plain(gauss_ids, tile_start, tile_end, xys, conics,
                             opac, colors, background, final_t, final_idx,
                             v_img, v_ft, out_index, height, width):
    """Back to front, record by record over all tiles at once, with the
    kernel's running T and colour sums and its moment reduction; only the
    sums over a tile's 256 pixels are taken in another order (and the
    kernel's 1 / (1 - alpha) is within an ulp of this division)."""
    tb_x, tb_y = num_tiles(height, width)
    n_tiles = tb_x * tb_y
    dev = xys.device
    n = gauss_ids.shape[0]
    grads = torch.zeros((n, 9), dtype=torch.float32, device=dev)
    px, py = _pixel_coords(n_tiles, tb_x, dev)
    tcx, tcy = _tile_centres(n_tiles, tb_x, dev)
    feats = _moment_features(dev)
    inside = (px < width) & (py < height)
    v_out = image_to_tiles(v_img.to(torch.float32), tb_x, tb_y, height, width)
    v_oa = image_to_tiles(v_ft.to(torch.float32), tb_x, tb_y, height, width)
    T_run = image_to_tiles(final_t.to(torch.float32), tb_x, tb_y, height,
                           width)
    vr, vg, vb = (v_out[..., j] for j in range(3))
    bg_dot = vr * background[0] + vg * background[1] + vb * background[2]
    vob = T_run * (v_oa + bg_dot)
    fidx = final_idx.reshape(n_tiles, PIX).long()
    buf_dot = torch.zeros_like(T_run)
    counts = (tile_end - tile_start).long()
    longest = int(counts.max()) if n_tiles and n else 0
    fields = _fields(xys, conics, opac, colors)
    for k in reversed(range(longest)):
        idx, valid, (x, y, A, B, C, op, cr, cg, cb) = _records(
            k, tile_start, tile_end, gauss_ids, fields)
        dx = x - px
        dy = y - py
        sigma = sigma_at(A, B, C, dx, dy)
        vis = torch.exp(-sigma)
        raw = op * vis
        comp = (valid[:, None] & inside & (idx[:, None] < fidx)
                & (sigma >= 0.0) & (raw >= ALPHA_THRESH))
        alpha = torch.clamp(raw, max=BWD_ALPHA_CLAMP)
        ra = 1.0 / (1.0 - alpha)
        T_k = T_run * ra
        fac = torch.where(comp, alpha * T_k, 0.0)
        w = cr * vr + cg * vg + cb * vb
        v_alpha = T_k * w - ra * (buf_dot + vob)
        v_sigma = torch.where(comp, -op * vis * v_alpha, 0.0)
        m = torch.cat([v_sigma @ feats,
                       torch.einsum("tp,tpc->tc", fac, v_out)], 1)  # (T, 9)
        terms = moment_terms(m, x[:, 0], y[:, 0], A[:, 0], B[:, 0], C[:, 0],
                             op[:, 0], tcx[:, 0], tcy[:, 0])
        grads[out_index[idx[valid]].long()] = terms[valid]
        buf_dot = torch.where(comp, buf_dot + fac * w, buf_dot)
        T_run = torch.where(comp, T_k, T_run)
    return grads


def rasterize_backward_direct(gauss_ids, tile_start, tile_end, xys, conics,
                              opac, colors, background, final_t, final_idx,
                              v_img, v_ft, out_index, height, width):
    """The nine gradient sums taken term by term, the reference that the
    moment form (`moment_terms`, the kernel's and the plain version's
    algebra) is held to. Per-pixel values, and so every composite
    decision, in float32 as the kernel computes them; the nine terms and
    their sums over the pixels in float64. Rows at `out_index`, as
    rasterize_backward writes them; (I, 9) float64."""
    tb_x, tb_y = num_tiles(height, width)
    n_tiles = tb_x * tb_y
    dev = xys.device
    n = gauss_ids.shape[0]
    grads = torch.zeros((n, 9), dtype=torch.float64, device=dev)
    px, py = _pixel_coords(n_tiles, tb_x, dev)
    inside = (px < width) & (py < height)
    tiles = lambda a: image_to_tiles(a, tb_x, tb_y, height, width)
    v_out, v_oa, T_run = tiles(v_img), tiles(v_ft), tiles(final_t)
    vr, vg, vb = (v_out[..., j] for j in range(3))
    vob = T_run * (v_oa + vr * background[0] + vg * background[1]
                   + vb * background[2])
    fidx = final_idx.reshape(n_tiles, PIX).long()
    buf_dot = torch.zeros_like(T_run)
    counts = (tile_end - tile_start).long()
    longest = int(counts.max()) if n_tiles and n else 0
    fields = _fields(xys, conics, opac, colors)
    d = lambda a: a.double()
    for k in reversed(range(longest)):
        idx, valid, (x, y, A, B, C, op, cr, cg, cb) = _records(
            k, tile_start, tile_end, gauss_ids, fields)
        dx, dy = x - px, y - py
        sigma = sigma_at(A, B, C, dx, dy)
        vis = torch.exp(-sigma)
        raw = op * vis
        comp = (valid[:, None] & inside & (idx[:, None] < fidx)
                & (sigma >= 0.0) & (raw >= ALPHA_THRESH))
        alpha = torch.clamp(raw, max=BWD_ALPHA_CLAMP)
        ra = 1.0 / (1.0 - alpha)
        T_k = T_run * ra
        fac = alpha * T_k
        w = cr * vr + cg * vg + cb * vb
        v_alpha = T_k * w - ra * (buf_dot + vob)
        v_sigma = -op * vis * v_alpha
        vs, ddx, ddy = d(v_sigma), d(dx), d(dy)
        terms = torch.stack([
            vs * (d(A) * ddx + d(B) * ddy), vs * (d(B) * ddx + d(C) * ddy),
            0.5 * vs * ddx * ddx, 0.5 * vs * ddx * ddy, 0.5 * vs * ddy * ddy,
            d(vis) * d(v_alpha),
            d(fac) * d(vr), d(fac) * d(vg), d(fac) * d(vb)], -1)
        terms = torch.where(comp[..., None], terms, 0.0).sum(1)
        terms = torch.where(torch.isfinite(terms), terms, 0.0)
        grads[out_index[idx[valid]].long()] = terms[valid]
        buf_dot = torch.where(comp, buf_dot + fac * w, buf_dot)
        T_run = torch.where(comp, T_k, T_run)
    return grads


def rasterize_backward(gauss_ids, tile_start, tile_end, xys, conics, opac,
                       colors, background, final_t, final_idx, v_img, v_ft,
                       out_index, height: int, width: int):
    """Per-record gradients (I, 9) f32: stream record i's row is written
    at row out_index[i] (a permutation of [0, I)); rows of records past a
    tile's replay limit, and of culled candidates, stay 0."""
    if not xys.is_cuda:
        return rasterize_backward_plain(gauss_ids, tile_start, tile_end, xys,
                                        conics, opac, colors, background,
                                        final_t, final_idx, v_img, v_ft,
                                        out_index, height, width)
    tb_x, tb_y = num_tiles(height, width)
    n_tiles = tb_x * tb_y
    c = xys.shape[0]
    _check_common(gauss_ids, tile_start, tile_end, xys, conics, opac, colors,
                  background, n_tiles, c)
    _lib.check(final_t, "final_t", torch.float32, (height, width))
    _lib.check(final_idx, "final_idx", torch.int32, (n_tiles, PIX))
    _lib.check(v_img, "v_img", torch.float32, (height, width, 3))
    _lib.check(v_ft, "v_ft", torch.float32, (height, width))
    _lib.check(out_index, "out_index", torch.int32, (gauss_ids.shape[0],))
    grads = torch.zeros((gauss_ids.shape[0], 9), dtype=torch.float32,
                        device=xys.device)
    p = _lib.ptr
    with _lib.timed("raster_bwd"):
        _lib.launch("osk_raster_bwd", n_tiles, p(tile_start), p(tile_end),
                    p(gauss_ids), p(xys), p(conics), p(opac), p(colors),
                    p(background), p(final_t), p(final_idx), p(v_img),
                    p(v_ft), p(out_index), height, width, tb_x, p(grads))
    rasterize_backward.launches += 1
    return grads


rasterize_backward.launches = 0


def forward_kernel_info() -> dict:
    """The forward kernel's build, from the CUDA runtime: K (records per
    chunk), registers per thread, shared memory per CTA in bytes and
    resident CTAs per SM."""
    return _lib.kernel_info("osk_raster_fwd_info", (
        "K", "registers", "shared_bytes", "ctas_per_sm"))


def backward_kernel_info() -> dict:
    """The backward kernel's build, from the CUDA runtime: K (records per
    chunk), registers per thread, shared memory per CTA in bytes and
    resident CTAs per SM."""
    return _lib.kernel_info("osk_raster_bwd_info", (
        "K", "registers", "shared_bytes", "ctas_per_sm"))


def _check_common(gauss_ids, tile_start, tile_end, xys, conics, opac, colors,
                  background, n_tiles, c):
    _lib.check(gauss_ids, "gauss_ids", torch.int32, (-1,))
    _lib.check(tile_start, "tile_start", torch.int32, (n_tiles,))
    _lib.check(tile_end, "tile_end", torch.int32, (n_tiles,))
    _lib.check(xys, "xys", torch.float32, (c, 2))
    _lib.check(conics, "conics", torch.float32, (c, 3))
    _lib.check(opac, "opac", torch.float32, (c,))
    _lib.check(colors, "colors", torch.float32, (c, 3))
    _lib.check(background, "background", torch.float32, (3,))
