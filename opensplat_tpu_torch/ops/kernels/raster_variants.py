"""Forward rasterizer with pieces ablated (kernel 5, the ablation bench).

Replaces tools/kbench_raster.py::build_variant (its fwd_kernel, launched
by pl.pallas_call). CUDA source: csrc/raster_fwd_variants.cu — one CTA
per tile, one thread per pixel, templated on the variant; it stages the
JAX chunks of K records (16-byte cp.async copies, so the four record
tensors must be 16-byte aligned), lists for each warp the
records that can reach its pixels (`warp_masks`), computes their alphas
in branch-free blocks of ALPHA_BLOCK and lets the warp vote past the
records none of its pixels uses. `rasterize_variant_plain` is the same
function in plain PyTorch, vectorised over tiles, pixels and the 256
lanes of a chunk; the wrapper takes it only for CPU tensors.
`warp_steps` counts the (warp, record) steps the kernel takes.

Semantics (the JAX variants, tools/kbench_raster.py:78-201): chunks of
K = 256 records aligned to the global record index (base0 = start -
start % K), lanes outside [start, end) masked. sigma comes from
tile-centred quadratic features (centre (t % tb_x) * 16 + 7.5) and is
clamped at 0 with no sign test; alpha = min(0.999, op * exp(-sigma));
records below 1/255 are skipped; la = log1p(-alpha); excl is the
exclusive prefix of la over the chunk; a pixel stops at the first lane
where log(T_chunk) + excl + la <= log(1e-4), composites nothing from
there on, and T_chunk *= exp(sum of the composited la) at the chunk's
end. The variants change one piece each:
  full      as above;
  nomatmul  excl = la (the lane's own, no prefix);
  notrans   alpha = min(0.999, op * (1 - 0.05 sigma)), la = -alpha,
            vis = a T (1 + excl), T *= 1 + 1e-6 sum(la);
  nostop    no stop test and no final_idx;
  skeleton  T += x[chunk base] once per chunk, nothing else.
Output: acc (T, 8, 256) rows [r, g, b, T, 0, 0, 0, 0] and final_idx
(T, 256) int32 (2^30 where a pixel never stopped).

Inputs are the port's per-record layout: xys (I, 2), conics (I, 3) =
(A, B, C), opac (I,) and colors (I, 3), the same tensors the main path's
raster.rasterize_forward takes per Gaussian.
"""
from __future__ import annotations

import math

import torch

from ..projection import BLOCK_X, BLOCK_Y
from ..rasterize import ALPHA_THRESH, FWD_ALPHA_CLAMP, T_EPS
from . import _lib
from .raster import K, PIX, STOP_SENTINEL

VARIANTS = ("full", "nomatmul", "notrans", "nostop", "skeleton")
LOG_T_EPS = math.log(T_EPS)
TILE_BATCH = 64  # tiles per step of the plain version
# the kernel's records per alpha block (csrc/raster_fwd_variants.cu: G;
# chip_smoke.py holds it to kernel_info())
ALPHA_BLOCK = 8


def _pixel_quad(device):
    """The pixel factors qx^2, qy^2, qx*qy, qx, qy, each (PIX,), with
    (qx, qy) the pixel's offset from the tile centre; the sixth factor,
    1, multiplies the record's constant term."""
    p = torch.arange(PIX, device=device)
    qx = (p % BLOCK_X).to(torch.float32) - 0.5 * (BLOCK_X - 1)
    qy = (p // BLOCK_X).to(torch.float32) - 0.5 * (BLOCK_Y - 1)
    return qx * qx, qy * qy, qx * qy, qx, qy


def _sigma(g, xys, conics, tcx, tcy, quad):
    """(nb, PIX, L) sigma of records g (nb, L) at every pixel of tiles
    centred on (tcx, tcy) (nb, 1): raster.py::_record_quad's features in
    its operation order, dotted with the pixel factors `quad`, clamped
    at 0."""
    qxx, qyy, qxy, qx, qy = quad
    x, y = xys[g, 0], xys[g, 1]
    A, B, C = conics[g, 0], conics[g, 1], conics[g, 2]
    xr = x - tcx
    yr = y - tcy
    f = [0.5 * A, 0.5 * C, B, -(A * xr + B * yr), -(C * yr + B * xr),
         0.5 * (A * xr * xr + C * yr * yr) + B * xr * yr]
    f = [v[:, None, :] for v in f]  # (nb, 1, L)
    return (qxx * f[0] + qyy * f[1] + qxy * f[2] + qx * f[3] + qy * f[4]
            + f[5]).clamp(min=0.0)


def _variant_tiles(name, t, tile_start, tile_end, xys, conics, opac,
                   colors, tb_x):
    """The variant for the tiles `t` (nb,): (acc (nb, 8, PIX), fidx)."""
    dev = xys.device
    nb = t.shape[0]
    n = xys.shape[0]
    start = tile_start[t].long()
    end = tile_end[t].long()
    base0 = start - start % K
    n_chunks = torch.where(end > start, (end - base0 + K - 1) // K, 0)
    lane = torch.arange(K, device=dev)
    quad = [v[None, :, None] for v in _pixel_quad(dev)]
    tcx = ((t % tb_x) * BLOCK_X).to(torch.float32)[:, None] + 7.5
    tcy = ((t // tb_x) * BLOCK_Y).to(torch.float32)[:, None] + 7.5
    T = torch.ones((nb, PIX), device=dev)
    rgb = torch.zeros((nb, PIX, 3), device=dev)
    fidx = torch.full((nb, PIX), STOP_SENTINEL, dtype=torch.long, device=dev)
    done = torch.zeros((nb, PIX), dtype=torch.bool, device=dev)
    longest = int(n_chunks.max()) if nb else 0
    for i in range(longest):
        live = i < n_chunks  # (nb,)
        gk = base0[:, None] + i * K + lane  # (nb, K) global record index
        g = gk.clamp(0, max(n - 1, 0))
        if name == "skeleton":
            x0 = torch.where(live, xys[g[:, 0], 0], 0.0)
            T = T + x0[:, None]  # + 0.0 past a tile's chunks: exact
            continue
        valid = live[:, None] & (gk >= start[:, None]) & (gk < end[:, None])
        sigma = _sigma(g, xys, conics, tcx, tcy, quad)  # (nb, PIX, K)
        op = opac[g][:, None, :]
        if name == "notrans":
            alpha = torch.clamp(op * (1.0 - 0.05 * sigma), max=FWD_ALPHA_CLAMP)
        else:
            alpha = torch.clamp(op * torch.exp(-sigma), max=FWD_ALPHA_CLAMP)
        used = valid[:, None, :] & (alpha >= ALPHA_THRESH) & ~done[:, :, None]
        a = torch.where(used, alpha, 0.0)
        la = -a if name == "notrans" else torch.log1p(-a)
        if name == "nomatmul":
            excl = la
        else:  # exclusive prefix over the chunk's lanes
            cs = torch.cumsum(la, dim=-1)
            excl = torch.cat([torch.zeros_like(cs[..., :1]), cs[..., :-1]], -1)
        if name == "nostop":
            comp = used
        else:
            logT = torch.log(torch.clamp(T, min=1e-37))[:, :, None]
            stop = used & (logT + excl + la <= LOG_T_EPS)
            stop_at = torch.where(stop, gk[:, None, :], STOP_SENTINEL).amin(-1)
            fidx = torch.minimum(fidx, stop_at)
            comp = used & (gk[:, None, :] < fidx[:, :, None])
            done = done | stop.any(-1)
        a_eff = torch.where(comp, a, 0.0)
        la_eff = torch.where(comp, la, 0.0)
        if name == "notrans":
            vis = a_eff * T[:, :, None] * (1.0 + excl)
        else:
            vis = a_eff * T[:, :, None] * torch.exp(excl)
        col = colors[g]  # (nb, K, 3)
        rgb = rgb + torch.bmm(vis, col)
        s = la_eff.sum(-1)
        T = T * (1.0 + s * 1e-6) if name == "notrans" else T * torch.exp(s)
    acc = torch.zeros((nb, 8, PIX), device=dev)
    acc[:, 0:3] = rgb.transpose(1, 2)
    acc[:, 3] = T
    return acc, fidx.to(torch.int32)


def rasterize_variant_plain(name, tile_start, tile_end, xys, conics, opac,
                            colors, tb_x):
    """The variant over every tile, TILE_BATCH tiles at a time (a chunk
    of a batch holds TILE_BATCH x 256 x 256 floats per intermediate)."""
    if name not in VARIANTS:
        raise ValueError(f"unknown variant {name!r}; one of {VARIANTS}")
    n_tiles = tile_start.shape[0]
    dev = xys.device
    acc = torch.zeros((n_tiles, 8, PIX), device=dev)
    fidx = torch.empty((n_tiles, PIX), dtype=torch.int32, device=dev)
    for t0 in range(0, n_tiles, TILE_BATCH):
        t = torch.arange(t0, min(t0 + TILE_BATCH, n_tiles), device=dev)
        acc[t], fidx[t] = _variant_tiles(name, t, tile_start, tile_end, xys,
                                         conics, opac, colors, tb_x)
    return acc, fidx


def warp_masks(xr, yr, A, B, C, op, notrans=False):
    """The kernel's warp_mask, elementwise over records: which warps (bit
    w: the tile's pixel rows 2w and 2w + 1) a record at tile-centred
    (xr, yr) can reach with alpha >= 1/255. The bounding box of its
    ellipse sigma <= s_max + 0.5, widened by 0.1 pixel, where alpha falls to
    1/255 at sigma = s_max; every warp for a conic outside positive A
    and C up to 1000 with A C - B^2 >= A C / 100, none for op < 1/255.
    int64 masks of the records' shape."""
    det = A * C - B * B
    fine = ((A > 0) & (C > 0) & (A <= 1000.0) & (C <= 1000.0)
            & (det >= 0.01 * A * C) & (op <= 1e30) & (xr.abs() <= 1e30)
            & (yr.abs() <= 1e30))
    opc = op.clamp(min=ALPHA_THRESH)
    s = 0.5 + (20.0 * (1.0 - 1.0 / (255.0 * opc)) if notrans
               else torch.log(255.0 * opc))
    det = torch.where(fine, det, 1.0)
    ex = torch.sqrt(2.0 * s * C.abs() / det) + 0.1
    ey = torch.sqrt(2.0 * s * A.abs() / det) + 0.1
    lo = torch.ceil((yr - ey + 6.5) * 0.5)
    hi = torch.floor((yr + ey + 7.5) * 0.5)
    miss = ((xr - ex > 7.5) | (xr + ex < -7.5) | (lo > 7.0) | (hi < 0.0)
            | (lo > hi))
    lo = torch.nan_to_num(lo).clamp(0, 7).long()
    hi = torch.nan_to_num(hi).clamp(0, 7).long()
    bits = ((2 << hi) - 1) & ~((1 << lo) - 1)
    bits = torch.where(miss, 0, bits)
    bits = torch.where(fine, bits, 0xFF)
    return torch.where(op < ALPHA_THRESH, 0, bits)


def warp_steps(tile_start, tile_end, xys, conics, opac, tb_x, final_idx):
    """The (warp, record) steps of `full` on these records, from its
    final_idx (a warp is 32 pixels, two rows of a tile), summed over
    warps, as a dict:
      replay  records from the tile's start to the warp's last stop (the
              stop record included; the tile's end where a pixel never
              stops): a loop that takes a warp's records one by one;
      listed  the records of the K-record chunks (aligned to the global
              index) up to the one holding the warp's last stop that
              warp_masks keeps for the warp;
      alpha   the kernel's alpha-block steps: each chunk's list in
              blocks of ALPHA_BLOCK records, the last block padded, up
              to the block holding the warp's last stop;
      used    the listed records some pixel of the warp composites or
              stops at (alpha >= 1/255, not past its stop): the steps
              the kernel's vote lets through."""
    dev = xys.device
    n_tiles = tile_start.shape[0]
    quad = [v[None, :, None] for v in _pixel_quad(dev)]
    nw = PIX // 32
    out = dict(replay=0, listed=0, alpha=0, used=0)
    for t0 in range(0, n_tiles, TILE_BATCH // 4):
        t = torch.arange(t0, min(t0 + TILE_BATCH // 4, n_tiles), device=dev)
        nb = t.shape[0]
        start = tile_start[t].long()[:, None]
        end = tile_end[t].long()[:, None]
        live = end > start  # (nb, 1)
        sb0 = start - start % K
        f = final_idx[t].long()
        last = torch.where(f >= STOP_SENTINEL, end - 1, f)  # (nb, PIX)
        w_last = last.reshape(nb, nw, 32).amax(-1)  # (nb, warps)
        w_stops = (f < STOP_SENTINEL).reshape(nb, nw, 32).all(-1)
        out["replay"] += int(torch.where(live, w_last - start + 1, 0).sum())
        span = int((end - sb0).max()) if bool(live.any()) else 0
        span = -(-span // K) * K
        gk = sb0 + torch.arange(span, device=dev)  # (nb, span)
        g = gk.clamp(0, max(xys.shape[0] - 1, 0))
        valid = (gk >= start) & (gk < end)
        tcx = ((t % tb_x) * BLOCK_X).to(torch.float32)[:, None] + 7.5
        tcy = ((t // tb_x) * BLOCK_Y).to(torch.float32)[:, None] + 7.5
        xr, yr = xys[g, 0] - tcx, xys[g, 1] - tcy
        masks = torch.where(valid, warp_masks(
            xr, yr, conics[g, 0], conics[g, 1], conics[g, 2], opac[g]), 0)
        w = torch.arange(nw, device=dev)[None, :, None]
        # (nb, warps, span): listed for the warp, before its last stop's
        # chunk ends
        c = (gk - sb0) // K
        c_last = ((w_last - sb0) // K)[:, :, None]
        listed = (((masks[:, None, :] >> w) & 1).bool()
                  & (c[:, None, :] <= c_last) & live[:, :, None])
        out["listed"] += int(listed.sum())
        per_chunk = listed.reshape(nb, nw, span // K, K)
        n_list = per_chunk.sum(-1)  # (nb, warps, chunks)
        blocks = -(-n_list // ALPHA_BLOCK)
        # in the last stop's chunk, only up to that record's block
        pos = (per_chunk.cumsum(-1) - 1).reshape(nb, nw, span)
        at_last = gk[:, None, :] == w_last[:, :, None]
        pos_last = torch.where(at_last, pos, 0).amax(-1)  # (nb, warps)
        chunks = torch.arange(span // K, device=dev)[None, None, :]
        cut = (chunks == c_last) & w_stops[:, :, None]
        blocks = torch.where(cut, (pos_last // ALPHA_BLOCK + 1)[:, :, None],
                             blocks)
        out["alpha"] += int(blocks.sum()) * ALPHA_BLOCK
        sigma = _sigma(g, xys, conics, tcx, tcy, quad)
        alpha = torch.clamp(opac[g][:, None, :] * torch.exp(-sigma),
                            max=FWD_ALPHA_CLAMP)
        used = ((alpha >= ALPHA_THRESH) & valid[:, None, :]
                & (gk[:, None, :] <= last[:, :, None]))
        used = used.reshape(nb, nw, 32, span).any(2)
        out["used"] += int(used.sum())
    return out


def rasterize_variant(name, tile_start, tile_end, xys, conics, opac, colors,
                      tb_x: int):
    """(acc (T, 8, 256) f32, final_idx (T, 256) int32) of variant `name`."""
    if name not in VARIANTS:
        raise ValueError(f"unknown variant {name!r}; one of {VARIANTS}")
    if not xys.is_cuda:
        return rasterize_variant_plain(name, tile_start, tile_end, xys,
                                       conics, opac, colors, tb_x)
    n_tiles = tile_start.shape[0]
    n = xys.shape[0]
    _lib.check(tile_start, "tile_start", torch.int32, (n_tiles,))
    _lib.check(tile_end, "tile_end", torch.int32, (n_tiles,))
    _lib.check(xys, "xys", torch.float32, (n, 2))
    _lib.check(conics, "conics", torch.float32, (n, 3))
    _lib.check(opac, "opac", torch.float32, (n,))
    _lib.check(colors, "colors", torch.float32, (n, 3))
    for t, what in ((xys, "xys"), (conics, "conics"), (opac, "opac"),
                    (colors, "colors")):
        if t.data_ptr() % 16:
            raise ValueError(f"{what}: the kernel copies 16-byte pieces and "
                             "needs a 16-byte-aligned tensor")
    acc = torch.empty((n_tiles, 8, PIX), dtype=torch.float32,
                      device=xys.device)
    fidx = torch.empty((n_tiles, PIX), dtype=torch.int32, device=xys.device)
    p = _lib.ptr
    with _lib.timed("kbench_fwd"):
        _lib.launch("osk_kbench_fwd", VARIANTS.index(name), n_tiles,
                    p(tile_start), p(tile_end), n, p(xys), p(conics),
                    p(opac), p(colors), tb_x, p(acc), p(fidx))
    rasterize_variant.launches += 1
    return acc, fidx


rasterize_variant.launches = 0


def kernel_info() -> dict:
    """The `full` kernel's build, from the CUDA runtime: records per
    chunk and per alpha block, registers per thread, shared memory per
    CTA in bytes and resident CTAs per SM."""
    return _lib.kernel_info("osk_kbench_fwd_info", (
        "records_per_chunk", "records_per_alpha_block", "registers",
        "shared_bytes", "ctas_per_sm"))
