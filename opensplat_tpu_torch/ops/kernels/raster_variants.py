"""Forward rasterizer with pieces ablated (kernel 5, the ablation bench).

Replaces tools/kbench_raster.py::build_variant (its fwd_kernel, launched
by pl.pallas_call). CUDA source: csrc/raster_fwd_variants.cu — one CTA
per tile, one thread per pixel, the JAX variant's chunk loop templated on
the variant. `rasterize_variant_plain` is the same function in plain
PyTorch, vectorised over tiles, pixels and the 256 lanes of a chunk; the
wrapper takes it only for CPU tensors.

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


def _pixel_quad(device):
    """The pixel factors qx^2, qy^2, qx*qy, qx, qy, each (PIX,), with
    (qx, qy) the pixel's offset from the tile centre; the sixth factor,
    1, multiplies the record's constant term."""
    p = torch.arange(PIX, device=device)
    qx = (p % BLOCK_X).to(torch.float32) - 0.5 * (BLOCK_X - 1)
    qy = (p // BLOCK_X).to(torch.float32) - 0.5 * (BLOCK_Y - 1)
    return qx * qx, qy * qy, qx * qy, qx, qy


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
    qxx, qyy, qxy, qx, qy = (v[None, :, None] for v in _pixel_quad(dev))
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
        # raster.py::_record_quad, in its operation order
        x, y = xys[g, 0], xys[g, 1]
        A, B, C = conics[g, 0], conics[g, 1], conics[g, 2]
        xr = x - tcx
        yr = y - tcy
        f = [0.5 * A, 0.5 * C, B, -(A * xr + B * yr), -(C * yr + B * xr),
             0.5 * (A * xr * xr + C * yr * yr) + B * xr * yr]
        f = [v[:, None, :] for v in f]  # (nb, 1, K)
        sigma = (qxx * f[0] + qyy * f[1] + qxy * f[2] + qx * f[3]
                 + qy * f[4] + f[5]).clamp(min=0.0)  # (nb, PIX, K)
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
