"""Differentiable alpha-compositing rasterizer (dense, depth-sorted).

Counterpart of opensplat_tpu/ops/rasterize.py: the conformance renderer,
whose forward image and backward gradients follow the reference CPU
backend (gsplat-cpu/gsplat_cpu.cpp:137-376) to float32 accuracy. Every
pixel evaluates every Gaussian, so its work is O(N x pixels); it is the
numerical anchor of the tile renderers and the renderer of small scenes.

Gaussians are depth-sorted once (a stable argsort of depth, invalid ones
last) and composited in chunks of CHUNK: per chunk all P pixels take the
chunk's K Gaussians as one (P, K) block, front to back as a cumulative
product within the chunk and a per-pixel carry (T, done) across chunks —
the reference's per-Gaussian loop, with its early termination:
  - skip if sigma < 0 or alpha < 1/255          (gsplat_cpu.cpp:219-221)
  - alpha clamped to 0.999 in the forward       (gsplat_cpu.cpp:220)
  - a pixel is done once T would drop to <= 1e-4; the crossing Gaussian
    is NOT composited                           (gsplat_cpu.cpp:223-228)
The backward (`_RasterizeDense.backward`) replays the chunks back to
front from the forward's per-chunk carry and keeps the reference's
quirks:
  - alpha re-clamped at 0.99, not 0.999         (gsplat_cpu.cpp:338)
  - T recovered by division from the final T
  - d(alpha)/d(sigma) ignores the clamp         (gsplat_cpu.cpp:362)
  - the background term in v_alpha              (gsplat_cpu.cpp:349-356)
Every gradient is a sum over pixels within a chunk: deterministic, no
atomics. Invalid Gaussians composite with opacity 0 (alpha 0 < 1/255 is
skipped in both passes), so their gradients are 0.
"""
from __future__ import annotations

from typing import Tuple

import torch

ALPHA_THRESH = 1.0 / 255.0  # records below this alpha are skipped
T_EPS = 1e-4  # a pixel stops once T would drop to or below this
FWD_ALPHA_CLAMP = 0.999
BWD_ALPHA_CLAMP = 0.99  # the reference backward re-clamps at 0.99
CHUNK = 256  # Gaussians per chunk (the JAX _pick_chunk of a padded count)


def sigma_at(A, B, C, dx, dy):
    """Gaussian exponent at pixel offset (dx, dy) = (x - px, y - py), in
    the operation order of csrc/common.cuh::sigma_at."""
    return 0.5 * (A * dx * dx + C * dy * dy) + B * dx * dy


def _pixel_grid(height: int, width: int, device):
    # reference pixel deltas: xCam = gX - j (column), yCam = gY - i (row)
    py, px = torch.meshgrid(
        torch.arange(height, dtype=torch.float32, device=device),
        torch.arange(width, dtype=torch.float32, device=device),
        indexing="ij")
    return px.reshape(-1), py.reshape(-1)  # (P,)


def _shifted_cumprod(x: torch.Tensor) -> torch.Tensor:
    """Exclusive cumulative product along dim 1."""
    return torch.cumprod(torch.cat([torch.ones_like(x[:, :1]), x[:, :-1]], 1),
                         1)


def _geometry(chunk, pjj, pii):
    gx, gy, A, B, C = chunk[:5]
    dx = gx[None, :] - pjj[:, None]  # (P, K)
    dy = gy[None, :] - pii[:, None]
    return dx, dy, sigma_at(A[None], B[None], C[None], dx, dy)


def _forward_chunk(T, done, out, chunk, pjj, pii):
    op, col = chunk[5], chunk[6]
    _, _, sigma = _geometry(chunk, pjj, pii)
    alpha = torch.clamp(op[None] * torch.exp(-sigma), max=FWD_ALPHA_CLAMP)
    used = (sigma >= 0.0) & (alpha >= ALPHA_THRESH) & ~done[:, None]
    a = torch.where(used, alpha, 0.0)
    one_minus = 1.0 - a
    Tb = T[:, None] * _shifted_cumprod(one_minus)  # T before each Gaussian
    stop = used & (Tb * one_minus <= T_EPS)
    comp = used & ~(torch.cumsum(stop.to(torch.int32), 1) > 0)
    a_eff = torch.where(comp, a, 0.0)
    vis = a_eff * T[:, None] * _shifted_cumprod(1.0 - a_eff)
    out = out + vis @ col
    T_new = T * torch.prod(1.0 - a_eff, 1)
    return T_new, done | stop.any(1), out


def _backward_chunk(T_run, buffer, chunk, T_in, done_in, pjj, pii, v_out,
                    v_oa, T_final, bg_dot):
    """One chunk of the reverse (back-to-front) replay: the carry and the
    chunk's (v_xy, v_conic, v_colour, v_opacity)."""
    A, B, C, op, col = chunk[2:7]
    dx, dy, sigma = _geometry(chunk, pjj, pii)
    vis_u = torch.exp(-sigma)
    alpha_f = torch.clamp(op[None] * vis_u, max=FWD_ALPHA_CLAMP)
    used = (sigma >= 0.0) & (alpha_f >= ALPHA_THRESH) & ~done_in[:, None]
    a_f = torch.where(used, alpha_f, 0.0)
    Tb = T_in[:, None] * _shifted_cumprod(1.0 - a_f)
    stop = used & (Tb * (1.0 - a_f) <= T_EPS)
    comp = used & ~(torch.cumsum(stop.to(torch.int32), 1) > 0)

    alpha_b = torch.where(
        comp, torch.clamp(op[None] * vis_u, max=BWD_ALPHA_CLAMP), 0.0)
    ra = 1.0 / (1.0 - alpha_b)  # 1 where not composited
    suf_incl = torch.flip(torch.cumprod(torch.flip(ra, [1]), 1), [1])
    T_k = T_run[:, None] * suf_incl  # T after the *= ra of the reference
    fac = alpha_b * T_k

    contrib = fac[:, :, None] * col[None, :, :]  # (P, K, CH)
    csum = torch.cumsum(torch.flip(contrib, [1]), 1)
    suf_excl = torch.flip(
        torch.cat([torch.zeros_like(csum[:, :1]), csum[:, :-1]], 1), [1])
    buffer_k = buffer[:, None, :] + suf_excl

    v_alpha = (
        torch.sum((col[None] * T_k[:, :, None] - buffer_k * ra[:, :, None])
                  * v_out[:, None, :], -1)
        # d final_T / d alpha_k = -final_T / (1 - alpha_k); the reference's
        # "+Tfinal*ra*v_outAlpha" term is this with out_alpha = 1 - final_T
        - T_final[:, None] * ra * v_oa[:, None]
        - T_final[:, None] * ra * bg_dot[:, None]
    )
    v_alpha = torch.where(comp, v_alpha, 0.0)
    v_sigma = -op[None] * vis_u * v_alpha

    v_col = fac.T @ v_out
    v_con = 0.5 * torch.stack([torch.sum(v_sigma * dx * dx, 0),
                               torch.sum(v_sigma * dx * dy, 0),
                               torch.sum(v_sigma * dy * dy, 0)], -1)
    v_xy = torch.stack([torch.sum(v_sigma * (A[None] * dx + B[None] * dy), 0),
                        torch.sum(v_sigma * (B[None] * dx + C[None] * dy), 0)],
                       -1)
    v_op = torch.sum(vis_u * v_alpha, 0)
    carry = (T_run * torch.prod(ra, 1), buffer + torch.sum(contrib, 1))
    return carry, (v_xy, v_con, v_col, v_op)


def _chunks(xys_s, conics_s, colors_s, opac_s):
    """Per-chunk views (gx, gy, A, B, C, opacity, colours)."""
    n_chunks = xys_s.shape[0] // CHUNK
    fields = (xys_s[:, 0], xys_s[:, 1], conics_s[:, 0], conics_s[:, 1],
              conics_s[:, 2], opac_s, colors_s)
    return [tuple(f[i * CHUNK:(i + 1) * CHUNK] for f in fields)
            for i in range(n_chunks)]


class _RasterizeDense(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xys, conics, colors, opac, background, valid, order,
                height, width):
        n = xys.shape[0]
        n_pad = -(-n // CHUNK) * CHUNK

        def sorted_padded(x):
            xs = x.detach().to(torch.float32)[order]
            return torch.cat([xs, xs.new_zeros((n_pad - n,) + xs.shape[1:])])

        # invalid slots never composite nor receive gradient: alpha == 0
        opac_s = sorted_padded(torch.where(valid, opac.detach(), 0.0))
        xys_s, conics_s, colors_s = map(sorted_padded, (xys, conics, colors))
        bg = background.detach().to(torch.float32)
        dev = xys.device
        pjj, pii = _pixel_grid(height, width, dev)
        P = height * width
        T = torch.ones((P,), dtype=torch.float32, device=dev)
        done = torch.zeros((P,), dtype=torch.bool, device=dev)
        out = torch.zeros((P, colors.shape[-1]), dtype=torch.float32,
                          device=dev)
        T_ins, done_ins = [], []
        for chunk in _chunks(xys_s, conics_s, colors_s, opac_s):
            T_ins.append(T)
            done_ins.append(done)
            T, done, out = _forward_chunk(T, done, out, chunk, pjj, pii)
        out = out + T[:, None] * bg[None, :]
        ctx.save_for_backward(xys_s, conics_s, colors_s, opac_s, bg, T, order,
                              *T_ins, *done_ins)
        ctx.hw = (height, width)
        ctx.n = n
        return out.reshape(height, width, -1), T.reshape(height, width)

    @staticmethod
    def backward(ctx, v_img, v_ft):
        xys_s, conics_s, colors_s, opac_s, bg, T_final, order, *carry = (
            ctx.saved_tensors)
        n_chunks = len(carry) // 2
        T_ins, done_ins = carry[:n_chunks], carry[n_chunks:]
        height, width = ctx.hw
        dev = xys_s.device
        P = height * width
        ch = colors_s.shape[-1]
        v_out = (torch.zeros((P, ch), device=dev) if v_img is None
                 else v_img.reshape(P, ch).to(torch.float32))
        v_oa = (torch.zeros((P,), device=dev) if v_ft is None
                else v_ft.reshape(P).to(torch.float32))
        bg_dot = v_out @ bg
        pjj, pii = _pixel_grid(height, width, dev)
        chunks = _chunks(xys_s, conics_s, colors_s, opac_s)
        T_run = T_final
        buffer = torch.zeros((P, ch), dtype=torch.float32, device=dev)
        grads = [None] * n_chunks
        for i in reversed(range(n_chunks)):
            (T_run, buffer), grads[i] = _backward_chunk(
                T_run, buffer, chunks[i], T_ins[i], done_ins[i], pjj, pii,
                v_out, v_oa, T_final, bg_dot)

        def unsorted(parts):
            g_s = torch.cat(parts)[:ctx.n]
            g = torch.empty_like(g_s)
            g[order] = g_s  # a permutation: unique indices
            return g

        n = ctx.n
        if n_chunks:
            v_xys, v_conics, v_colors, v_opac = (
                unsorted([g[k] for g in grads]) for k in range(4))
        else:
            v_xys = xys_s.new_zeros((n, 2))
            v_conics = xys_s.new_zeros((n, 3))
            v_colors = xys_s.new_zeros((n, ch))
            v_opac = xys_s.new_zeros((n,))
        # background gradient: out += T_final * bg (exact; the reference
        # never uses it)
        v_bg = T_final @ v_out
        return v_xys, v_conics, v_colors, v_opac, v_bg, None, None, None, None


def rasterize(
    xys: torch.Tensor,
    conics: torch.Tensor,
    colors: torch.Tensor,
    opacities: torch.Tensor,
    depths: torch.Tensor,
    valid: torch.Tensor,
    background: torch.Tensor,
    height: int,
    width: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depth-sort and rasterize N Gaussians to an (H, W, CH) image.

    colors: (N, CH) for any channel count CH (the reference's nd_
    variant, forward.cu:174-254, included); background: (CH,).
    opacities: (N,) or (N, 1) post-sigmoid. valid: (N,) bool (alive and
    radii > 0). Differentiable with respect to xys, conics, colors,
    opacities and background, with the reference CPU backward's
    semantics. Runs on the inputs' device. Returns (img (H, W, CH),
    final_T (H, W)).
    """
    opac = opacities.reshape(-1)
    key = torch.where(valid, depths.detach(), torch.inf)
    order = torch.argsort(key, stable=True)
    return _RasterizeDense.apply(xys, conics, colors, opac,
                                 background.to(torch.float32), valid, order,
                                 height, width)
