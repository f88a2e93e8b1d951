"""NumPy conformance oracle: a direct semantic port of the reference's
always-built CPU backend (gsplat-cpu/gsplat_cpu.cpp), kept deliberately
simple and loop-based so it can be trusted as ground truth.

The port's copy of opensplat_tpu/oracle/np_oracle.py: projection, the
forward and backward rasterizer and SH. Quirks reproduced on purpose:
  - forward alpha clamp 0.999, backward alpha clamp 0.99
    (gsplat_cpu.cpp:220 vs :338)
  - alpha < 1/255 skip, sigma < 0 skip
  - per-pixel done flag at T <= 1e-4; the Gaussian that would cross the
    threshold is NOT composited (gsplat_cpu.cpp:223-228)
  - backward ignores the clamp in d(alpha)/d(sigma) (gsplat_cpu.cpp:362)
  - det clamped to 1e-6; principal point pinned to the image center;
    no near-plane cull (projection, gsplat_cpu.cpp:48-131)

This module is float32 NumPy on the host; the CLI's `--oracle-check`
and the tests use it.
"""
from __future__ import annotations

import numpy as np

ALPHA_THRESH = 1.0 / 255.0


def _quat_to_rot(quats: np.ndarray) -> np.ndarray:
    q = quats / np.linalg.norm(quats, axis=-1, keepdims=True)
    w, x, y, z = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    R = np.empty(q.shape[:-1] + (3, 3), dtype=np.float32)
    R[:, 0, 0] = 1 - 2 * (y * y + z * z)
    R[:, 0, 1] = 2 * (x * y - w * z)
    R[:, 0, 2] = 2 * (x * z + w * y)
    R[:, 1, 0] = 2 * (x * y + w * z)
    R[:, 1, 1] = 1 - 2 * (x * x + z * z)
    R[:, 1, 2] = 2 * (y * z - w * x)
    R[:, 2, 0] = 2 * (x * z - w * y)
    R[:, 2, 1] = 2 * (y * z + w * x)
    R[:, 2, 2] = 1 - 2 * (x * x + y * y)
    return R


def np_project_gaussians(
    means, scales, glob_scale, quats, viewmat, projmat, fx, fy, cx, cy, height, width
):
    """CPU-path projection. Returns (xys, radii, conics, cov2d(2x2), cam_depths)."""
    means = np.asarray(means, np.float32)
    scales = np.asarray(scales, np.float32)
    quats = np.asarray(quats, np.float32)
    viewmat = np.asarray(viewmat, np.float32)
    projmat = np.asarray(projmat, np.float32)

    fovx = 0.5 * width / fx
    fovy = 0.5 * height / fy

    Rv = viewmat[:3, :3]
    tv = viewmat[:3, 3]
    p_view = means @ Rv.T + tv

    R = _quat_to_rot(quats)
    M = R * (glob_scale * scales)[:, None, :]
    cov3d = M @ np.swapaxes(M, -1, -2)

    lim_x, lim_y = 1.3 * fovx, 1.3 * fovy
    z = p_view[:, 2]
    tx = z * np.minimum(lim_x, np.maximum(-lim_x, p_view[:, 0] / z))
    ty = z * np.minimum(lim_y, np.maximum(-lim_y, p_view[:, 1] / z))
    rz = 1.0 / z
    rz2 = rz * rz
    J = np.zeros((means.shape[0], 2, 3), np.float32)
    J[:, 0, 0] = fx * rz
    J[:, 0, 2] = -fx * tx * rz2
    J[:, 1, 1] = fy * rz
    J[:, 1, 2] = -fy * ty * rz2
    T = J @ Rv
    cov2d = T @ cov3d @ np.swapaxes(T, -1, -2)
    cov2d[:, 0, 0] += 0.3
    cov2d[:, 1, 1] += 0.3

    det = cov2d[:, 0, 0] * cov2d[:, 1, 1] - cov2d[:, 0, 1] ** 2
    det = np.maximum(det, 1e-6)
    conic = np.stack(
        [cov2d[:, 1, 1] / det, -cov2d[:, 0, 1] / det, cov2d[:, 0, 0] / det], axis=-1
    )
    b = 0.5 * (cov2d[:, 0, 0] + cov2d[:, 1, 1])
    sq = np.sqrt(np.maximum(b * b - det, 0.1))
    radius = np.ceil(3.0 * np.sqrt(np.maximum(b + sq, b - sq)))

    p_hom = means @ projmat[:, :3].T + projmat[:, 3]
    rw = 1.0 / np.maximum(p_hom[:, 3], 1e-6)
    p_proj = p_hom[:, :3] * rw[:, None]
    u = 0.5 * ((p_proj[:, 0] + 1.0) * width - 1.0)
    v = 0.5 * ((p_proj[:, 1] + 1.0) * height - 1.0)
    xys = np.stack([u, v], axis=-1)
    return xys, radius.astype(np.int32), conic, cov2d, p_proj[:, 2]


def _composite(width, height, xys, conics, opac, cov2d, cam_depths, T,
               done):
    """The reference's front-to-back loop over Gaussians in depth order
    (a stable sort of cam_depths). Updates T and done in place and
    yields, per Gaussian that reaches the image, (gid, (r0, r1, c0, c1),
    comp, vis): its pixel block, which of its pixels it is composited
    into, and there alpha * T."""
    if cov2d.ndim == 3:
        c00, c11 = cov2d[:, 0, 0], cov2d[:, 1, 1]
    else:
        c00, c11 = cov2d[:, 0], cov2d[:, 2]
    order = np.argsort(np.asarray(cam_depths, np.float32), kind="stable")
    sq_x = 3.0 * np.sqrt(c00)
    sq_y = 3.0 * np.sqrt(c11)

    for gid in order:
        A, B, C = conics[gid]
        gx, gy = xys[gid]
        r0 = max(0, int(np.floor(gy - sq_y[gid])) - 2)
        r1 = min(height, int(np.ceil(gy + sq_y[gid])) + 2)
        c0 = max(0, int(np.floor(gx - sq_x[gid])) - 2)
        c1 = min(width, int(np.ceil(gx + sq_x[gid])) + 2)
        if r0 >= r1 or c0 >= c1:
            continue
        # vectorize the bbox block; per-pixel state updates are independent
        jj, ii = np.meshgrid(np.arange(c0, c1), np.arange(r0, r1))
        dx = gx - jj.astype(np.float32)
        dy = gy - ii.astype(np.float32)
        sigma = 0.5 * (A * dx * dx + C * dy * dy) + B * dx * dy
        alpha = np.minimum(0.999, opac[gid] * np.exp(-sigma))
        use = (~done[r0:r1, c0:c1]) & (sigma >= 0.0) & (alpha >= ALPHA_THRESH)
        t_blk = T[r0:r1, c0:c1]
        next_t = t_blk * (1.0 - alpha)
        stop = use & (next_t <= 1e-4)
        comp = use & ~stop
        vis = np.where(comp, alpha * t_blk, 0.0)
        T[r0:r1, c0:c1] = np.where(comp, next_t, t_blk)
        done[r0:r1, c0:c1] |= stop
        yield int(gid), (r0, r1, c0, c1), comp, vis


def _inputs(xys, conics, opacities, cov2d):
    return (np.asarray(xys, np.float32), np.asarray(conics, np.float32),
            np.asarray(opacities, np.float32).reshape(-1),
            np.asarray(cov2d, np.float32))


def np_rasterize_forward(
    width, height, xys, conics, colors, opacities, background, cov2d,
    cam_depths,
):
    """Scalar-semantics rasterize forward.

    opacities: (N,) post-sigmoid. colors: (N, 3). cov2d: (N, 2, 2) or (N, 3)
    upper-tri. Returns (out_img(H,W,3), final_Ts(H,W)). The backward's
    per-pixel Gaussian lists come from np_pixel_gaussians (the JAX copy
    returns them from here as a third output).
    """
    xys, conics, opac, cov2d = _inputs(xys, conics, opacities, cov2d)
    colors = np.asarray(colors, np.float32)
    bg = np.asarray(background, np.float32)
    out = np.zeros((height, width, 3), np.float32)
    T = np.ones((height, width), np.float32)
    done = np.zeros((height, width), bool)
    for gid, (r0, r1, c0, c1), _, vis in _composite(
            width, height, xys, conics, opac, cov2d, cam_depths, T, done):
        out[r0:r1, c0:c1] += vis[..., None] * colors[gid]
    out += T[..., None] * bg
    return out, T


def np_pixel_gaussians(width, height, xys, conics, opacities, cov2d,
                       cam_depths):
    """Per pixel (row-major), the Gaussians composited into it, back to
    front: the px2gid lists np_rasterize_backward reads (the reference's
    reversal)."""
    xys, conics, opac, cov2d = _inputs(xys, conics, opacities, cov2d)
    T = np.ones((height, width), np.float32)
    done = np.zeros((height, width), bool)
    px2gid = [[] for _ in range(height * width)]
    for gid, (r0, _, c0, _), comp, _ in _composite(
            width, height, xys, conics, opac, cov2d, cam_depths, T, done):
        for i, j in zip(*np.nonzero(comp)):
            px2gid[(r0 + i) * width + (c0 + j)].append(gid)
    for lst in px2gid:
        lst.reverse()
    return px2gid


def np_rasterize_backward(
    height,
    width,
    xys,
    conics,
    colors,
    opacities,
    background,
    final_Ts,
    px2gid,
    v_out,
    v_out_alpha,
):
    """Scalar-semantics rasterize backward (gsplat_cpu.cpp:267-376);
    px2gid from np_pixel_gaussians.

    Returns (v_xy(N,2), v_conic(N,3), v_colors(N,3), v_opacity(N,1)).
    """
    xys = np.asarray(xys, np.float32)
    conics = np.asarray(conics, np.float32)
    colors = np.asarray(colors, np.float32)
    opac = np.asarray(opacities, np.float32).reshape(-1)
    bg = np.asarray(background, np.float32)
    v_out = np.asarray(v_out, np.float32)
    v_out_alpha = np.asarray(v_out_alpha, np.float32)

    n = xys.shape[0]
    v_xy = np.zeros((n, 2), np.float32)
    v_conic = np.zeros((n, 3), np.float32)
    v_colors = np.zeros((n, 3), np.float32)
    v_opacity = np.zeros((n, 1), np.float32)

    for i in range(height):
        for j in range(width):
            pix = i * width + j
            T_final = final_Ts[i, j]
            T = T_final
            buf = np.zeros(3, np.float32)
            vo = v_out[i, j]
            voa = v_out_alpha[i, j]
            for gid in px2gid[pix]:
                A, B, C = conics[gid]
                gx, gy = xys[gid]
                dx = gx - j
                dy = gy - i
                sigma = 0.5 * (A * dx * dx + C * dy * dy) + B * dx * dy
                if sigma < 0:
                    continue
                vis = np.exp(-sigma)
                alpha = min(0.99, opac[gid] * vis)
                if alpha < ALPHA_THRESH:
                    continue
                ra = 1.0 / (1.0 - alpha)
                T = T * ra
                fac = alpha * T
                v_colors[gid] += fac * vo
                v_alpha = (
                    np.dot(colors[gid] * T - buf * ra, vo)
                    + T_final * ra * voa
                    - T_final * ra * np.dot(bg, vo)
                )
                buf += colors[gid] * fac
                v_sigma = -opac[gid] * vis * v_alpha
                v_conic[gid] += 0.5 * v_sigma * np.array(
                    [dx * dx, dx * dy, dy * dy], np.float32
                )
                v_xy[gid] += v_sigma * np.array(
                    [A * dx + B * dy, B * dx + C * dy], np.float32)
                v_opacity[gid, 0] += vis * v_alpha
    return v_xy, v_conic, v_colors, v_opacity


# --- SH oracle (gsplat_cpu.cpp:379-486) ------------------------------------
_SH_C0 = 0.28209479177387814
_SH_C1 = 0.4886025119029199
_SH_C2 = [1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
          -1.0925484305920792, 0.5462742152960396]
_SH_C3 = [-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
          0.3731763325901154, -0.4570457994644658, 1.445305721320277,
          -0.5900435899266435]
_SH_C4 = [2.5033429417967046, -1.7701307697799304, 0.9461746957575601,
          -0.6690465435572892, 0.10578554691520431, -0.6690465435572892,
          0.47308734787878004, -1.7701307697799304, 0.6258357354491761]

_N_BASES = {0: 1, 1: 4, 2: 9, 3: 16, 4: 25}


def np_sh_forward(degree, degrees_to_use, viewdirs, coeffs):
    viewdirs = np.asarray(viewdirs, np.float32)
    coeffs = np.asarray(coeffs, np.float32)
    n = viewdirs.shape[0]
    n_total = _N_BASES[degree]
    n_used = _N_BASES[degrees_to_use]
    basis = np.zeros((n, n_total), np.float32)
    basis[:, 0] = _SH_C0
    if n_used > 1:
        x, y, z = viewdirs[:, 0], viewdirs[:, 1], viewdirs[:, 2]
        basis[:, 1] = _SH_C1 * -y
        basis[:, 2] = _SH_C1 * z
        basis[:, 3] = _SH_C1 * -x
        if n_used > 4:
            xx, yy, zz = x * x, y * y, z * z
            xy, yz, xz = x * y, y * z, x * z
            basis[:, 4] = _SH_C2[0] * xy
            basis[:, 5] = _SH_C2[1] * yz
            basis[:, 6] = _SH_C2[2] * (2 * zz - xx - yy)
            basis[:, 7] = _SH_C2[3] * xz
            basis[:, 8] = _SH_C2[4] * (xx - yy)
            if n_used > 9:
                basis[:, 9] = _SH_C3[0] * y * (3 * xx - yy)
                basis[:, 10] = _SH_C3[1] * xy * z
                basis[:, 11] = _SH_C3[2] * y * (4 * zz - xx - yy)
                basis[:, 12] = _SH_C3[3] * z * (2 * zz - 3 * xx - 3 * yy)
                basis[:, 13] = _SH_C3[4] * x * (4 * zz - xx - yy)
                basis[:, 14] = _SH_C3[5] * z * (xx - yy)
                basis[:, 15] = _SH_C3[6] * x * (xx - 3 * yy)
                if n_used > 16:
                    basis[:, 16] = _SH_C4[0] * xy * (xx - yy)
                    basis[:, 17] = _SH_C4[1] * yz * (3 * xx - yy)
                    basis[:, 18] = _SH_C4[2] * xy * (7 * zz - 1)
                    basis[:, 19] = _SH_C4[3] * yz * (7 * zz - 3)
                    basis[:, 20] = _SH_C4[4] * (zz * (35 * zz - 30) + 3)
                    basis[:, 21] = _SH_C4[5] * xz * (7 * zz - 3)
                    basis[:, 22] = _SH_C4[6] * (xx - yy) * (7 * zz - 1)
                    basis[:, 23] = _SH_C4[7] * xz * (xx - 3 * yy)
                    basis[:, 24] = _SH_C4[8] * (xx * (xx - 3 * yy) - yy * (3 * xx - yy))
    return np.einsum("nb,nbc->nc", basis, coeffs)
