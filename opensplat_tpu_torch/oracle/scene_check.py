"""Whole-scene oracle rendering: draw a trained Gaussian scene through the
NumPy conformance oracle (the port of the reference's always-built CPU
backend, gsplat-cpu/gsplat_cpu.cpp) end-to-end — projection, SH, rasterize
— mirroring Model::forward (model.cpp:83-225) on the host.

The port's copy of opensplat_tpu/oracle/scene_check.py. The CLI's
--oracle-check uses it to cross-check that a SAVED scene (.ply
round-trip included) renders the same through an independent
implementation as through the port's kernels.
"""
from __future__ import annotations

import numpy as np

from .np_oracle import np_project_gaussians, np_rasterize_forward, np_sh_forward

_N_BASES_TO_DEGREE = {1: 0, 4: 1, 9: 2, 16: 3, 25: 4}


def _host(x) -> np.ndarray:
    if hasattr(x, "detach"):  # a torch tensor, on any device
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _camera_matrices_np(cam_to_world: np.ndarray, fx, fy, width, height):
    """NumPy twin of ops.camera.camera_matrices (model.cpp:93-113)."""
    c2w = np.asarray(cam_to_world, np.float32)
    R = c2w[:3, :3]
    T = c2w[:3, 3]
    Rf = R @ np.diag(np.array([1.0, -1.0, -1.0], np.float32))
    viewmat = np.eye(4, dtype=np.float32)
    viewmat[:3, :3] = Rf.T
    viewmat[:3, 3] = -Rf.T @ T

    z_near, z_far = 0.001, 1000.0
    fov_x = 2.0 * np.arctan(width / (2.0 * fx))
    fov_y = 2.0 * np.arctan(height / (2.0 * fy))
    t = z_near * np.tan(0.5 * fov_y)
    r = z_near * np.tan(0.5 * fov_x)
    proj = np.zeros((4, 4), np.float32)
    proj[0, 0] = z_near / r
    proj[1, 1] = z_near / t
    proj[2, 2] = (z_far + z_near) / (z_far - z_near)
    proj[2, 3] = -z_far * z_near / (z_far - z_near)
    proj[3, 2] = 1.0
    return viewmat, proj @ viewmat, T


def sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


def oracle_render_scene(
    params,
    alive,
    cam_to_world,
    fx,
    fy,
    cx,
    cy,
    height: int,
    width: int,
    sh_degrees_to_use: int,
    background,
) -> np.ndarray:
    """Render (H, W, 3) float32 via the NumPy oracle. `params` holds
    tensors (any device) or numpy arrays; dead capacity slots are
    dropped up front."""
    alive = _host(alive).astype(bool)

    def leaf(x):
        return _host(x).astype(np.float32)[alive]

    means = leaf(params.means)
    scales = np.exp(leaf(params.scales))
    quats = leaf(params.quats)
    quats = quats / np.linalg.norm(quats, axis=-1, keepdims=True)
    f_dc = leaf(params.features_dc)
    f_rest = leaf(params.features_rest)
    opac = sigmoid(leaf(params.opacities)).reshape(-1)

    viewmat, projmat, cam_pos = _camera_matrices_np(
        cam_to_world, fx, fy, width, height
    )
    xys, radii, conics, cov2d, cam_depths = np_project_gaussians(
        means, scales, 1.0, quats, viewmat, projmat,
        fx, fy, cx, cy, height, width,
    )

    viewdirs = means - cam_pos[None, :]
    viewdirs = viewdirs / np.maximum(
        np.linalg.norm(viewdirs, axis=-1, keepdims=True), 1e-12
    )
    coeffs = np.concatenate([f_dc[:, None, :], f_rest], axis=1)
    degree = _N_BASES_TO_DEGREE[coeffs.shape[1]]
    rgbs = np_sh_forward(degree, sh_degrees_to_use, viewdirs, coeffs)
    rgbs = np.maximum(rgbs + 0.5, 0.0)  # model.cpp:192

    img, _ = np_rasterize_forward(
        width, height, xys, conics, rgbs, opac,
        np.asarray(background, np.float32), cov2d, cam_depths,
    )
    return np.minimum(img, 1.0)  # model.cpp:222


def psnr(a: np.ndarray, b: np.ndarray) -> float:
    mse = float(np.mean((np.asarray(a, np.float32) - np.asarray(b, np.float32)) ** 2))
    if mse <= 0:
        return float("inf")
    return float(10.0 * np.log10(1.0 / mse))
