"""Camera matrix helpers (OpenGL-convention projection, gsplat view matrix).

Counterpart of opensplat_tpu/ops/camera.py (reference model.cpp:35-47 and
model.cpp:83-113). All math in float32 on the pose's device.
"""
from __future__ import annotations

import torch

from .views import aligned

Z_NEAR = 0.001
Z_FAR = 1000.0


def projection_matrix(z_near: float, z_far: float, fov_x, fov_y,
                      device="cpu") -> torch.Tensor:
    """OpenGL perspective projection; row 3 = [0, 0, 1, 0] (w = view z)."""
    f32 = torch.float32
    fov_x = torch.as_tensor(fov_x, dtype=f32, device=device)
    fov_y = torch.as_tensor(fov_y, dtype=f32, device=device)
    t = z_near * torch.tan(0.5 * fov_y)
    b = -t
    r = z_near * torch.tan(0.5 * fov_x)
    l = -r
    m = torch.zeros((4, 4), dtype=f32, device=device)
    m[0, 0] = 2.0 * z_near / (r - l)
    m[0, 2] = (r + l) / (r - l)
    m[1, 1] = 2.0 * z_near / (t - b)
    m[1, 2] = (t + b) / (t - b)
    m[2, 2] = (z_far + z_near) / (z_far - z_near)
    m[2, 3] = -1.0 * z_far * z_near / (z_far - z_near)
    m[3, 2] = 1.0
    return m


def camera_matrices(cam_to_world: torch.Tensor, fx, fy, width: int, height: int):
    """(viewmat, full_projmat, cam_pos) from a 4x4 camera-to-world pose,
    with the gsplat y/z flip. cam_pos is the camera origin before the
    flip (used for SH view directions, model.cpp:176). V poses (V, 4, 4)
    with V values each of fx and fy give each stacked (V, ...), each
    view's the bits of its own call."""
    if cam_to_world.dim() == 3:
        return tuple(torch.stack(m) for m in zip(*(
            camera_matrices(aligned(c), x, y, width, height)
            for c, x, y in zip(cam_to_world, fx, fy))))
    c2w = cam_to_world.to(torch.float32)
    dev = c2w.device
    R = c2w[:3, :3]
    T = c2w[:3, 3]
    flip = torch.diag(torch.tensor([1.0, -1.0, -1.0], dtype=torch.float32,
                                   device=dev))
    Rinv = (R @ flip).T
    Tinv = -Rinv @ T
    viewmat = torch.eye(4, dtype=torch.float32, device=dev)
    viewmat[:3, :3] = Rinv
    viewmat[:3, 3] = Tinv
    fov_x = 2.0 * torch.atan(torch.tensor(width / (2.0 * fx), dtype=torch.float32))
    fov_y = 2.0 * torch.atan(torch.tensor(height / (2.0 * fy), dtype=torch.float32))
    projmat = projection_matrix(Z_NEAR, Z_FAR, fov_x, fov_y, device=dev)
    return viewmat, projmat @ viewmat, T
