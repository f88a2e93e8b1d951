"""Geometry helpers (quaternions, Morton order).

Counterpart of opensplat_tpu/ops/tensor_math.py: quat_to_rotmat and
random_quat on tensors; morton_order and the loaders' pose helpers
(auto_scale_and_center_poses, rodrigues_to_rotation, rotation_matrix) as
their own numpy copies.
"""
from __future__ import annotations

import math

import numpy as np
import torch


def quat_to_rotmat(quat: torch.Tensor) -> torch.Tensor:
    """(..., 4) wxyz quaternion -> (..., 3, 3) rotation matrix.
    Normalizes first, as the reference does."""
    q = quat / torch.linalg.norm(quat, dim=-1, keepdim=True)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    rows = [
        [1.0 - 2.0 * (y * y + z * z), 2.0 * (x * y - w * z), 2.0 * (x * z + w * y)],
        [2.0 * (x * y + w * z), 1.0 - 2.0 * (x * x + z * z), 2.0 * (y * z - w * x)],
        [2.0 * (x * z - w * y), 2.0 * (y * z + w * x), 1.0 - 2.0 * (x * x + y * y)],
    ]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def random_quat(n: int, generator: torch.Generator) -> torch.Tensor:
    """n uniformly distributed unit quaternions (Shoemake), (n, 4) wxyz,
    on the generator's device. The draws differ from jax.random's."""
    u, v, w = torch.rand((3, n), generator=generator, device=generator.device)
    two_pi = 2.0 * math.pi
    return torch.stack(
        [
            torch.sqrt(1.0 - u) * torch.sin(two_pi * v),
            torch.sqrt(1.0 - u) * torch.cos(two_pi * v),
            torch.sqrt(u) * torch.sin(two_pi * w),
            torch.sqrt(u) * torch.cos(two_pi * w),
        ],
        dim=-1,
    )


def _part1by2_np(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.uint64) & 0x3FF
    x = (x | (x << 16)) & np.uint64(0x30000FF)
    x = (x | (x << 8)) & np.uint64(0x300F00F)
    x = (x | (x << 4)) & np.uint64(0x30C30C3)
    x = (x | (x << 2)) & np.uint64(0x9249249)
    return x


def morton_order(points: np.ndarray) -> np.ndarray:
    """Permutation sorting points along a 3D Morton (Z-order) curve, so
    that spatially nearby Gaussians sit next to each other in memory and
    the rasterizer's per-record gathers stay index-coherent."""
    lo = points.min(axis=0)
    span = points.max(axis=0) - lo
    span[span == 0] = 1.0
    q = np.clip((points - lo) / span * 1023.0, 0, 1023).astype(np.uint32)
    key = (
        _part1by2_np(q[:, 0])
        | (_part1by2_np(q[:, 1]) << 1)
        | (_part1by2_np(q[:, 2]) << 2)
    )
    return np.argsort(key, kind="stable")


def auto_scale_and_center_poses(poses: np.ndarray):
    """Center camera origins at their mean; scale so max |coord| == 1.

    poses: (C, 4, 4) camera-to-world matrices (numpy, host-side).
    Returns (transformed_poses, translation(3,), scale float).
    Reference: tensor_math.cpp:30-44. The returned (translation, scale) is
    the global CRS transform reused by PLY export and cameras.json.
    """
    poses = np.asarray(poses, dtype=np.float32).copy()
    origins = poses[..., :3, 3]
    center = origins.mean(axis=0)
    origins = origins - center
    f = 1.0 / np.abs(origins).max()
    poses[..., :3, 3] = origins * f
    return poses, center, float(f)


def rodrigues_to_rotation(rodrigues: np.ndarray) -> np.ndarray:
    """Axis-angle (3,) -> rotation matrix (3, 3). Host-side numpy.

    Reference: tensor_math.cpp:70-92 (used by the OpenSFM loader).
    """
    r = np.asarray(rodrigues, dtype=np.float32)
    theta = float(np.linalg.norm(r))
    if theta < 1e-9:
        return np.eye(3, dtype=np.float32)
    k = r / theta
    K = np.array(
        [
            [0.0, -k[2], k[1]],
            [k[2], 0.0, -k[0]],
            [-k[1], k[0], 0.0],
        ],
        dtype=np.float32,
    )
    rrT = np.outer(k, k).astype(np.float32)
    c = np.cos(theta)
    return (c * np.eye(3, dtype=np.float32) + (1.0 - c) * rrT
            + np.sin(theta) * K).astype(np.float32)


def rotation_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Rotation carrying unit-direction `a` onto `b` (Rodrigues form;
    the reference's rotationMatrix, tensor_math.cpp:47-68). Anti-parallel
    input falls back to a 180-degree rotation about an orthogonal axis."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    a = a / np.linalg.norm(a)
    b = b / np.linalg.norm(b)
    v = np.cross(a, b)
    c = float(np.dot(a, b))
    if c < -1.0 + 1e-8:
        # 180 degrees: rotate about any axis orthogonal to a
        axis = np.cross(a, [1.0, 0.0, 0.0])
        if np.linalg.norm(axis) < 1e-8:
            axis = np.cross(a, [0.0, 1.0, 0.0])
        axis /= np.linalg.norm(axis)
        return rodrigues_to_rotation(axis * np.pi).astype(np.float32)
    k = np.array([
        [0.0, -v[2], v[1]],
        [v[2], 0.0, -v[0]],
        [-v[1], v[0], 0.0],
    ])
    r = np.eye(3) + k + k @ k * (1.0 / (1.0 + c))
    return r.astype(np.float32)
