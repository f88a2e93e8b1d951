"""Geometry helpers (quaternions, Morton order).

Counterpart of opensplat_tpu/ops/tensor_math.py: quat_to_rotmat and
random_quat on tensors, morton_order as its own numpy copy.
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
