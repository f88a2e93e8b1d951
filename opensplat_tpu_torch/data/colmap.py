"""COLMAP binary project loader.

The port's copy of opensplat_tpu/data/colmap.py, on the port's tensor_math.

Behavioral spec: reference colmap.cpp:11-157.
  - cameras.bin: u64 count; per camera u32 id, i32 model, u64 w, u64 h,
    model-dependent f64 params (colmap.cpp:37-76). Supported models:
    SimplePinhole(0), Pinhole(1), SimpleRadial(2), OpenCV(4)
    (colmap.hpp:10-13).
  - images.bin: u64 count; per image u32 id, 4x f64 qvec (wxyz), 3x f64
    tvec, u32 cam_id, null-terminated name, u64 n2d, n2d x 24 bytes skipped
    (colmap.cpp:84-135). Pose: Rinv=R^T, Tinv=-Rinv@T, then the OpenCV->
    OpenGL flip of columns 1:3 (colmap.cpp:100-125).
  - Poses normalized by auto_scale_and_center_poses; points transformed
    (p - translation) * scale (colmap.cpp:139-152).
"""
from __future__ import annotations

import os
import struct

import numpy as np

from ..ops.tensor_math import auto_scale_and_center_poses
from .dataset import Camera, InputData
from .point_io import read_colmap_points3d

_SIMPLE_PINHOLE, _PINHOLE, _SIMPLE_RADIAL, _RADIAL, _OPENCV = 0, 1, 2, 3, 4


def _quat_to_rotmat_np(q: np.ndarray) -> np.ndarray:
    """wxyz quaternion -> 3x3 rotation (numpy twin of ops.tensor_math)."""
    q = q / np.linalg.norm(q)
    w, x, y, z = q
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ],
        np.float32,
    )


def _read_cameras_bin(path: str):
    cams = {}
    with open(path, "rb") as f:
        (num,) = struct.unpack("<Q", f.read(8))
        for _ in range(num):
            cam_id, model = struct.unpack("<Ii", f.read(8))
            width, height = struct.unpack("<QQ", f.read(16))
            c = Camera(width=int(width), height=int(height), fx=0, fy=0, cx=0, cy=0)
            c.cam_id = cam_id
            if model == _SIMPLE_PINHOLE:
                c.fx, c.cx, c.cy = struct.unpack("<3d", f.read(24))
                c.fy = c.fx
            elif model == _PINHOLE:
                c.fx, c.fy, c.cx, c.cy = struct.unpack("<4d", f.read(32))
            elif model == _SIMPLE_RADIAL:
                c.fx, c.cx, c.cy, c.k1 = struct.unpack("<4d", f.read(32))
                c.fy = c.fx
            elif model == _OPENCV:
                (c.fx, c.fy, c.cx, c.cy, c.k1, c.k2, c.p1, c.p2) = struct.unpack(
                    "<8d", f.read(64)
                )
            else:
                raise RuntimeError(f"Unsupported camera model: {model}")
            cams[cam_id] = c
    return cams


def _read_images_bin(path: str):
    """Returns list of (qvec, tvec, cam_id, name)."""
    out = []
    with open(path, "rb") as f:
        (num,) = struct.unpack("<Q", f.read(8))
        for _ in range(num):
            struct.unpack("<I", f.read(4))  # image id (unused, colmap.cpp:85)
            qvec = np.array(struct.unpack("<4d", f.read(32)), np.float32)
            tvec = np.array(struct.unpack("<3d", f.read(24)), np.float32)
            (cam_id,) = struct.unpack("<I", f.read(4))
            name = b""
            while True:
                ch = f.read(1)
                if ch == b"\x00" or ch == b"":
                    break
                name += ch
            (n2d,) = struct.unpack("<Q", f.read(8))
            f.seek(24 * n2d, os.SEEK_CUR)  # 2x f64 + u64 per 2D point
            out.append((qvec, tvec, cam_id, name.decode("utf-8")))
    return out


def load_colmap(project_root: str, colmap_image_path: str = "") -> InputData:
    root = project_root
    if not os.path.exists(os.path.join(root, "cameras.bin")) and os.path.exists(
        os.path.join(root, "sparse", "0", "cameras.bin")
    ):
        root = os.path.join(root, "sparse", "0")
    cameras_path = os.path.join(root, "cameras.bin")
    images_path = os.path.join(root, "images.bin")
    points_path = os.path.join(root, "points3D.bin")
    for p in (cameras_path, images_path, points_path):
        if not os.path.exists(p):
            raise RuntimeError(f"{p} does not exist")

    cam_map = _read_cameras_bin(cameras_path)
    images = _read_images_bin(images_path)

    cameras = []
    poses = np.zeros((len(images), 4, 4), np.float32)
    for i, (qvec, tvec, cam_id, name) in enumerate(images):
        R = _quat_to_rotmat_np(qvec)
        Rinv = R.T
        Tinv = -Rinv @ tvec
        poses[i, :3, :3] = Rinv
        poses[i, :3, 3] = Tinv
        poses[i, 3, 3] = 1.0
        # COLMAP camera CRS (OpenCV) -> OpenGL (colmap.cpp:125)
        poses[i, 0:3, 1:3] *= -1.0

        cam = Camera(**{k: getattr(cam_map[cam_id], k) for k in (
            "width", "height", "fx", "fy", "cx", "cy",
            "k1", "k2", "k3", "p1", "p2")})
        cam.cam_id = cam_id
        if colmap_image_path:
            cam.file_path = os.path.join(colmap_image_path, name)
        else:
            cam.file_path = os.path.join(project_root, "images", name)
        cameras.append(cam)

    poses, translation, scale = auto_scale_and_center_poses(poses)
    for i, cam in enumerate(cameras):
        cam.cam_to_world = poses[i]

    pset = read_colmap_points3d(points_path)
    xyz = (pset.points - translation.astype(np.float32)) * np.float32(scale)
    return InputData(
        cameras=cameras,
        scale=scale,
        translation=translation,
        points_xyz=xyz.astype(np.float32),
        points_rgb=pset.colors_or_gray(),
    )
