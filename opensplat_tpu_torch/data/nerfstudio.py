"""nerfstudio transforms.json loader.

The port's copy of opensplat_tpu/data/nerfstudio.py, on the port's tensor_math.

Behavioral spec: reference nerfstudio.cpp:34-167.
  - Per-frame intrinsics with global backfill for any field the frame
    leaves unset (nerfstudio.cpp:88-101; a frame value of 0 counts as
    unset, matching the `!f.fx && fx` semantics).
  - Frames sorted by file_path (nerfstudio.cpp:103-106).
  - ply_file_path required (nerfstudio.cpp:135); points from that PLY.
  - Poses taken verbatim from transform_matrix (already OpenGL c2w),
    then auto-scaled/centered (nerfstudio.cpp:138-143).
"""
from __future__ import annotations

import json
import os

import numpy as np

from ..ops.tensor_math import auto_scale_and_center_poses
from .dataset import Camera, InputData
from .point_io import read_point_set

_INTRINSIC_KEYS = {
    "w": "width", "h": "height",
    "fl_x": "fx", "fl_y": "fy", "cx": "cx", "cy": "cy",
    "k1": "k1", "k2": "k2", "k3": "k3", "p1": "p1", "p2": "p2",
}


def load_nerfstudio(project_root: str) -> InputData:
    transforms_path = os.path.join(project_root, "transforms.json")
    if not os.path.exists(transforms_path):
        raise RuntimeError(f"{transforms_path} does not exist")
    with open(transforms_path) as f:
        data = json.load(f)

    globals_ = {dst: data.get(src, 0) for src, dst in _INTRINSIC_KEYS.items()}
    frames = []
    for fr in data.get("frames", []):
        vals = {dst: fr.get(src, 0) for src, dst in _INTRINSIC_KEYS.items()}
        for k, gv in globals_.items():
            if not vals[k] and gv:
                vals[k] = gv
        frames.append(
            {
                "file_path": fr["file_path"],
                "transform_matrix": np.array(fr["transform_matrix"], np.float32),
                **vals,
            }
        )
    frames.sort(key=lambda fr: fr["file_path"])

    ply_file_path = data.get("ply_file_path", "")
    if not ply_file_path:
        raise RuntimeError("ply_file_path is empty")
    pset = read_point_set(os.path.join(project_root, ply_file_path))

    poses = np.stack([fr["transform_matrix"] for fr in frames]) if frames else (
        np.zeros((0, 4, 4), np.float32)
    )
    poses, translation, scale = auto_scale_and_center_poses(poses)

    cameras = []
    for i, fr in enumerate(frames):
        cameras.append(
            Camera(
                width=int(fr["width"]),
                height=int(fr["height"]),
                fx=float(fr["fx"]),
                fy=float(fr["fy"]),
                cx=float(fr["cx"]),
                cy=float(fr["cy"]),
                k1=float(fr["k1"]),
                k2=float(fr["k2"]),
                k3=float(fr["k3"]),
                p1=float(fr["p1"]),
                p2=float(fr["p2"]),
                cam_to_world=poses[i],
                file_path=os.path.join(project_root, fr["file_path"]),
            )
        )

    xyz = (pset.points - translation.astype(np.float32)) * np.float32(scale)
    return InputData(
        cameras=cameras,
        scale=scale,
        translation=translation,
        points_xyz=xyz.astype(np.float32),
        points_rgb=pset.colors_or_gray(),
    )
