"""OpenSfM reconstruction.json loader.

The port's copy of opensplat_tpu/data/opensfm.py, on the port's tensor_math.

Behavioral spec: reference opensfm.cpp:53-151.
  - reconstruction.json is a list; first reconstruction used, warning on
    more (opensfm.cpp:77-80).
  - image_list.txt maps basenames to image paths (opensfm.cpp:66-74).
  - Shot pose: Rodrigues rotation + translation form w2c; c2w = inv(w2c);
    OpenCV->OpenGL flip of columns 1:3 (opensfm.cpp:87-101).
  - Intrinsics are normalized by max(w, h): fx = focal * norm,
    cx = w/2 + norm * c_x (opensfm.cpp:118-121). "focal" sets both fx,fy.
  - Only perspective/brown projections supported (opensfm.cpp:114-116).
"""
from __future__ import annotations

import json
import os
import sys

import numpy as np

from ..ops.tensor_math import auto_scale_and_center_poses, rodrigues_to_rotation
from .dataset import Camera, InputData


def load_opensfm(project_root: str) -> InputData:
    reconstruction_path = os.path.join(project_root, "reconstruction.json")
    image_list_path = os.path.join(project_root, "image_list.txt")
    if not os.path.exists(reconstruction_path):
        raise RuntimeError(f"{reconstruction_path} does not exist")
    if not os.path.exists(image_list_path):
        raise RuntimeError(f"{image_list_path} does not exist")

    with open(reconstruction_path) as f:
        reconstructions = json.load(f)

    images = {}
    with open(image_list_path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            if os.path.isabs(line):
                images[os.path.basename(line)] = line
            else:
                images[os.path.basename(line)] = os.path.abspath(
                    os.path.join(project_root, line)
                )

    if len(reconstructions) == 0:
        raise RuntimeError("No reconstructions found")
    if len(reconstructions) > 1:
        print(
            "Warning: multiple OpenSfM reconstructions found, choosing the first",
            file=sys.stderr,
        )
    rec = reconstructions[0]
    shots = rec["shots"]
    cams = rec["cameras"]
    points = rec.get("points", {})

    shot_items = list(shots.items())
    poses = np.zeros((len(shot_items), 4, 4), np.float32)
    for i, (_, shot) in enumerate(shot_items):
        R = rodrigues_to_rotation(np.array(shot["rotation"], np.float32))
        t = np.array(shot["translation"], np.float32)
        w2c = np.eye(4, dtype=np.float32)
        w2c[:3, :3] = R
        w2c[:3, 3] = t
        poses[i] = np.linalg.inv(w2c)
        poses[i, 0:3, 1:3] *= -1.0  # OpenCV -> OpenGL (opensfm.cpp:99)

    poses, translation, scale = auto_scale_and_center_poses(poses)

    cameras = []
    for i, (filename, shot) in enumerate(shot_items):
        c = cams[shot["camera"]]
        ptype = c.get("projection_type", "perspective")
        if ptype not in ("perspective", "brown"):
            raise RuntimeError(f"Camera projection type {ptype} is not supported")
        width, height = int(c.get("width", 0)), int(c.get("height", 0))
        fx = fy = float(c.get("focal", 0.0))
        fx = float(c.get("focal_x", fx))
        fy = float(c.get("focal_y", fy))
        normalizer = float(max(width, height))
        cameras.append(
            Camera(
                width=width,
                height=height,
                fx=fx * normalizer,
                fy=fy * normalizer,
                cx=width / 2.0 + normalizer * float(c.get("c_x", 0.0)),
                cy=height / 2.0 + normalizer * float(c.get("c_y", 0.0)),
                k1=float(c.get("k1", 0.0)),
                k2=float(c.get("k2", 0.0)),
                k3=float(c.get("k3", 0.0)),
                p1=float(c.get("p1", 0.0)),
                p2=float(c.get("p2", 0.0)),
                cam_to_world=poses[i],
                file_path=images.get(filename, filename),
            )
        )

    n = len(points)
    xyz = np.zeros((n, 3), np.float32)
    rgb = np.zeros((n, 3), np.uint8)
    for i, (_, p) in enumerate(points.items()):
        xyz[i] = p["coordinates"]
        rgb[i] = np.clip(p["color"], 0, 255)

    xyz = (xyz - translation.astype(np.float32)) * np.float32(scale)
    return InputData(
        cameras=cameras,
        scale=scale,
        translation=translation,
        points_xyz=xyz,
        points_rgb=rgb,
    )
