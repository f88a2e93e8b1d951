"""OpenMVG sfm_data.json loader.

The port's copy of opensplat_tpu/data/openmvg.py, on the port's tensor_math.

Behavioral spec: reference openmvg.cpp:15-349.
  - Intrinsics under value.ptr_wrapper.data: width/height, focal_length
    (fx=fy), principal_point, and whichever "dis*" key is present mapped to
    k1,k2,k3,t1,t2 (openmvg.cpp:46-90). Supported projection types:
    pinhole, pinhole_brown_t2 (openmvg.cpp:319-321).
  - Views under value.ptr_wrapper.data: filename, id_view, id_intrinsic,
    id_pose (openmvg.cpp:128-147).
  - Extrinsics: rotation stored column-major -> transposed to rows;
    pose = [R | -R^T @ center], OpenCV->OpenGL flip of cols 1:3
    (openmvg.cpp:184-304 — including the reference's exact Tinv choice).
  - Intrinsics normalized like OpenSfM: fx*norm, w/2 + norm*cx
    (openmvg.cpp:328-332). Points from colorized.ply (openmvg.cpp:339).
"""
from __future__ import annotations

import json
import os

import numpy as np

from ..ops.tensor_math import auto_scale_and_center_poses
from .dataset import Camera, InputData
from .point_io import read_point_set


def load_openmvg(project_root: str) -> InputData:
    reconstruction_path = os.path.join(project_root, "sfm_data.json")
    color_cloud_path = os.path.join(project_root, "colorized.ply")
    has_bin = os.path.exists(os.path.join(project_root, "sfm_data.bin"))
    if has_bin and not os.path.exists(reconstruction_path):
        raise RuntimeError(
            "No json found, please use openMVG_main_ConvertSfM_DataFormat "
            "with the bin to create the json file"
        )
    if not os.path.exists(reconstruction_path):
        raise RuntimeError(
            "No project files found, please check the file path for "
            "sfm_data.json or sfm_data.bin"
        )
    if not os.path.exists(color_cloud_path):
        if os.path.exists(os.path.join(project_root, "cloud_and_poses.ply")):
            raise RuntimeError(
                "No colorized.ply found, cloud_and_poses found, please run "
                "openMVG_main_ComputeSfM_DataColor and name the output "
                "colorized.ply"
            )
        raise RuntimeError(
            "No project files found, please check the file path for "
            "sfm_data.json or sfm_data.bin"
        )

    with open(reconstruction_path) as f:
        data = json.load(f)
    image_root_path = data["root_path"]

    intrinsics = {}
    for item in data["intrinsics"]:
        d = item["value"]["ptr_wrapper"]["data"]
        disto = [0.0] * 5
        for key in d:
            if "dis" in key:
                vals = d[key]
                disto[: len(vals)] = [float(v) for v in vals[:5]]
                break
        intrinsics[int(item["key"])] = {
            "projection_type": item["value"]["polymorphic_name"],
            "width": int(d["width"]),
            "height": int(d["height"]),
            "f": float(d["focal_length"]),
            "cx": float(d["principal_point"][0]),
            "cy": float(d["principal_point"][1]),
            "k1": disto[0], "k2": disto[1], "k3": disto[2],
            "t1": disto[3], "t2": disto[4],
        }

    views = {}
    for item in data["views"]:
        d = item["value"]["ptr_wrapper"]["data"]
        views[int(d["id_view"])] = {
            "filename": d["filename"],
            "id_intrinsic": int(d["id_intrinsic"]),
            "id_pose": int(d["id_pose"]),
        }

    pose_items = []
    for item in data["extrinsics"]:
        v = item["value"]
        # column-major storage -> row-major R (openmvg.cpp:180-213)
        R = np.array(v["rotation"], np.float32).T
        center = np.array(v["center"], np.float32)
        pose_items.append((int(item["key"]), R, center))

    poses = np.zeros((len(pose_items), 4, 4), np.float32)
    pose_indexes = {}
    for i, (pose_id, R, center) in enumerate(pose_items):
        Tinv = -(R.T @ center)  # the reference's exact construction (:291-298)
        pose_indexes[pose_id] = i
        poses[i, :3, :3] = R
        poses[i, :3, 3] = Tinv
        poses[i, 3, 3] = 1.0
        poses[i, 0:3, 1:3] *= -1.0  # OpenCV -> OpenGL (openmvg.cpp:302)

    poses, translation, scale = auto_scale_and_center_poses(poses)

    cameras = []
    for view_id in views:
        v = views[view_id]
        intr = intrinsics[v["id_intrinsic"]]
        if intr["projection_type"] not in ("pinhole", "pinhole_brown_t2"):
            raise RuntimeError(
                f"Camera projection type {intr['projection_type']} is not supported"
            )
        normalizer = float(max(intr["width"], intr["height"]))
        cameras.append(
            Camera(
                width=intr["width"],
                height=intr["height"],
                fx=intr["f"] * normalizer,
                fy=intr["f"] * normalizer,
                cx=intr["width"] / 2.0 + normalizer * intr["cx"],
                cy=intr["height"] / 2.0 + normalizer * intr["cy"],
                k1=intr["k1"], k2=intr["k2"], k3=intr["k3"],
                p1=intr["t1"], p2=intr["t2"],
                cam_to_world=poses[pose_indexes[v["id_pose"]]],
                file_path=os.path.join(image_root_path, v["filename"]),
            )
        )

    pset = read_point_set(color_cloud_path)
    xyz = (pset.points - translation.astype(np.float32)) * np.float32(scale)
    return InputData(
        cameras=cameras,
        scale=scale,
        translation=translation,
        points_xyz=xyz.astype(np.float32),
        points_rgb=pset.colors_or_gray(),
    )
