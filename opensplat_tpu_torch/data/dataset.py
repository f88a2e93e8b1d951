"""Camera model + project loading dispatch.

Counterpart of opensplat_tpu/data/dataset.py (input_data.{hpp,cpp}): a
Camera carries intrinsics, distortion and a camera-to-world pose;
load_image rescales intrinsics to the image, undistorts
(getOptimalNewCameraMatrix + ROI crop, input_data.cpp:71-96) and caches
an INTER_AREA pyramid (input_data.cpp:99-117). Loader dispatch by
sentinel file matches input_data.cpp:15-32. PNG decoding and the area
resize are the port's own (data/_image.py); JPEG and other formats and
undistortion go through cv2, imported only where they are needed.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Optional

import numpy as np

from . import _image


@dataclasses.dataclass
class Camera:
    width: int
    height: int
    fx: float
    fy: float
    cx: float
    cy: float
    k1: float = 0.0
    k2: float = 0.0
    k3: float = 0.0
    p1: float = 0.0
    p2: float = 0.0
    cam_to_world: Optional[np.ndarray] = None  # (4, 4) float32
    file_path: str = ""
    cam_id: int = 0
    image: Optional[np.ndarray] = None  # (H, W, 3) float32 [0, 1]
    _pyramids: Dict[int, np.ndarray] = dataclasses.field(default_factory=dict)

    def has_distortion(self) -> bool:
        return any(v != 0.0 for v in (self.k1, self.k2, self.k3, self.p1, self.p2))

    def undistortion_parameters(self) -> np.ndarray:
        # OpenCV ordering (input_data.cpp:123-126)
        return np.array(
            [self.k1, self.k2, self.p1, self.p2, self.k3, 0.0, 0.0, 0.0], np.float64
        )

    def intrinsics_matrix(self) -> np.ndarray:
        return np.array(
            [[self.fx, 0, self.cx], [0, self.fy, self.cy], [0, 0, 1]], np.float64
        )

    def load_image(self, downscale_factor: float = 1.0):
        """Read, rescale intrinsics, undistort, ROI-crop (input_data.cpp:40-97).

        Destructive: call once."""
        if self.image is not None:
            raise RuntimeError("load_image already called")
        img = _image.imread_rgb(self.file_path)

        if img.shape[0] != self.height or img.shape[1] != self.width:
            rescale = img.shape[0] / float(self.height)
            self.fx *= rescale
            self.fy *= rescale
            self.cx *= rescale
            self.cy *= rescale

        if downscale_factor > 1.0:
            s = 1.0 / downscale_factor
            img = _image.resize_area(img, factor=s)
            self.fx *= s
            self.fy *= s
            self.cx *= s
            self.cy *= s

        K = self.intrinsics_matrix()
        if self.has_distortion():
            img, K = _image.undistort(img, K, self.undistortion_parameters(),
                                      self.file_path)

        self.image = (img.astype(np.float32)) / 255.0
        self.height, self.width = self.image.shape[:2]
        self.fx = float(K[0][0])
        self.fy = float(K[1][1])
        self.cx = float(K[0][2])
        self.cy = float(K[1][2])

    def set_image(self, image: np.ndarray):
        """Directly attach an image (tests / synthetic data)."""
        self.image = image.astype(np.float32)
        self.height, self.width = image.shape[:2]

    def get_image(self, downscale_factor: int = 1) -> np.ndarray:
        if downscale_factor <= 1:
            return self.image
        if downscale_factor in self._pyramids:
            return self._pyramids[downscale_factor]
        h = self.image.shape[0] // downscale_factor
        w = self.image.shape[1] // downscale_factor
        scaled = _image.resize_area(self.image, (w, h))
        self._pyramids[downscale_factor] = scaled
        return scaled


@dataclasses.dataclass
class InputData:
    cameras: List[Camera]
    scale: float
    translation: np.ndarray  # (3,)
    points_xyz: np.ndarray  # (N, 3) float32, normalized CRS
    points_rgb: np.ndarray  # (N, 3) uint8

    def get_cameras(self, validate: bool, val_image: str = "random"):
        """Withhold a validation camera (input_data.cpp:128-156)."""
        if not validate:
            return self.cameras, None
        rng = np.random.RandomState(42)
        if val_image == "random":
            val_idx = int(rng.randint(0, len(self.cameras)))
        else:
            val_idx = -1
            for i, cam in enumerate(self.cameras):
                if os.path.basename(cam.file_path) == val_image:
                    val_idx = i
                    break
            if val_idx == -1:
                raise RuntimeError(f"{val_image} not in the list of cameras")
        cams = [c for i, c in enumerate(self.cameras) if i != val_idx]
        return cams, self.cameras[val_idx]

    def save_cameras(self, filename: str, keep_crs: bool):
        """Viewer-compatible cameras.json (input_data.cpp:159-200)."""
        out = []
        for i, cam in enumerate(self.cameras):
            R = cam.cam_to_world[:3, :3] @ np.diag([1.0, -1.0, -1.0])
            T = cam.cam_to_world[:3, 3].copy()
            if keep_crs:
                T = T / self.scale + self.translation
            out.append(
                {
                    "id": i,
                    "img_name": os.path.basename(cam.file_path),
                    "width": cam.width,
                    "height": cam.height,
                    "fx": cam.fx,
                    "fy": cam.fy,
                    "position": [float(v) for v in T],
                    "rotation": [[float(v) for v in row] for row in R],
                }
            )
        with open(filename, "w") as f:
            json.dump(out, f)


def input_data_from_x(project_root: str, colmap_image_path: str = "") -> InputData:
    """Loader dispatch by sentinel file (input_data.cpp:15-32)."""
    root = project_root
    if os.path.exists(os.path.join(root, "transforms.json")):
        from .nerfstudio import load_nerfstudio

        return load_nerfstudio(root)
    if os.path.exists(os.path.join(root, "sparse")) or os.path.exists(
        os.path.join(root, "cameras.bin")
    ):
        from .colmap import load_colmap

        return load_colmap(root, colmap_image_path)
    if os.path.exists(os.path.join(root, "reconstruction.json")):
        from .opensfm import load_opensfm

        return load_opensfm(root)
    if os.path.exists(os.path.join(root, "opensfm", "reconstruction.json")):
        from .opensfm import load_opensfm

        return load_opensfm(os.path.join(root, "opensfm"))
    if os.path.exists(os.path.join(root, "sfm_data.json")):
        from .openmvg import load_openmvg

        return load_openmvg(root)
    raise RuntimeError(
        "Invalid project folder (must be either a colmap or nerfstudio or "
        "openmvg project folder)"
    )
