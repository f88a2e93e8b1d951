"""Generate a synthetic nerfstudio-format project for end-to-end runs.

Counterpart of tools/make_synthetic_project.py, `blobs` style: Gaussians
in eight clusters (the same numpy draws from the same seed), rendered to
ground-truth images by the port's render_image from cameras on a ring,
written as transforms.json + sparse.ply + images/*.png with the port's
own PNG writer, so neither JAX nor OpenCV is needed. The JAX tool
renders over black; here the ground truth is rendered over the training
background, so a PSNR measures the scene and not a background no
Gaussian covers. Usage:

    python -m opensplat_tpu_torch.tools.make_synthetic_project /tmp/scene \
        --cams 16 --points 1500 --res 256 [--cpu]

The GT renders on CUDA unless --cpu is given.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np


def look_at(eye, target=np.zeros(3), up=np.array([0.0, 1.0, 0.0])):
    f = target - eye
    f = f / np.linalg.norm(f)
    r = np.cross(f, up)
    r = r / np.linalg.norm(r)
    u = np.cross(r, f)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2] = r, u, -f  # OpenGL: -z forward
    c2w[:3, 3] = eye
    return c2w


def make_project(out: str, cams: int = 16, points: int = 1500,
                 res: int = 256, seed: int = 7, sparse_frac: float = 0.5,
                 jitter: float = 0.0, device="cuda", verbose: bool = True):
    """Write the project into `out`. sparse.ply holds the GT means kept
    with probability sparse_frac, each moved by N(0, jitter) noise when
    jitter > 0. Returns the number of sparse points."""
    import torch

    from .._device import resolve_device
    from ..data._image import write_png
    from ..data.point_io import PointSet, save_point_set
    from ..models.gaussians import GaussianParams
    from ..ops.sh import rgb_to_sh
    from ..train import render_image

    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    n = points
    h = w = res
    fx = fy = 1.1 * res

    # clustered blobs look more like a real object than uniform noise
    centers = rng.uniform(-0.8, 0.8, (8, 3))
    assign = rng.integers(0, len(centers), n)
    pts = (centers[assign] + rng.normal(0, 0.25, (n, 3))).astype(np.float32)
    cols = rng.integers(20, 235, (n, 3)).astype(np.uint8)

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.float32),
                               device=dev)

    params = GaussianParams(
        means=t(pts),
        scales=t(np.full((n, 3), np.log(0.06))),
        quats=t(np.tile([1.0, 0.0, 0.0, 0.0], (n, 1))),
        features_dc=t(rgb_to_sh(cols.astype(np.float32) / 255.0)),
        features_rest=t(np.zeros((n, 0, 3))),
        opacities=t(np.full((n, 1), 2.5)),
    )
    alive = torch.ones((n,), dtype=torch.bool, device=dev)

    os.makedirs(os.path.join(out, "images"), exist_ok=True)
    frames = []
    for i in range(cams):
        ang = 2 * np.pi * i / cams
        elev = 0.4 + 0.8 * ((i * 7919) % cams) / cams
        eye = np.array([4.0 * np.cos(ang), elev, 4.0 * np.sin(ang)],
                       np.float32)
        c2w = look_at(eye)
        rgb, _, _ = render_image(params, alive, t(c2w), fx, fy, w / 2.0,
                                 h / 2.0, h, w, 0, device=dev)
        img = (np.clip(rgb.cpu().numpy(), 0, 1) * 255).astype(np.uint8)
        fname = f"images/r_{i:03d}.png"
        write_png(os.path.join(out, fname), img)
        frames.append({"file_path": fname, "transform_matrix": c2w.tolist()})
        if verbose:
            print(f"rendered {fname}")

    keep = rng.random(n) < sparse_frac
    sparse = pts[keep]
    if jitter > 0:
        sparse = (sparse + rng.normal(0, jitter, sparse.shape)).astype(
            np.float32)
    save_point_set(PointSet(points=sparse, colors=cols[keep]),
                   os.path.join(out, "sparse.ply"))
    with open(os.path.join(out, "transforms.json"), "w") as f:
        json.dump(
            {
                "camera_model": "OPENCV",
                "w": w, "h": h, "fl_x": fx, "fl_y": fy,
                "cx": w / 2.0, "cy": h / 2.0,
                "ply_file_path": "sparse.ply",
                "frames": frames,
            },
            f,
        )
    if verbose:
        print(f"wrote {out} ({cams} cams, {int(keep.sum())} sparse pts)")
    return int(keep.sum())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Write a synthetic nerfstudio project (blobs style)")
    ap.add_argument("out")
    ap.add_argument("--cams", type=int, default=16)
    ap.add_argument("--points", type=int, default=1500)
    ap.add_argument("--res", type=int, default=256)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--sparse-frac", type=float, default=0.5,
                    help="fraction of true points revealed in sparse.ply "
                    "(forces densification to recover the rest)")
    ap.add_argument("--cpu", action="store_true",
                    help="render the GT on the CPU (plain versions)")
    args = ap.parse_args(argv)
    make_project(args.out, args.cams, args.points, args.res, args.seed,
                 args.sparse_frac,
                 device="cpu" if args.cpu else "cuda")
    return 0


if __name__ == "__main__":
    sys.exit(main())
