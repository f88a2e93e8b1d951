"""Generate a synthetic nerfstudio-format project for end-to-end runs.

Counterpart of tools/make_synthetic_project.py, with its two styles (the
same numpy draws from the same seed): `blobs`, Gaussians in eight
clusters rendered by the fast renderer, and `textured`, a ground patch,
five ellipsoid surfaces and a torus with procedural texture and
anisotropic surfels, rendered by the tiled renderer (as in the JAX
tool, so large point counts and resolutions work). Ground-truth images
come from cameras on a ring and are written as transforms.json +
sparse.ply + images/*.png with the port's own PNG writer, so neither JAX
nor OpenCV is needed. The JAX tool renders over black; here the ground
truth is rendered over the training background, so a PSNR measures the
scene and not a background no Gaussian covers. Usage:

    python -m opensplat_tpu_torch.tools.make_synthetic_project /tmp/scene \
        --cams 16 --points 1500 --res 256 [--style textured] [--cpu]

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


def blobs_scene(rng, n: int):
    """Clustered blobs, which look more like a real object than uniform
    noise: (means, uint8 colours, log scales, quats, opacity logits)."""
    centers = rng.uniform(-0.8, 0.8, (8, 3))
    assign = rng.integers(0, len(centers), n)
    pts = (centers[assign] + rng.normal(0, 0.25, (n, 3))).astype(np.float32)
    cols = rng.integers(20, 235, (n, 3)).astype(np.uint8)
    return (pts, cols, np.full((n, 3), np.log(0.06), np.float32),
            np.tile(np.float32([1.0, 0.0, 0.0, 0.0]), (n, 1)),
            np.full((n, 1), 2.5, np.float32))


def textured_scene(rng, n: int):
    """The JAX tool's textured quality proxy: a ground patch, five
    ellipsoid SURFACES (silhouettes and occlusion) and a torus, each a
    palette colour modulated by high-frequency positional texture, as
    anisotropic randomly oriented surfels sized to the local density,
    near-solid (opacity ~0.97). Same return as blobs_scene."""
    from scipy.spatial import cKDTree

    parts = []
    n_ground = n // 4
    gx = rng.uniform(-1.6, 1.6, (n_ground, 1))
    gz = rng.uniform(-1.6, 1.6, (n_ground, 1))
    gy = (-0.75 + 0.08 * np.sin(3.0 * gx) * np.cos(2.5 * gz)
          + rng.normal(0, 0.01, (n_ground, 1)))
    parts.append(np.concatenate([gx, gy, gz], axis=1))
    n_obj = n - n_ground
    n_each = n_obj // 6
    obj_centers = np.array(
        [[-0.7, -0.3, -0.5], [0.6, -0.25, -0.6], [0.0, -0.2, 0.55],
         [-0.55, 0.15, 0.5], [0.65, 0.25, 0.35], [0.0, 0.45, -0.3]])
    obj_radii = np.array(
        [[0.35, 0.4, 0.3], [0.3, 0.28, 0.42], [0.45, 0.2, 0.3],
         [0.25, 0.33, 0.25], [0.2, 0.2, 0.2], [0.3, 0.12, 0.3]])
    for k in range(6):
        m = n_each if k < 5 else n_obj - 5 * n_each
        if k == 5:  # torus
            u = rng.uniform(0, 2 * np.pi, m)
            v = rng.uniform(0, 2 * np.pi, m)
            r_maj, r_min = 0.28, 0.09
            p = np.stack([(r_maj + r_min * np.cos(v)) * np.cos(u),
                          r_min * np.sin(v),
                          (r_maj + r_min * np.cos(v)) * np.sin(u)], axis=1)
            p = p + obj_centers[k]
        else:  # ellipsoid surface
            d = rng.normal(size=(m, 3))
            d /= np.linalg.norm(d, axis=1, keepdims=True)
            p = obj_centers[k] + d * obj_radii[k] * (
                1.0 + rng.normal(0, 0.02, (m, 1)))
        parts.append(p)
    pts = np.concatenate(parts).astype(np.float32)

    palette = np.array(
        [[205, 180, 140], [190, 60, 50], [60, 150, 200], [240, 200, 60],
         [90, 180, 90], [170, 90, 190], [230, 130, 40]], np.float64)
    seg = np.concatenate(
        [np.zeros(n_ground, np.int64)]
        + [np.full(len(parts[1 + k]), 1 + k, np.int64) for k in range(6)])
    tex = (0.5 * np.sin(14.0 * pts[:, 0:1] + 9.0 * pts[:, 2:3])
           + 0.3 * np.cos(23.0 * pts[:, 1:2] + 7.0 * pts[:, 0:1])
           + 0.2 * np.sin(31.0 * pts[:, 2:3]))
    cols = np.clip(palette[seg] * (0.75 + 0.25 * tex)
                   + rng.normal(0, 6.0, (n, 3)), 5, 250).astype(np.uint8)

    dist, _ = cKDTree(pts).query(pts, k=4)
    s_iso = np.maximum(dist[:, 1:].mean(axis=1), 1e-4)
    s = np.stack([s_iso * rng.uniform(0.7, 1.4, n),
                  s_iso * rng.uniform(0.7, 1.4, n),
                  s_iso * rng.uniform(0.25, 0.6, n)],  # flattened: surfels
                 axis=1).astype(np.float32)
    q = rng.normal(size=(n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return pts, cols, np.log(s), q, np.full((n, 1), 3.5, np.float32)


STYLES = {"blobs": (blobs_scene, "fast"), "textured": (textured_scene,
                                                       "tiled")}


def make_project(out: str, cams: int = 16, points: int = 1500,
                 res: int = 256, seed: int = 7, sparse_frac: float = 0.5,
                 jitter: float = 0.0, device="cuda", verbose: bool = True,
                 style: str = "blobs"):
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

    scene, renderer = STYLES[style]
    pts, cols, log_scales, quats, opac_logits = scene(rng, n)

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.float32),
                               device=dev)

    params = GaussianParams(
        means=t(pts),
        scales=t(log_scales),
        quats=t(quats),
        features_dc=t(rgb_to_sh(cols.astype(np.float32) / 255.0)),
        features_rest=t(np.zeros((n, 0, 3))),
        opacities=t(opac_logits),
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
                                 h / 2.0, h, w, 0, renderer, device=dev)
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
        description="Write a synthetic nerfstudio project")
    ap.add_argument("out")
    ap.add_argument("--cams", type=int, default=16)
    ap.add_argument("--points", type=int, default=1500)
    ap.add_argument("--res", type=int, default=256)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--sparse-frac", type=float, default=0.5,
                    help="fraction of true points revealed in sparse.ply "
                    "(forces densification to recover the rest)")
    ap.add_argument("--style", choices=sorted(STYLES), default="blobs",
                    help="textured = multi-object procedural-texture scene "
                    "(quality-proxy runs); its GT renders through the tiled "
                    "renderer")
    ap.add_argument("--cpu", action="store_true",
                    help="render the GT on the CPU (plain versions)")
    args = ap.parse_args(argv)
    make_project(args.out, args.cams, args.points, args.res, args.seed,
                 args.sparse_frac, device="cpu" if args.cpu else "cuda",
                 style=args.style)
    return 0


if __name__ == "__main__":
    sys.exit(main())
