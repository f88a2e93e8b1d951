"""Synthetic smoke-test trainer (reference simple_trainer.cpp:24-212).

Counterpart of opensplat_tpu/simple_trainer.py: fits N random Gaussians
to the red/blue-quadrant test image with MSE and one torch.optim.Adam
over the raw parameters (its optax.adam), rendering through --renderer:
fast (the port's kernels, rasterize_fast; the JAX tool's pallas; the
default, where the JAX tool's is tiled), tiled or dense. It runs on CUDA
unless given --cpu.

    python -m opensplat_tpu_torch.simple_trainer --iters 60 --points 2000
"""
from __future__ import annotations

import argparse
import math
import os
import sys
import time


def make_gt_image(height: int, width: int):
    """White canvas, top-left red, bottom-right blue
    (simple_trainer.cpp:77-82)."""
    import numpy as np

    gt = np.ones((height, width, 3), np.float32)
    gt[: height // 2, : width // 2] = (1.0, 0.0, 0.0)
    gt[height // 2:, width // 2:] = (0.0, 0.0, 1.0)
    return gt


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="simple_trainer", description="Test program for gsplat execution"
    )
    p.add_argument("--cpu", action="store_true", help="Force CPU execution")
    p.add_argument("--width", type=int, default=256)
    p.add_argument("--height", type=int, default=256)
    p.add_argument("--iters", type=int, default=1000)
    p.add_argument("--points", type=int, default=100000)
    p.add_argument("--lr", type=float, default=0.01)
    p.add_argument("--render", default="", help="Save rendered images to folder")
    p.add_argument("--renderer", default="fast",
                   choices=["dense", "tiled", "fast"])
    p.add_argument("--display-every", type=int, default=10)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from ._device import resolve_device
    from .data._image import write_png
    from .ops.kernels.integration import rasterize_fast
    from .ops.projection import project_gaussians
    from .ops.rasterize import rasterize
    from .ops.rasterize_tiled import rasterize_tiled

    dev = resolve_device("cpu" if args.cpu else "cuda")
    print("Using " + (torch.cuda.get_device_name(dev)
                      if dev.type == "cuda" else "CPU"))
    h, w = args.height, args.width
    if args.render:
        os.makedirs(args.render, exist_ok=True)

    gt = torch.as_tensor(make_gt_image(h, w), device=dev)
    fov_x = math.pi / 2.0
    focal = 0.5 * w / math.tan(0.5 * fov_x)

    g = torch.Generator(device=dev).manual_seed(args.seed)
    n = args.points

    def rand(*shape):
        return torch.rand(shape, generator=g, device=dev)

    u, v, wq = rand(n, 1), rand(n, 1), rand(n, 1)
    two_pi = 2.0 * math.pi
    params = {
        "means": 2.0 * (rand(n, 3) - 0.5),
        "scales": rand(n, 3),
        "rgbs": rand(n, 3),
        "opacities": torch.ones((n, 1), device=dev),
        "quats": torch.cat([
            torch.sqrt(1.0 - u) * torch.sin(two_pi * v),
            torch.sqrt(1.0 - u) * torch.cos(two_pi * v),
            torch.sqrt(u) * torch.sin(two_pi * wq),
            torch.sqrt(u) * torch.cos(two_pi * wq),
        ], dim=-1),
    }
    for t in params.values():
        t.requires_grad_(True)

    # camera 8 units along +z, looking down +z (simple_trainer.cpp:130-135);
    # the reference passes viewMat as the projection matrix too.
    viewmat = torch.eye(4, device=dev)
    viewmat[2, 3] = 8.0
    background = torch.zeros(3, device=dev)
    optimizer = torch.optim.Adam(params.values(), lr=args.lr,
                                 betas=(0.9, 0.999), eps=1e-8)

    def render():
        pg = project_gaussians(
            params["means"], params["scales"], 1.0, params["quats"],
            viewmat, viewmat, focal, focal, w / 2.0, h / 2.0, h, w,
        )
        colors = torch.sigmoid(params["rgbs"])
        opac = torch.sigmoid(params["opacities"]).reshape(-1)
        if args.renderer == "dense":
            img, _ = rasterize(pg.xys, pg.conics, colors, opac, pg.depths,
                               pg.mask, background, h, w)
        elif args.renderer == "tiled":
            img, _ = rasterize_tiled(
                pg.xys, pg.conics, colors, opac, pg.depths, pg.radii,
                pg.num_tiles_hit, pg.tile_min, pg.tile_max, background, h,
                w)
        else:
            img, _ = rasterize_fast(
                pg.xys, pg.conics, colors, opac, pg.depths, pg.radii,
                pg.num_tiles_hit, pg.tile_min, pg.tile_max, background, h,
                w, device=dev)
        return img

    t0 = time.perf_counter()
    for i in range(args.iters):
        optimizer.zero_grad()
        img = render()
        loss = torch.mean((img - gt) ** 2)
        loss.backward()
        optimizer.step()
        loss = loss.detach()
        if (i + 1) % args.display_every == 0 or i == 0:
            print(f"Iteration {i + 1}/{args.iters} Loss: {float(loss):.6f}")
        if args.render:
            arr = (np.clip(img.detach().cpu().numpy(), 0, 1) * 255).astype(
                np.uint8)
            write_png(os.path.join(args.render, f"{i + 1}.png"), arr)
    dt = time.perf_counter() - t0
    print(f"Final loss: {float(loss):.6f} ({args.iters / dt:.2f} iters/s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
