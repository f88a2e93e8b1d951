"""Batch trainer: S independent scenes trained together.

    python -m opensplat_tpu_torch.multi_scene_cli projA projB ... -o out/
    python -m opensplat_tpu_torch.parallel.launch -n 2 -- \\
        python -m opensplat_tpu_torch.multi_scene_cli projA projB --sharded

Counterpart of opensplat_tpu/multi_scene_cli.py: many objects captured
with the same rig train at once. Per scene the training is the main
CLI's (the same sampler order, refine schedule with the per-scene
camera-count guard). --sharded deals the scenes over the ranks that
OPENSPLAT_COORDINATOR / OPENSPLAT_NUM_PROCESSES / OPENSPLAT_PROCESS_ID
name (parallel/distributed.py; without them, one rank): the largest
rank count that divides the scene count takes contiguous blocks of
scenes, each rank loads and trains only its own, and the rest idle.
Rank 0 writes every scene's PLY. It trains on CUDA unless given --cpu.
"""
from __future__ import annotations

import argparse
import os
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="opensplat-batch",
        description="Train multiple 3D Gaussian Splatting scenes together "
        "(PyTorch + CUDA port; scenes dealt over ranks with --sharded)",
    )
    p.add_argument("projects", nargs="+",
                   help="Project roots (colmap/nerfstudio/opensfm/odm/"
                   "openmvg); all scenes must share image dimensions")
    p.add_argument("-o", "--output-dir", default="batch_out",
                   help="Directory for per-scene output PLYs "
                   "(<project-basename>.ply)")
    p.add_argument("-n", "--num-iters", type=int, default=30000)
    p.add_argument("-d", "--downscale-factor", type=float, default=1.0)
    p.add_argument("--renderer", default="auto",
                   choices=["auto", "dense", "tiled", "pallas", "fast"])
    p.add_argument("--sh-degree", type=int, default=3)
    p.add_argument("--refine-every", type=int, default=100)
    p.add_argument("--warmup-length", type=int, default=500)
    p.add_argument("--capacity", type=int, default=None)
    p.add_argument("--sharded", action="store_true",
                   help="Deal the scenes over the ranks (one or more "
                   "scenes a rank); default trains them all in this "
                   "process")
    p.add_argument("--cpu", action="store_true",
                   help="Run on the CPU (the kernels' plain versions)")
    p.add_argument("--keep-crs", action="store_true")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    import torch.distributed as dist

    try:
        return _train(args)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _train(args) -> int:
    import torch.distributed as dist

    from .cli import pick_renderer
    from .config import TrainConfig
    from .data.dataset import input_data_from_x
    from .io.scene_io import save_scene
    from .models.gaussians import init_model
    from .parallel.distributed import initialize_from_env, rank_device
    from .parallel.mesh import make_mesh
    from .parallel.multi_scene import MultiSceneTrainer

    base_device = "cpu" if args.cpu else "cuda"
    mesh = None
    projects = list(args.projects)
    if args.sharded:
        initialize_from_env(device=base_device)
        world = dist.get_world_size() if dist.is_initialized() else 1
        n_data = world
        while n_data > 1 and len(projects) % n_data:
            n_data -= 1
        mesh = make_mesh(n_data, 1, ranks=range(n_data))
        print(f"Sharded: {len(projects)} scenes over {n_data} ranks")
        if not mesh.member:
            print(f"rank {dist.get_rank()}: no scenes; idle")
            return 0
        per = len(projects) // n_data
        mine = projects[mesh.index["data"] * per:][:per]
    else:
        mine = projects
    device = rank_device(base_device)
    cfg = TrainConfig(
        num_iters=args.num_iters,
        downscale_factor=args.downscale_factor,
        sh_degree=args.sh_degree,
        refine_every=args.refine_every,
        warmup_length=args.warmup_length,
        capacity=args.capacity,
        renderer=args.renderer,
    )

    states, cams = [], []
    for root in mine:
        data = input_data_from_x(root, "")
        for c in data.cameras:
            c.load_image(cfg.downscale_factor)
        cams.append(data.cameras)
        states.append(init_model(
            data.points_xyz, data.points_rgb, sh_degree=cfg.sh_degree,
            capacity=cfg.capacity, capacity_round=cfg.capacity_round,
            seed=cfg.seed, device=device))

    trainer = MultiSceneTrainer(states, cams, cfg,
                                renderer=pick_renderer(cfg.renderer),
                                mesh=mesh, device=device)
    display = 10 if device.type == "cuda" else 1
    refined = False
    for step in range(1, cfg.num_iters + 1):
        out = trainer.run_step(step)
        refined = refined or trainer.refine_metrics is not None
        trainer.refine_metrics = None
        if step % display == 0 or step == cfg.num_iters:
            per = ", ".join(f"{v:.4f}" for v in
                            out.metrics["loss_per_scene"].tolist())
            print(f"Step {step}: mean loss {out.loss:.6f} [{per}] "
                  f"({'refined' if refined else ''})", flush=True)
            refined = False

    scenes = trainer.scene_states()  # gathered from every rank
    if dist.is_initialized() and dist.get_rank() != 0:
        return 0
    os.makedirs(args.output_dir, exist_ok=True)
    used = set()
    for root, (scale, translation), st in zip(projects, _frames(projects),
                                              scenes):
        name = os.path.basename(os.path.normpath(root)) or "scene"
        uniq, k = name, 1
        while uniq in used:  # two projects may share a basename
            uniq, k = f"{name}_{k}", k + 1
        used.add(uniq)
        out_path = os.path.join(args.output_dir, f"{uniq}.ply")
        save_scene(st.params, st.alive, out_path, cfg.num_iters,
                   keep_crs=args.keep_crs, scale=scale,
                   translation=translation)
        print(f"Wrote {out_path}")
    return 0


def _frames(projects):
    """(scale, translation) of each project, as its loader computes them
    (what save_scene needs to write the scene in the input's frame)."""
    from .data.dataset import input_data_from_x

    out = []
    for root in projects:
        d = input_data_from_x(root, "")
        out.append((d.scale, d.translation))
    return out


if __name__ == "__main__":
    sys.exit(main())
