"""Real-scene parity harness: train on any SfM project (COLMAP /
nerfstudio / OpenSfM / OpenMVG) and write the BASELINE.md quality and
throughput table (validation PSNR against steps, steps/s, Gaussians)
with an oracle cross-check of the saved scene (the saved .ply rendered
through the numpy port of the reference's gsplat-cpu backend).

Counterpart of tools/parity_report.py on the port, with the same flags,
outputs and layout:

    python -m opensplat_tpu_torch.tools.parity_report /data/banana \\
        -n 2000 --out report [--renderer auto|dense|tiled|pallas|fast]

Writes <out>.json (machine-readable) and <out>.md (the table). It runs
on CUDA unless given --cpu; `backend` in the report is the device type.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("input", help="Project root (any supported SfM format)")
    ap.add_argument("-n", "--num-iters", type=int, default=2000)
    ap.add_argument("--out", default="parity_report",
                    help="Output stem for .json/.md")
    ap.add_argument("--renderer", default="auto",
                    choices=["auto", "dense", "tiled", "pallas", "fast"])
    ap.add_argument("--val-every", type=int, default=0,
                    help="Validation PSNR cadence (default: 10 points)")
    ap.add_argument("--downscale-factor", type=float, default=1.0)
    ap.add_argument("--no-oracle", action="store_true",
                    help="Skip the saved-scene oracle cross-check")
    ap.add_argument("--cpu", action="store_true",
                    help="Force CPU execution (opensplat.cpp:28 parity)")
    ap.add_argument("--eval-scene", default=None, metavar="PLY",
                    help="Skip training: evaluate an EXISTING scene .ply "
                    "against the project (val-camera PSNR + oracle "
                    "cross-check) — for scenes trained by the CLI")
    args = ap.parse_args(argv)

    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from .._device import resolve_device
    from ..cli import pick_renderer
    from ..config import TrainConfig
    from ..data.dataset import input_data_from_x
    from ..io import load_ply, save_scene
    from ..models.gaussians import init_model
    from ..models.splat_model import DEFAULT_BACKGROUND
    from ..oracle.scene_check import oracle_render_scene, psnr
    from ..train import Trainer, get_downscale_factor, sh_degrees_for_step

    device = resolve_device("cpu" if args.cpu else "cuda")
    cfg = TrainConfig(input=args.input, num_iters=args.num_iters,
                      downscale_factor=max(args.downscale_factor, 1.0))
    val_every = args.val_every or max(args.num_iters // 10, 1)

    data = input_data_from_x(args.input)
    with ThreadPoolExecutor() as ex:
        list(ex.map(lambda c: c.load_image(cfg.downscale_factor),
                    data.cameras))
    cams, val_cam = data.get_cameras(True, "random")

    if args.eval_scene:
        state, loaded_step = load_ply(
            args.eval_scene, keep_crs=False, scale=data.scale,
            translation=data.translation, device=device,
        )
        if loaded_step:
            args.num_iters = int(loaded_step)
    else:
        state = init_model(data.points_xyz, data.points_rgb,
                           sh_degree=cfg.sh_degree, seed=cfg.seed,
                           device=device)
    renderer = pick_renderer(args.renderer)
    trainer = Trainer(state, cams, cfg, renderer=renderer, device=device)

    def val_psnr(step: int) -> float:
        rgb = trainer.render(val_cam, step).cpu().numpy()
        gt = np.asarray(val_cam.get_image(get_downscale_factor(step, cfg)),
                        np.float32)
        return psnr(rgb, gt)

    rows = []  # (step, val PSNR, steps/s, n_gaussians)
    if args.eval_scene:
        rows.append(dict(step=args.num_iters,
                         val_psnr=round(val_psnr(args.num_iters), 3),
                         steps_per_sec=0.0, loss=0.0,
                         n_gaussians=int(trainer.state.alive.sum())))
        print(f"eval {args.eval_scene}: val PSNR "
              f"{rows[-1]['val_psnr']:.2f} dB, "
              f"{rows[-1]['n_gaussians']} gaussians")
        scene_path = args.eval_scene
    else:
        t_window = time.perf_counter()
        steps_in_window = 0
        for step in range(1, args.num_iters + 1):
            out = trainer.run_step(step)
            steps_in_window += 1
            if step % val_every == 0 or step == args.num_iters:
                loss = out.loss  # reading it syncs with the device
                dt = time.perf_counter() - t_window
                sps = steps_in_window / dt if dt > 0 else 0.0
                rows.append(dict(step=step,
                                 val_psnr=round(val_psnr(step), 3),
                                 steps_per_sec=round(sps, 3),
                                 loss=round(loss, 6),
                                 n_gaussians=out.n_alive))
                print(f"step {step}: val PSNR {rows[-1]['val_psnr']:.2f} dB, "
                      f"{sps:.2f} steps/s, {out.n_alive} gaussians")
                t_window = time.perf_counter()
                steps_in_window = 0

        scene_path = args.out + "_scene.ply"
        save_scene(trainer.state.params, trainer.state.alive, scene_path,
                   args.num_iters, keep_crs=False, scale=data.scale,
                   translation=data.translation)

    oracle = None
    if not args.no_oracle:
        ckstate, _ = load_ply(scene_path, keep_crs=False, scale=data.scale,
                              translation=data.translation, device="cpu")
        factor = get_downscale_factor(args.num_iters, cfg)
        ours = trainer.render(val_cam, args.num_iters).cpu().numpy()
        oracle_img = oracle_render_scene(
            ckstate.params, ckstate.alive, val_cam.cam_to_world,
            val_cam.fx / factor, val_cam.fy / factor,
            val_cam.cx / factor, val_cam.cy / factor,
            ours.shape[0], ours.shape[1],
            sh_degrees_for_step(args.num_iters, cfg),
            np.asarray(DEFAULT_BACKGROUND, np.float32),
        )
        agree = psnr(ours, oracle_img)
        oracle = dict(agreement_psnr_db=round(agree, 2),
                      ok=bool(agree >= 30.0))
        print(f"oracle cross-check: saved scene renders at "
              f"{oracle['agreement_psnr_db']:.2f} dB agreement "
              f"({'OK' if oracle['ok'] else 'MISMATCH'})")

    report = dict(
        project=os.path.abspath(args.input),
        backend=device.type,
        renderer=renderer,
        num_iters=args.num_iters,
        n_cameras=len(cams),
        curve=rows,
        final=rows[-1] if rows else None,
        oracle_check=oracle,
        scene=os.path.abspath(scene_path),
    )
    with open(args.out + ".json", "w") as f:
        json.dump(report, f, indent=1)

    md = [
        f"# Parity report — {os.path.basename(os.path.abspath(args.input))}",
        "",
        f"backend `{device.type}`, renderer `{renderer}`, "
        f"{len(cams)} train cameras, val `{val_cam.file_path}`",
        "",
        "| step | val PSNR (dB) | steps/s | loss | #gaussians |",
        "|---|---|---|---|---|",
    ]
    for r in rows:
        md.append(f"| {r['step']} | {r['val_psnr']} | {r['steps_per_sec']} "
                  f"| {r['loss']} | {r['n_gaussians']} |")
    if oracle:
        md += ["", f"Oracle cross-check of `{scene_path}`: "
               f"**{oracle['agreement_psnr_db']} dB** agreement "
               f"({'OK' if oracle['ok'] else 'MISMATCH'})"]
    with open(args.out + ".md", "w") as f:
        f.write("\n".join(md) + "\n")
    print(f"Wrote {args.out}.json and {args.out}.md")
    return 0


if __name__ == "__main__":
    sys.exit(main())
