"""opensplat-compatible command-line trainer on the port.

Counterpart of opensplat_tpu/cli.py: the same flags with the same
defaults (the reference's names, opensplat.cpp:19-51), and its main()
(opensplat.cpp:121-207): load the project, load images in parallel,
withhold a validation camera, train with refine/reset, periodic saves,
checkpoints and validation renders, then cameras.json, the scene, the
oracle check and the validation loss.

It trains on CUDA unless given --cpu (then the kernels' plain PyTorch
versions run); without a card it fails, never falling back to the CPU.
--renderer auto, pallas and fast select the port's kernels; dense and
tiled the conformance renderers (ops/rasterize.py,
ops/rasterize_tiled.py). The parallel flags run as in the JAX CLI, one
process per rank (parallel/): --distributed joins the ranks named by
OPENSPLAT_COORDINATOR / OPENSPLAT_NUM_PROCESSES / OPENSPLAT_PROCESS_ID
(without them it trains single-process), --data-parallel D trains
camera-DP over D ranks, --model-parallel M shards the Gaussians over M
ranks, and both together train the hybrid; D and M are clamped to the
ranks there are, and a rank left outside the grid idles. Only rank 0
writes scene files, checkpoints, the metrics file and the report.

    python -m opensplat_tpu_torch.cli <project> -o out/scene.ply
    python -m opensplat_tpu_torch.parallel.launch -n 2 -- \
        python -m opensplat_tpu_torch.cli <project> --distributed \
        --data-parallel -1
"""
from __future__ import annotations

import argparse
import glob
import os
import re
import sys
import time
from concurrent.futures import ThreadPoolExecutor

def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="opensplat",
        description="Open Source 3D Gaussian Splats generator (PyTorch + "
        "CUDA port)",
    )
    p.add_argument("input", nargs="?", help="Path to project root "
                   "(colmap/nerfstudio/opensfm/odm/openmvg)")
    p.add_argument("-i", "--input", dest="input_flag", default=None,
                   help="Path to nerfstudio project")
    p.add_argument("-o", "--output", default="splat.ply",
                   help="Path where to save output scene")
    p.add_argument("-s", "--save-every", type=int, default=-1,
                   help="Save output scene every these many steps (-1 to disable)")
    p.add_argument("--resume", default="",
                   help="Resume training from this PLY file or .npz checkpoint")
    p.add_argument("--val", action="store_true",
                   help="Withhold a camera shot for validating the scene loss")
    p.add_argument("--val-image", default="random",
                   help="Filename of the image to withhold for validation")
    p.add_argument("--val-render", default="",
                   help="Path of the directory where to render validation images")
    p.add_argument("--keep-crs", action="store_true",
                   help="Retain the project input's coordinate reference system")
    p.add_argument("--cpu", action="store_true",
                   help="Force CPU execution (the kernels' plain versions)")
    p.add_argument("-n", "--num-iters", type=int, default=30000,
                   help="Number of iterations to run")
    p.add_argument("-d", "--downscale-factor", type=float, default=1.0,
                   help="Scale input images by this factor")
    p.add_argument("--num-downscales", type=int, default=2)
    p.add_argument("--resolution-schedule", type=int, default=3000,
                   help="Double the image resolution every these many steps")
    p.add_argument("--sh-degree", type=int, default=3)
    p.add_argument("--sh-degree-interval", type=int, default=1000)
    p.add_argument("--ssim-weight", type=float, default=0.2)
    p.add_argument("--refine-every", type=int, default=100)
    p.add_argument("--warmup-length", type=int, default=500)
    p.add_argument("--reset-alpha-every", type=int, default=30)
    p.add_argument("--densify-grad-thresh", type=float, default=0.0002)
    p.add_argument("--densify-size-thresh", type=float, default=0.01)
    p.add_argument("--stop-screen-size-at", type=int, default=4000)
    p.add_argument("--split-screen-size", type=float, default=0.05)
    p.add_argument("--colmap-image-path", default="",
                   help="Override the default image path for COLMAP input")
    p.add_argument("--renderer", default="auto",
                   choices=["auto", "dense", "tiled", "pallas", "fast"],
                   help="auto, pallas and fast run the port's CUDA kernels; "
                   "dense and tiled the conformance renderers")
    p.add_argument("--capacity", type=int, default=None,
                   help="Fixed Gaussian capacity (default: auto)")
    p.add_argument("--distributed", action="store_true",
                   help="Multi-process training: join the ranks named by "
                   "OPENSPLAT_COORDINATOR/OPENSPLAT_NUM_PROCESSES/"
                   "OPENSPLAT_PROCESS_ID (backend: OPENSPLAT_BACKEND, NCCL "
                   "on cards by default; parallel/distributed.py)")
    p.add_argument("--data-parallel", type=int, default=0, metavar="D",
                   help="Camera data-parallelism over D ranks, one camera "
                   "per rank per step (-1 = all ranks)")
    p.add_argument("--model-parallel", type=int, default=0, metavar="M",
                   help="Shard the Gaussians over M ranks (-1 = all ranks); "
                   "with --data-parallel, hybrid DP x MP")
    p.add_argument("--checkpoint-every", type=int, default=-1,
                   help="Write a full-state checkpoint every N steps")
    p.add_argument("--gt-cache-mb", type=int, default=1024,
                   help="Device memory budget for the ground-truth image "
                   "cache (LRU per (camera, factor); 0 disables)")
    p.add_argument("--ckpt-dir", default="",
                   help="Directory for checkpoints")
    p.add_argument("--metrics-file", default="",
                   help="Write per-step structured metrics (JSONL) here")
    p.add_argument("--profile-dir", default="",
                   help="Write a torch.profiler Chrome trace of steps "
                   "start+5 .. start+15 into this dir")
    p.add_argument("--auto-resume", action="store_true",
                   help="Resume from the newest checkpoint in --ckpt-dir "
                   "if one exists (pair with --checkpoint-every)")
    p.add_argument("--serve", type=int, default=0, metavar="PORT",
                   help="Serve the --report-dir on 127.0.0.1:PORT during "
                   "training (auto-refreshing page with pause/stop "
                   "buttons)")
    p.add_argument("--report-dir", default="",
                   help="Write a self-contained HTML training report "
                   "(loss/PSNR/population curves + render-vs-GT snapshots)")
    p.add_argument("--oracle-check", action="store_true",
                   help="After training, reload the saved scene and render "
                   "one view through the NumPy conformance oracle, "
                   "cross-checking the saved file against the kernels' "
                   "render")
    p.add_argument("--version", action="version",
                   version="opensplat_tpu_torch 0.1.0")
    return p


def pick_renderer(choice: str) -> str:
    """The renderer a --renderer choice names: auto and pallas are the
    port's kernels ("fast") on every device."""
    return "fast" if choice in ("auto", "pallas") else choice


def _latest_checkpoint(ckpt_dir: str) -> str:
    ckpts = glob.glob(os.path.join(ckpt_dir, "ckpt_*.npz"))
    if not ckpts:
        return ""
    return max(ckpts, key=lambda p: int(
        re.search(r"ckpt_(\d+)\.npz$", p).group(1)))


def _start_server(report_dir: str, port: int):
    """Serve report_dir on 127.0.0.1 with the pause/resume/stop channel
    (POST /__control__ writes <report_dir>/control.txt)."""
    import http.server
    import threading

    class _Handler(http.server.SimpleHTTPRequestHandler):
        def __init__(self, *a, **kw):
            super().__init__(*a, directory=report_dir, **kw)

        def do_POST(self):
            if self.path != "/__control__":
                self.send_error(404)
                return
            n = int(self.headers.get("Content-Length", 0))
            cmd = self.rfile.read(n).decode()[:16].strip()
            if cmd not in ("pause", "resume", "stop"):
                self.send_error(400)
                return
            with open(os.path.join(report_dir, "control.txt"), "w") as f:
                f.write(cmd)
            self.send_response(200)
            self.end_headers()

        def log_message(self, *a):
            pass

    httpd = http.server.ThreadingHTTPServer(("127.0.0.1", port), _Handler)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    print(f"Live training view: http://127.0.0.1:{port}/report.html")
    return httpd


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    project_root = args.input_flag or args.input
    if not project_root:
        build_parser().print_help()
        return 0

    import torch.distributed as dist

    try:
        return _train(args, project_root)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _make_trainer(args, state, cams, cfg, device):
    """The trainer the parallel flags ask for (the JAX CLI's branches,
    ranks where it has devices), or None on a rank outside the grid."""
    import torch.distributed as dist

    from .parallel.dp_trainer import DPTrainer
    from .parallel.gaussian_shard import GSTrainer
    from .parallel.mesh import make_mesh
    from .train import Trainer

    renderer = pick_renderer(cfg.renderer)
    world = dist.get_world_size() if dist.is_initialized() else 1
    d, m = args.data_parallel, args.model_parallel
    if d and m:
        # hybrid: camera-DP x Gaussian-MP on a (data, model) grid
        n_data = d if d > 0 else 2
        n_model = m if m > 0 else 2
        if n_data * n_model > world:
            raise SystemExit(
                f"--data-parallel {n_data} x --model-parallel {n_model} "
                f"needs {n_data * n_model} ranks, have {world}")
        print(f"Hybrid training: {n_data}-camera DP x {n_model}-shard "
              f"Gaussian MP ({n_data * n_model} ranks)")
        cls = GSTrainer
    elif d:
        n_data, n_model = min(d if d > 0 else world, world), 1
        print(f"Camera data-parallel training over {n_data} ranks")
        cls = DPTrainer
    elif m:
        n_data, n_model = 1, min(m if m > 0 else world, world)
        print(f"Gaussian model-parallel training over {n_model} ranks")
        cls = GSTrainer
    else:
        return Trainer(state, cams, cfg, renderer=renderer, device=device)
    mesh = make_mesh(n_data, n_model, ranks=range(n_data * n_model))
    if not mesh.member:
        print(f"rank {dist.get_rank()}: outside the {n_data} x {n_model} "
              "grid of ranks; idle")
        return None
    return cls(state, cams, cfg, renderer=renderer, mesh=mesh, device=device)


def _train(args, project_root) -> int:
    import numpy as np
    import torch
    import torch.distributed as dist

    from .config import TrainConfig
    from .data.dataset import input_data_from_x
    from .io import load_checkpoint, load_ply, save_checkpoint, save_scene
    from .models.gaussians import init_model
    from .ops.ssim import main_loss, psnr
    from .parallel.distributed import initialize_from_env, rank_device
    from .train import get_downscale_factor

    base_device = "cpu" if args.cpu else "cuda"
    if args.distributed:
        initialize_from_env(device=base_device)
        if dist.is_initialized():
            print(f"Distributed: process {dist.get_rank()}/"
                  f"{dist.get_world_size()} ({dist.get_backend()})")
        else:
            print("Distributed: no cluster detected, single-process run")
    device = rank_device(base_device)
    world = dist.get_world_size() if dist.is_initialized() else 1
    is_main = world == 1 or dist.get_rank() == 0
    print("Using " + (torch.cuda.get_device_name(device)
                      if device.type == "cuda" else "CPU"))
    # loss print cadence: every 10 steps on a card, every step on the CPU
    # (opensplat.cpp:102-113)
    display_step = 10 if device.type == "cuda" else 1

    cfg = TrainConfig(
        input=project_root,
        output=args.output,
        save_every=args.save_every,
        resume=args.resume,
        val=args.val,
        val_image=args.val_image,
        val_render=args.val_render,
        keep_crs=args.keep_crs,
        cpu=args.cpu,
        num_iters=args.num_iters,
        downscale_factor=max(args.downscale_factor, 1.0),
        num_downscales=args.num_downscales,
        resolution_schedule=args.resolution_schedule,
        sh_degree=args.sh_degree,
        sh_degree_interval=args.sh_degree_interval,
        ssim_weight=args.ssim_weight,
        refine_every=args.refine_every,
        warmup_length=args.warmup_length,
        reset_alpha_every=args.reset_alpha_every,
        densify_grad_thresh=args.densify_grad_thresh,
        densify_size_thresh=args.densify_size_thresh,
        stop_screen_size_at=args.stop_screen_size_at,
        split_screen_size=args.split_screen_size,
        colmap_image_path=args.colmap_image_path,
        capacity=args.capacity,
        renderer=args.renderer,
        checkpoint_every=args.checkpoint_every,
        ckpt_dir=args.ckpt_dir,
        gt_cache_mb=args.gt_cache_mb,
    )

    out_dir = os.path.dirname(cfg.output)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)

    t_load = time.perf_counter()
    input_data = input_data_from_x(project_root, cfg.colmap_image_path)
    with ThreadPoolExecutor() as ex:  # parallel image load (opensplat.cpp:124)
        list(ex.map(lambda c: c.load_image(cfg.downscale_factor),
                    input_data.cameras))
    print(f"Loaded {len(input_data.cameras)} images and "
          f"{input_data.points_xyz.shape[0]} points in "
          f"{time.perf_counter() - t_load:.2f} s")

    validate = cfg.val or bool(cfg.val_render)
    cams, val_cam = input_data.get_cameras(validate, cfg.val_image)
    if cfg.val_render:
        os.makedirs(cfg.val_render, exist_ok=True)

    resume_path = cfg.resume
    if not resume_path and args.auto_resume and cfg.ckpt_dir:
        resume_path = _latest_checkpoint(cfg.ckpt_dir)
    start_step = 1
    resume_draws = -1
    if resume_path:
        if resume_path.endswith(".npz"):
            state, step0, resume_draws = load_checkpoint(resume_path,
                                                         device=device)
        else:
            state, step0 = load_ply(
                resume_path,
                keep_crs=cfg.keep_crs,
                scale=input_data.scale,
                translation=input_data.translation,
                capacity=cfg.capacity,
                device=device,
            )
        start_step = step0 + 1
        print(f"Resuming from {resume_path} at step {start_step}")
    else:
        state = init_model(
            input_data.points_xyz,
            input_data.points_rgb,
            sh_degree=cfg.sh_degree,
            capacity=cfg.capacity,
            capacity_mult=cfg.capacity_mult,
            capacity_round=cfg.capacity_round,
            seed=cfg.seed,
            device=device,
        )

    trainer = _make_trainer(args, state, cams, cfg, device)
    if trainer is None:
        return 0
    if resume_path:
        # replay the camera sampler to the checkpoint's position so the
        # resumed run continues the uninterrupted run's camera order; a
        # PLY (no recorded position) falls back to steps times batch
        ff = resume_draws if resume_draws >= 0 else (
            (start_step - 1) * trainer.d_total)
        trainer.sampler.fast_forward(ff)

    from .utils.metrics import MetricsLogger, profile_trace

    # every rank trains; only rank 0 writes the files
    metrics = MetricsLogger(args.metrics_file if is_main else "")
    report = None
    control_file = None
    httpd = None
    if args.report_dir:
        from .utils.report import TrainingReport

        control_file = os.path.join(args.report_dir, "control.txt")
        if is_main:
            report = TrainingReport(args.report_dir)
            if os.path.exists(control_file):  # a stale command of an old run
                os.remove(control_file)
            if args.serve:
                httpd = _start_server(args.report_dir, args.serve)

    def save_intermediate(step):
        st = trainer.full_state()  # gathers the shards: every rank calls
        stem, ext = os.path.splitext(cfg.output)
        if is_main:
            save_scene(
                st.params, st.alive, f"{stem}_{step}{ext}", step,
                keep_crs=cfg.keep_crs, scale=input_data.scale,
                translation=input_data.translation,
            )
            print(f"Wrote {stem}_{step}{ext}")

    def control_cmd():
        # pause/stop channel (visualizer.cpp:184-195 semantics, headless:
        # a control file written by the --serve buttons or by hand); rank
        # 0 reads it and every rank acts on what rank 0 read
        if control_file is None:
            return None
        cmd = None
        if is_main:
            try:
                with open(control_file) as f:
                    cmd = f.read().strip()
            except OSError:
                cmd = None
        if world > 1:
            box = [cmd]
            dist.broadcast_object_list(box, src=0)
            cmd = box[0]
        return cmd

    profiling = None
    try:
        for step in range(start_step, cfg.num_iters + 1):
            if args.profile_dir and step == start_step + 5:
                profiling = profile_trace(args.profile_dir)
                profiling.__enter__()
            outcome = trainer.run_step(step)
            h, w = trainer.last_hw
            # reading the metrics syncs with the card: only at display
            # cadence, or every step when a metrics file is asked for
            if args.metrics_file or step % display_step == 0:
                metrics.step(step, outcome.loss, outcome.psnr,
                             outcome.n_alive, h, w)
            else:
                metrics.tick(h, w)
            if trainer.refine_metrics is not None:
                metrics.refine(step, trainer.refine_metrics)
                trainer.refine_metrics = None
            if profiling is not None and step == min(start_step + 15,
                                                     cfg.num_iters):
                profiling.__exit__(None, None, None)
                profiling = None
            if step % display_step == 0:
                pct = int(100.0 * step / cfg.num_iters)
                print(
                    f"Step {step}: {outcome.loss:.6f} ({pct}%)"
                    f" [{metrics.steps_per_sec():.2f} steps/s,"
                    f" {outcome.n_alive} gaussians]"
                )
                if args.report_dir:
                    _report_step(report, trainer, cfg, step, display_step,
                                 outcome, val_cam, bool(args.serve))
                cmd = control_cmd()
                if cmd == "pause":
                    print("Paused (control.txt) — write 'resume' to continue")
                    while control_cmd() == "pause":
                        time.sleep(0.5)
                    cmd = control_cmd()
                    print("Resumed")
                if cmd == "stop":
                    if is_main:
                        os.remove(control_file)
                    print(f"Stop requested at step {step} — saving and "
                          "exiting")
                    break
            if cfg.save_every > 0 and step % cfg.save_every == 0:
                save_intermediate(step)
            if cfg.checkpoint_every > 0 and step % cfg.checkpoint_every == 0:
                st = trainer.full_state()
                if is_main:
                    ckpt_dir = (cfg.ckpt_dir or os.path.dirname(cfg.output)
                                or ".")
                    os.makedirs(ckpt_dir, exist_ok=True)
                    save_checkpoint(
                        st, step, os.path.join(ckpt_dir, f"ckpt_{step}.npz"),
                        sampler_draws=trainer.sampler.draws, seed=cfg.seed,
                    )
            if cfg.val_render and step % 10 == 0:
                rgb = trainer.render(val_cam, step).cpu().numpy()
                if is_main:
                    _write_png(os.path.join(cfg.val_render, f"{step}.png"),
                               rgb)
    finally:
        if profiling is not None:
            profiling.__exit__(None, None, None)
        metrics.close()
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
    if report is not None:
        print(f"Wrote {report.write()}")
    final = trainer.full_state()
    if is_main:
        cameras_json = os.path.join(os.path.dirname(cfg.output) or ".",
                                    "cameras.json")
        input_data.save_cameras(cameras_json, cfg.keep_crs)
        save_scene(
            final.params, final.alive, cfg.output, cfg.num_iters,
            keep_crs=cfg.keep_crs, scale=input_data.scale,
            translation=input_data.translation,
        )
        print(f"Wrote {cfg.output}")

    if args.oracle_check and cfg.output.endswith(".ply"):
        from .models.splat_model import DEFAULT_BACKGROUND
        from .oracle.scene_check import oracle_render_scene
        from .oracle.scene_check import psnr as np_psnr
        from .train import sh_degrees_for_step

        check_cam = val_cam if val_cam is not None else cams[0]
        factor = get_downscale_factor(cfg.num_iters, cfg)
        ours = trainer.render(check_cam, cfg.num_iters).cpu().numpy()
    if args.oracle_check and cfg.output.endswith(".ply") and is_main:
        ckstate, _ = load_ply(
            cfg.output, keep_crs=cfg.keep_crs, scale=input_data.scale,
            translation=input_data.translation, device="cpu",
        )
        t_oracle = time.perf_counter()
        oracle_img = oracle_render_scene(
            ckstate.params, ckstate.alive, check_cam.cam_to_world,
            check_cam.fx / factor, check_cam.fy / factor,
            check_cam.cx / factor, check_cam.cy / factor,
            ours.shape[0], ours.shape[1],
            sh_degrees_for_step(cfg.num_iters, cfg),
            np.asarray(DEFAULT_BACKGROUND, np.float32),
        )
        agree = np_psnr(ours, oracle_img)
        print(
            f"oracle-check [{check_cam.file_path}]: saved-scene oracle "
            f"render vs pipeline render PSNR {agree:.2f} dB "
            f"({'OK' if agree >= 30.0 else 'MISMATCH'}; oracle "
            f"{time.perf_counter() - t_oracle:.1f} s)"
        )

    if val_cam is not None:
        rgb = trainer.render(val_cam, cfg.num_iters)
        gt = torch.as_tensor(np.ascontiguousarray(
            val_cam.get_image(get_downscale_factor(cfg.num_iters, cfg))),
            device=device)
        vloss = float(main_loss(rgb, gt, cfg.ssim_weight))
        vpsnr = float(psnr(rgb, gt))
        print(f"{val_cam.file_path} validation loss: {vloss:.6f} "
              f"(PSNR {vpsnr:.2f} dB)")
    return 0


def _report_step(report, trainer, cfg, step, display_step, outcome, val_cam,
                 live):
    """Curves every display step; a render-vs-GT snapshot and the point
    cloud about ten times a run; the page rewritten every 10 displays
    (every display when served). Every rank calls it (the render and
    the state may be gathered over ranks); `report` is None off rank 0."""
    import numpy as np

    from .ops.sh import sh_to_rgb
    from .train import get_downscale_factor

    if report is not None:
        report.log(step, outcome.loss, outcome.psnr, outcome.n_alive)
    snap_every = max(1, cfg.num_iters // 10)
    if step % snap_every < display_step or step == cfg.num_iters:
        if val_cam is not None:
            rgb = trainer.render(val_cam, step).cpu().numpy()
            gt = val_cam.get_image(get_downscale_factor(step, cfg))
            if report is not None:
                report.snapshot(step, rgb, np.asarray(gt))
        st = trainer.full_state()
        if report is not None:
            alive = st.alive.cpu().numpy()
            report.point_cloud(
                step, st.params.means.cpu().numpy()[alive],
                sh_to_rgb(st.params.features_dc).cpu().numpy()[alive])
    if report is not None and (live or step % (display_step * 10) == 0):
        report.write(live=True)


def _write_png(path: str, rgb):
    import numpy as np

    from .data._image import write_png

    write_png(path, (np.clip(rgb, 0, 1) * 255).astype(np.uint8))


if __name__ == "__main__":
    sys.exit(main())
