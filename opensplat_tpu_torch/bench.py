"""Benchmark of the port: training steps/s on a synthetic scene.

Counterpart of the JAX package's bench.py, with its environment
interface:

    python -m opensplat_tpu_torch.bench            # the sweep
    BENCH_POINTS=131072 BENCH_RES=512 python -m opensplat_tpu_torch.bench

The default run is the sweep: one JSON line per size of SWEEP, then the
HEADLINE size's line again, last, with the whole sweep under "sweep".
BENCH_POINTS / BENCH_RES run one size and print one line. BENCH_ITERS
(default 20) is the length of the timed window, which opens after one
warm-up step (it also builds the kernels) and a synchronize and closes
with a synchronize. BENCH_RENDERER takes fast (the default; pallas and
auto mean fast, as in cli.pick_renderer), tiled or dense.

The parallel modes run one process per rank, started here through
parallel/launch.py (NCCL with a card a rank, else gloo; gloo on the
CPU); rank 0 alone prints the line, whose unit names the world, the
backend and whether the ranks share a card:
  BENCH_DP=D             camera DP, one camera a rank (dp_train_step);
  BENCH_MP=M             Gaussian sharding over M ranks (gs_train_step);
  BENCH_DP=D BENCH_MP=M  the hybrid on a D x M grid (dpgs_train_step);
  BENCH_SCENES=S         S scenes a step in one process, one batched
                         step (multi_scene_train_step: one launch of
                         each kernel for all scenes, as the JAX bench's
                         vmap);
  BENCH_SCENES_SHARDED=1 the S scenes over S ranks
                         (sharded_multi_scene_step).

It runs on the card; without one it exits non-zero. BENCH_CPU=1 runs the
kernels' plain versions on the CPU, and the line's "device" says so.
"vs_baseline" is null: the JAX bench's anchor holds TPU figures.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time
from typing import NamedTuple

import numpy as np
import torch

from ._device import resolve_device
from .cli import pick_renderer
from .config import TrainConfig
from .models.gaussians import init_model
from .optim.adam import means_lr_schedule
from .train import train_step

SWEEP = ((16384, 256), (131072, 512), (524288, 800), (1048576, 1080))
HEADLINE = (131072, 512)
RANK_TIMEOUT_S = 3600.0


class BenchScene(NamedTuple):
    pts: np.ndarray  # (N, 3) float32
    rgb: np.ndarray  # (N, 3) uint8
    gt: np.ndarray  # (H, W, 3) float32
    c2w: np.ndarray  # (4, 4) float32, the camera at z = +6
    fx: float
    fy: float
    cx: float
    cy: float


def _points(rng, n_points: int):
    """The bench's points, uniform in [-1.5, 1.5]^3, and their colours."""
    pts = rng.uniform(-1.5, 1.5, (n_points, 3)).astype(np.float32)
    rgb = rng.integers(0, 255, (n_points, 3)).astype(np.uint8)
    return pts, rgb


def bench_scene(n_points: int, h: int, seed: int = 0) -> BenchScene:
    """The JAX bench's scene (its bench.py:395-410), square: points
    uniform in [-1.5, 1.5]^3, random colours, then the ground truth, all
    from one generator; the camera at z = +6, fx = fy = 0.9 w."""
    w = h
    rng = np.random.default_rng(seed)
    pts, rgb = _points(rng, n_points)
    gt = rng.uniform(0, 1, (h, w, 3)).astype(np.float32)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 3] = [0.0, 0.0, 6.0]
    return BenchScene(pts, rgb, gt, c2w, 0.9 * w, 0.9 * w, w / 2.0, h / 2.0)


def _derived(steps_per_sec, h, w, n_alive, cams_per_step=1):
    """The metrics the reference's targets are written in: one step
    renders h * w pixels (one ray each) a camera and advances every
    alive Gaussian once."""
    pix = h * w * cams_per_step
    return {
        "mpix_per_sec": round(steps_per_sec * pix / 1e6, 3),
        "rays_per_sec": round(steps_per_sec * pix, 1),
        "gaussians_per_sec": round(steps_per_sec * n_alive, 1),
    }


def bench_renderer() -> str:
    """BENCH_RENDERER's renderer: fast (also pallas and auto, the
    default), tiled or dense."""
    renderer = pick_renderer(os.environ.get("BENCH_RENDERER", "fast"))
    if renderer not in ("fast", "tiled", "dense"):
        raise ValueError(f"BENCH_RENDERER={renderer!r}: fast (pallas, "
                         "auto), tiled or dense")
    return renderer


def bench_device() -> torch.device:
    """The CPU under BENCH_CPU=1, else the card (an error without one)."""
    return resolve_device("cpu" if os.environ.get("BENCH_CPU") else "cuda")


def device_info(dev: torch.device) -> dict:
    """What ran the line: the card's name and power limit as nvidia-smi
    gives them and the card count, or the CPU."""
    if dev.type == "cpu":
        return {"platform": "cpu"}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    name, limit = (s.strip() for s in smi[dev.index or 0].split(","))
    return {"platform": "gpu", "name": name, "power_limit": limit,
            "count": torch.cuda.device_count()}


def _sync(dev: torch.device):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _config(n_points: int):
    cfg = TrainConfig(num_iters=30000, capacity_round=n_points)
    return cfg, means_lr_schedule(cfg.lr_means, cfg.lr_means_final,
                                  cfg.num_iters, 0)


def single_step(n_points: int, h: int, renderer: str, dev):
    """(state, step): the bench model on `dev` (init_model, SH degree 3,
    capacity = n_points, seed 0) and one training step of it, state ->
    (state, metrics), through train_step on the bench scene's camera."""
    dev = resolve_device(dev)
    sc = bench_scene(n_points, h)
    state = init_model(sc.pts, sc.rgb, sh_degree=3, capacity=n_points,
                       seed=0, device=dev)
    cfg, lr = _config(n_points)
    c2w = torch.from_numpy(sc.c2w).to(dev)
    gt = torch.from_numpy(sc.gt).to(dev)

    def step(state):
        return train_step(state, c2w, sc.fx, sc.fy, sc.cx, sc.cy, gt, lr, h,
                          h, 3, cfg, True, renderer, device=dev)

    return state, step


def timed_window(step, state, n_iters: int, dev, barrier=None):
    """One warm-up step, then `n_iters` steps between two synchronizes.
    With ranks, `barrier()` runs before the clock starts and returns the
    slowest rank's window after it stops. Returns (state, the last
    metrics, seconds)."""
    state, m = step(state)
    _sync(dev)
    if barrier is not None:
        barrier(0.0)
    t0 = time.perf_counter()
    for _ in range(n_iters):
        state, m = step(state)
    _sync(dev)
    dt = time.perf_counter() - t0
    if barrier is not None:
        dt = barrier(dt)
    return state, m, dt


def _line(metric, value, unit, derived, dev):
    if not math.isfinite(value) or value <= 0:
        raise RuntimeError(f"bench: {metric} measured {value}")
    return {"metric": metric, "value": round(value, 3), "unit": unit,
            "vs_baseline": None, **derived, "device": device_info(dev)}


def run_single(n_points: int, h: int, renderer: str, dev,
               n_iters: int) -> dict:
    """Steps/s of train_step on the bench scene at n_points Gaussians and
    h x h px; prints the line and returns it. The peak memory and
    the demand go to stderr."""
    state, step = single_step(n_points, h, renderer, dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    state, m, dt = timed_window(step, state, n_iters, dev)
    sps = n_iters / dt
    peak = (f"peak memory {torch.cuda.max_memory_allocated(dev) / 2**20:.0f}"
            " MiB; " if dev.type == "cuda" else "")
    print(f"bench: {n_points} g, {h} px: {peak}demand "
          + json.dumps({k: int(m[k]) for k in
                        ("n_cands", "n_isects", "n_grads")}),
          file=sys.stderr, flush=True)
    rec = _line(f"train_steps_per_sec[{renderer},{n_points}g,{h}px]", sps,
                "steps/s", _derived(sps, h, h, int(m["n_alive"])), dev)
    print(json.dumps(rec), flush=True)
    return rec


def run_sweep(renderer: str, dev, n_iters: int, sweep=SWEEP,
              headline=HEADLINE) -> dict:
    """One line per size of `sweep`, then the headline size's line last
    with every line under "sweep"."""
    results = {size: run_single(*size, renderer, dev, n_iters)
               for size in sweep}
    head = dict(results[headline])
    head["sweep"] = list(results.values())
    print(json.dumps(head), flush=True)
    return head


# ---- the parallel modes: one process per rank ----

def _world(dp: int, mp: int, scenes: int, sharded: bool) -> int:
    if dp and mp:
        return dp * mp
    if dp or mp:
        return dp or mp
    return scenes if sharded else 0


def _launch(world: int, dev: torch.device):
    """This program as `world` ranks: NCCL with a card a rank, else gloo
    (ranks sharing a card, or the CPU). Rank 0 prints the line."""
    from .parallel.launch import run_ranks

    backend = ("nccl" if dev.type == "cuda"
               and torch.cuda.device_count() >= world else "gloo")
    run_ranks([sys.executable, "-m", "opensplat_tpu_torch.bench"], world,
              backend=backend, timeout=RANK_TIMEOUT_S, capture=False)


def _ranks_label(world: int, dev: torch.device) -> str:
    import torch.distributed as dist

    where = ("CPU" if dev.type == "cpu" else
             "sharing one card" if torch.cuda.device_count() < world
             else "a card each")
    return f"{world} ranks, {dist.get_backend()}, {where}"


def _cameras(n: int, h: int, rng):
    """n cameras at z = 6 + 0.01 i and their ground truths, drawn from
    `rng` after the points, as the JAX bench's DP and multi-scene modes
    draw them."""
    c2ws = np.broadcast_to(np.eye(4, dtype=np.float32), (n, 4, 4)).copy()
    c2ws[:, 2, 3] = 6.0 + 0.01 * np.arange(n)
    gts = rng.uniform(0, 1, (n, h, h, 3)).astype(np.float32)
    return c2ws, gts


def _rank_main(dp, mp, scenes, n_points, h, renderer, n_iters):
    """One rank of a parallel mode (the launcher set OPENSPLAT_*)."""
    import torch.distributed as dist

    from .parallel.distributed import initialize_from_env, rank_device
    from .parallel.gaussian_shard import (dpgs_train_step, gs_train_step,
                                          shard_state)
    from .parallel.dp_trainer import dp_train_step
    from .parallel.mesh import make_mesh, replicate
    from .parallel.multi_scene import sharded_multi_scene_step, stack_states

    want = "cpu" if os.environ.get("BENCH_CPU") else "cuda"
    initialize_from_env(device=want)
    dev = rank_device(want)
    world = dist.get_world_size()
    cfg, lr = _config(n_points)
    f, c = 0.9 * h, h / 2.0
    rng = np.random.default_rng(0)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    if scenes:  # sharded multi-scene: a block of scenes a rank
        mesh = make_mesh(world, 1)
        per = scenes // world
        mine = range(mesh.index["data"] * per, (mesh.index["data"] + 1) * per)
        drawn = [_points(rng, n_points) for _ in range(scenes)]
        state = stack_states([init_model(*drawn[i], sh_degree=3,
                                         capacity=n_points, seed=i,
                                         device=dev) for i in mine])
        c2ws, gts = _cameras(scenes, h, rng)
        cam, gt = t(c2ws[mine.start:mine.stop]), t(gts[mine.start:mine.stop])
        fs, cs = [f] * per, [c] * per
        step = lambda st: sharded_multi_scene_step(
            st, cam, fs, fs, cs, cs, gt, lr, mesh, h, h, 3, cfg, True,
            renderer)
        metric = f"scene_steps_per_sec[{renderer},{n_points}g,{h}px," \
                 f"s{scenes}-sharded]"
        unit = f"scene-steps/s ({scenes} scenes/step"
        per_step, cams = scenes, 1
    else:
        mesh = make_mesh(dp or 1, mp or 1)
        state = init_model(*_points(rng, n_points), sh_degree=3,
                           capacity=n_points, seed=0, device=dev)
        if mp:
            state = shard_state(mesh, state)
        else:
            state = replicate(mesh, state)
        c2ws, gts = _cameras(dp or 1, h, rng)
        # this rank's camera (MP: the one camera at z = 6)
        row = mesh.index["data"]
        cam, gt = t(c2ws[row:row + 1]), t(gts[row:row + 1])
        if dp and mp:
            step = lambda st: dpgs_train_step(
                st, cam[0], f, f, c, c, gt[0], lr, mesh, h, h, 3, cfg, True,
                renderer)
            metric = f"hybrid_train_steps_per_sec[{renderer},{n_points}g," \
                     f"{h}px,dp{dp}xmp{mp}]"
            unit = f"steps/s ({dp} cameras/step, capacity 1/{mp}"
        elif dp:
            step = lambda st: dp_train_step(
                st, cam, [f], [f], [c], [c], gt, lr, mesh, h, h, 3, cfg, True,
                renderer)
            metric = f"dp_train_steps_per_sec[{renderer},{n_points}g,{h}px," \
                     f"dp{dp}]"
            unit = f"steps/s ({dp} cameras/step"
        else:
            step = lambda st: gs_train_step(
                st, cam[0], f, f, c, c, gt[0], lr, mesh, h, h, 3, cfg, True,
                renderer)
            metric = f"mp_train_steps_per_sec[{renderer},{n_points}g,{h}px," \
                     f"mp{mp}]"
            unit = f"steps/s (capacity sharded 1/{mp}"
        per_step, cams = 1, dp or 1

    def barrier(seconds):
        x = torch.tensor([seconds], dtype=torch.float64, device=dev)
        dist.all_reduce(x, op=dist.ReduceOp.MAX)
        return float(x)

    state, m, dt = timed_window(step, state, n_iters, dev, barrier)
    # multi-scene metrics are per scene: the mean alive count a scene
    n_alive = int(torch.mean(m["n_alive"].double()))
    if dist.get_rank() == 0:
        rate = n_iters * per_step / dt
        print(json.dumps(_line(
            metric, rate, f"{unit}; {_ranks_label(world, dev)})",
            _derived(rate, h, h, n_alive, cams_per_step=cams), dev)),
            flush=True)


def run_scenes(s: int, n_points: int, h: int, renderer: str, dev,
               n_iters: int) -> dict:
    """S scenes a step in this process: multi_scene_train_step, one
    batched step over the stacked scenes (the JAX bench's s{S}-vmap)."""
    from .parallel.multi_scene import multi_scene_train_step, stack_states

    cfg, lr = _config(n_points)
    rng = np.random.default_rng(0)
    states = [init_model(*_points(rng, n_points), sh_degree=3,
                         capacity=n_points, seed=i, device=dev)
              for i in range(s)]
    c2ws, gts = _cameras(s, h, rng)
    c2ws, gts = torch.from_numpy(c2ws).to(dev), torch.from_numpy(gts).to(dev)
    f, c = [0.9 * h] * s, [h / 2.0] * s
    step = lambda st: multi_scene_train_step(st, c2ws, f, f, c, c, gts, lr,
                                             h, h, 3, cfg, True, renderer)
    _, m, dt = timed_window(step, stack_states(states), n_iters, dev)
    rate = n_iters * s / dt
    rec = _line(f"scene_steps_per_sec[{renderer},{n_points}g,{h}px,s{s}-vmap]",
                rate, f"scene-steps/s ({s} scenes/step)",
                _derived(rate, h, h, int(torch.mean(m["n_alive"].double()))),
                dev)
    print(json.dumps(rec), flush=True)
    return rec


def main() -> int:
    env = os.environ
    renderer = bench_renderer()
    dp = int(env.get("BENCH_DP", 0))
    mp = int(env.get("BENCH_MP", 0))
    scenes = int(env.get("BENCH_SCENES", 0))
    sharded = bool(int(env.get("BENCH_SCENES_SHARDED", "0")))
    n_iters = int(env.get("BENCH_ITERS", 20))
    n_points = int(env.get("BENCH_POINTS") or HEADLINE[0])
    h = int(env.get("BENCH_RES") or HEADLINE[1])
    dev = bench_device()
    world = _world(dp, mp, scenes, sharded)
    if world:
        if env.get("OPENSPLAT_COORDINATOR"):  # a rank the launcher started
            _rank_main(dp, mp, 0 if dp or mp else scenes, n_points, h,
                       renderer, n_iters)
        else:
            _launch(world, dev)
        return 0
    if scenes:
        run_scenes(scenes, n_points, h, renderer, dev, n_iters)
    elif env.get("BENCH_POINTS") or env.get("BENCH_RES"):
        run_single(n_points, h, renderer, dev, n_iters)
    else:
        run_sweep(renderer, dev, n_iters)
    return 0


if __name__ == "__main__":
    sys.exit(main())
