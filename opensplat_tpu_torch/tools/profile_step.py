"""Where a training step's device time goes: the step's anatomy.

Counterpart of the JAX package's tools/profile_step.py, with its knobs:
BENCH_POINTS / BENCH_RES / BENCH_RENDERER pick the bench model
(bench.bench_scene; default 131072 Gaussians at 512 px, the fast
renderer), PROFILE_DIR the directory of the Chrome trace (default a new
temporary one), PROFILE_FULL_NAMES=1 ranks whole kernel names instead of
their stems.

    BENCH_POINTS=1048576 BENCH_RES=1080 \\
        python -m opensplat_tpu_torch.tools.profile_step

One warm-up step (it also builds the kernels), 6 steps timed on the
host, then 6 steps under torch.profiler; each step ends in a
synchronize. Prints the steps' wall times, the device time a step and
its share of the unprofiled wall, the top 40
CUDA kernels by device time (summed by name stem: ms a step, share,
launches the trace recorded; the trace can miss launches in
back-to-back loops, so the count is printed), and SSIM's device time
alone at the image's size (forward and backward of ops/ssim.py, which
the step's GEMM rows do not name). BENCH_CPU=1 profiles the CPU instead:
the table is then CPU op time, not device time.
"""
from __future__ import annotations

import os
import statistics
import tempfile
import time

import torch

from .. import bench
from ..ops.ssim import ssim
from .profiling import by_stem, device_rows

N_STEPS = 6
TOP = 40


def ssim_ms(h: int, dev, n: int) -> float:
    """Time a call of SSIM's forward and backward on an h x h image
    (device ms on a card, self CPU op ms on the CPU), over n calls."""
    gen = torch.Generator(device=dev).manual_seed(0)
    gt = torch.rand((h, h, 3), generator=gen, device=dev)
    img = torch.rand((h, h, 3), generator=gen, device=dev,
                     requires_grad=True)

    def one():
        (1.0 - ssim(img, gt)).backward()

    one()
    return sum(ms * c for _, ms, c in device_rows(one, n, dev)) / n


def anatomy(n_points: int, h: int, renderer: str, dev, trace_dir: str,
            n_steps: int = N_STEPS, full_names: bool = False) -> dict:
    """Profile n_steps steps of the bench model and print the anatomy.
    The wall a step is timed first over n_steps steps without the
    profiler (its tracing slows the host). Returns {"wall_ms": the
    unprofiled steps' walls, "profiled_wall_ms", "busy_ms": time a
    step, "busy_share": of the unprofiled wall, "rows": device_rows'
    rows, "stems": [(stem, ms a step, share, launches recorded)],
    "ssim_ms", "ssim_share"}."""
    state, step = bench.single_step(n_points, h, renderer, dev)
    holder = [step(state)[0]]
    bench._sync(dev)

    def one(walls):
        t0 = time.perf_counter()
        holder[0] = step(holder[0])[0]
        bench._sync(dev)
        walls.append((time.perf_counter() - t0) * 1e3)

    walls, traced = [], []
    for _ in range(n_steps):
        one(walls)
    trace = os.path.join(trace_dir, "trace.json")
    rows = device_rows(lambda: one(traced), n_steps, dev, trace=trace)
    busy = sum(ms * c for _, ms, c in rows) / n_steps
    wall = statistics.mean(walls)
    what = "device time" if dev.type == "cuda" else "CPU op time (self)"
    kind = ("CUDA kernels" if dev.type == "cuda" else "CPU ops")
    on = (bench.device_info(dev)["name"] if dev.type == "cuda" else "CPU")
    print(f"config: {renderer} {n_points}g @ {h}px on {on}; trace "
          f"{trace}")
    print("step wall times (ms, each ended by a synchronize): "
          + ", ".join(f"{t:.2f}" for t in walls) + "; under the profiler "
          + ", ".join(f"{t:.2f}" for t in traced))
    print(f"{what} a step: {busy:.3f} ms of a {wall:.3f} ms step "
          f"({100 * busy / wall:.1f}% busy)")
    stems = [(k, t / n_steps, t / n_steps / max(busy, 1e-12), c)
             for k, t, c in by_stem(rows, full_names)]
    print(f"== top {TOP} {kind} by {what} over {n_steps} steps "
          f"(ms a step, share, launches recorded) ==")
    for name, ms, share, count in stems[:TOP]:
        print(f"{ms:9.4f} ms  {100 * share:5.1f}%  {count:6d}  {name[:100]}")
    s_ms = ssim_ms(h, dev, n_steps)
    print(f"SSIM forward + backward alone at {h} px: {s_ms:.3f} ms "
          f"{what} ({100 * s_ms / max(busy, 1e-12):.1f}% of the step's)",
          flush=True)
    return dict(wall_ms=walls, profiled_wall_ms=traced, busy_ms=busy,
                busy_share=busy / wall, rows=rows, stems=stems, ssim_ms=s_ms,
                ssim_share=s_ms / max(busy, 1e-12))


def main() -> dict:
    env = os.environ
    dev = bench.bench_device()
    trace_dir = env.get("PROFILE_DIR") or tempfile.mkdtemp(
        prefix="opensplat_prof_")
    os.makedirs(trace_dir, exist_ok=True)
    return anatomy(int(env.get("BENCH_POINTS", bench.HEADLINE[0])),
                   int(env.get("BENCH_RES", bench.HEADLINE[1])),
                   bench.bench_renderer(), dev, trace_dir,
                   full_names=bool(env.get("PROFILE_FULL_NAMES")))


if __name__ == "__main__":
    main()
