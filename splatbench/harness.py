"""The benchmark of the port (opensplat_tpu_torch): one cell a process.

A cell (BENCHMARK.json `workloads`) names a configuration
(configs/<config>.json: the scene, the cameras and the training
settings) and a traffic mix (traffic/<mix>.json: which trainer of
TRAINERS, how many scenes a step trains, the first step, the checked
steps, the warm-up, the traced steps). Each metric the cell reports is
read by metrics/<name>.py, and the limits of its correctness check are
limits/<cell>.json. A configuration, a mix, a metric or a cell is added
as new files and BENCHMARK.json entries.

A run: the scenes on the device from the seed (scene s from seed + s;
the ground truth on the host), the program's trainer over them, the
checked steps, the warm-up, then `seconds` of run_step calls; with
--trace 1 a traced window follows. Then the program's state is freed
and the reference follows the checked steps, scene by scene
(correctness.py).
"""
from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from . import correctness
from .reference.render import render
from .reference.step import BETA1
from .scene import camera_poses, make_images, make_params
from .yardstick.counts import bound_seconds, raster_work
from .yardstick.peaks import peaks_for
from .yardstick.trace import Trace, load_trace

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "opensplat_tpu")


@dataclass
class Cell:
    name: str
    chips: int
    config: Dict
    traffic: Dict
    metrics: List[Dict]  # this cell's end-to-end and per-layer metrics
    limits: Dict[str, float]


def load_traffic(name: str) -> Dict:
    """The traffic mix traffic/<name>.json."""
    return json.loads((BENCH / "traffic" / f"{name}.json").read_text())


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell `name` of BENCHMARK.json with its files."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    work = next((w for w in bench["workloads"] if w["name"] == name), None)
    if work is None:
        raise SystemExit(f"splatbench: no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == work["config"])
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    reported = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if name in m.get("workloads", [name] if m["moves"] in reported
                              else [])]
    return Cell(
        name=name, chips=int(work["chips"]),
        config=json.loads((root / conf["file"]).read_text()),
        traffic=load_traffic(work["traffic"]),
        metrics=[dict(m, kind="end_to_end") for m in e2e]
        + [dict(m, kind="per_layer") for m in layer],
        limits=json.loads((BENCH / "limits" / f"{name}.json").read_text()))


class SceneCamera:
    """A training camera as the program's loaders give it: pose,
    intrinsics and get_image(factor), which counts its calls (each a
    ground-truth cache miss of the trainer and an upload)."""

    def __init__(self, pose, image, scene, counter):
        self.cam_to_world = pose
        self.fx, self.fy = float(scene["fx"]), float(scene["fy"])
        self.cx, self.cy = float(scene["cx"]), float(scene["cy"])
        self.width, self.height = int(scene["width"]), int(scene["height"])
        self.image = image
        self._counter = counter

    def get_image(self, factor: int = 1) -> np.ndarray:
        if factor != 1:
            raise ValueError("splatbench: the cells train at full "
                             f"resolution, not at 1/{factor}")
        self._counter[0] += 1
        return self.image


class RecordingSampler:
    """A trainer's camera sampler, wrapped: the indices it draws are
    kept until take() hands them over."""

    def __init__(self, inner):
        self._inner = inner
        self._drawn: List[int] = []

    def next(self) -> int:
        idx = self._inner.next()
        self._drawn.append(idx)
        return idx

    def take(self) -> List[int]:
        drawn, self._drawn = self._drawn, []
        return drawn

    def __getattr__(self, name):
        return getattr(self._inner, name)


@dataclass
class Scene:
    seed: int
    cams: List[SceneCamera]
    sampler: RecordingSampler  # the trainer's sampler of this scene


@dataclass
class Program:
    """The trainer under test over its scenes, and the count of ground
    truth uploads (get_image calls)."""
    trainer: object
    scenes: List[Scene]
    uploads: List[int]
    rows: int  # Gaussians a scene

    def step_cameras(self) -> tuple:
        """The camera index each scene drew since the last call: one a
        step, or the step is not the one the reference follows."""
        drawn = [sc.sampler.take() for sc in self.scenes]
        if any(len(d) != 1 for d in drawn):
            raise RuntimeError(f"splatbench: a step drew cameras {drawn}, "
                               "not one a scene")
        return tuple(d[0] for d in drawn)

    def scene_tensors(self, t: torch.Tensor, s: int) -> torch.Tensor:
        """Scene s's rows of a state leaf `t`: of a stacked state (a
        scene axis in front, rows padded to one capacity) t[s][:rows]."""
        stacked = self.trainer.state.params.means.dim() == 3
        return (t[s] if stacked else t)[:self.rows]


@dataclass
class Window:
    steps: int = 0
    scenes_per_step: int = 1
    seconds: float = 0.0
    setup_s: float = 0.0
    step_ms: List[float] = field(default_factory=list)
    uploads: int = 0
    peak_bytes: int = 0
    nonfinite: int = 0


class Marks:
    """Step ends on the device timeline (CUDA events, no synchronize),
    or on the host clock on the CPU."""

    def __init__(self, dev):
        self.cuda = dev.type == "cuda"
        self.marks = []

    def mark(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def intervals_ms(self) -> List[float]:
        m = self.marks
        if self.cuda:
            return [a.elapsed_time(b) for a, b in zip(m, m[1:])]
        return [(b - a) * 1e3 for a, b in zip(m, m[1:])]


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class Context:
    """What the metric readers read: the window, the trace, the work of
    the sampled traced steps, the card's peaks."""

    def __init__(self, cell, window, dev, kind, trace=None, work=(),
                 program_ssim=None):
        self.cell, self.window, self.device = cell, window, dev
        self.scene = cell.config["scene"]
        self.trace: Optional[Trace] = trace
        self.peaks = peaks_for(kind)
        self.program_ssim = program_ssim
        self.work = list(work)  # the sampled traced steps: {"step",
        # "views": the work of each scene's view}

    @property
    def on_card(self) -> bool:
        """Device metrics are read on a card only, never on the CPU."""
        return self.device.type == "cuda"

    @property
    def steps_per_s(self) -> float:
        w = self.window
        return w.steps * w.scenes_per_step / w.seconds

    def kernel_roofline(self, kernel_stem: str, key: str) -> Optional[float]:
        """% of the roofline of `kernel_stem` over the sampled steps whose
        launches the trace recorded: their bounds over their device
        time."""
        if not self.on_card or self.trace is None or self.peaks is None:
            return None
        bound = spent = 0.0
        for w in self.work:
            secs = self.trace.kernel_seconds(kernel_stem, w["step"])
            if secs:  # a launch serves all the step's views
                per_view = [raster_work(v)[key] for v in w["views"]]
                bound += bound_seconds(sum(b for b, _ in per_view),
                                       sum(o for _, o in per_view),
                                       self.peaks)
                spent += sum(secs)
        return 100.0 * bound / spent if spent > 0 else None


def program():
    """The system under test: the port's Trainer and its state types."""
    from opensplat_tpu_torch.config import TrainConfig
    from opensplat_tpu_torch.models.gaussians import (GaussianParams,
                                                      TrainState, zero_stats)
    from opensplat_tpu_torch.ops.ssim import ssim
    from opensplat_tpu_torch.optim.adam import adam_init
    from opensplat_tpu_torch.train import Trainer
    return dict(TrainConfig=TrainConfig, GaussianParams=GaussianParams,
                TrainState=TrainState, zero_stats=zero_stats, ssim=ssim,
                adam_init=adam_init, Trainer=Trainer)


def _single(states, cams, cfg, dev, prog):
    """Trainer.run_step (train.py), one scene a step, as cli.py trains."""
    if len(states) != 1:
        raise ValueError("splatbench: Trainer trains one scene")
    trainer = prog["Trainer"](states[0], cams[0], cfg, renderer="fast",
                              device=dev)
    return trainer, [trainer]


def _multi(states, cams, cfg, dev, prog):
    """MultiSceneTrainer.run_step (parallel/multi_scene.py): the scenes
    in one batched step, as multi_scene_cli.py trains them."""
    from opensplat_tpu_torch.parallel.multi_scene import MultiSceneTrainer
    trainer = MultiSceneTrainer(states, cams, cfg, renderer="fast",
                                device=dev)
    return trainer, trainer.children


# traffic's "trainer" -> builder(states, cameras per scene, cfg, device,
# program) -> (the trainer, the objects whose `sampler` draws each
# scene's cameras, in scene order)
TRAINERS = {"Trainer": _single, "MultiSceneTrainer": _multi}


def build(cell: Cell, seed: int, dev, prog) -> Program:
    """The trainer of the cell's traffic over its scenes at `seed`."""
    scene, train = cell.config["scene"], cell.config["train"]
    builder = TRAINERS.get(cell.traffic["trainer"])
    if builder is None:
        raise ValueError(f"splatbench: trainer {cell.traffic['trainer']!r} "
                         f"is none of {sorted(TRAINERS)}")
    poses = camera_poses(scene)
    uploads = [0]
    seeds = [seed + s for s in range(int(cell.traffic.get("scenes", 1)))]
    states, cams = [], []
    for sd in seeds:
        params = make_params(scene, sd, dev)
        images = make_images(scene, poses, sd, train["background"], dev)
        cams.append([SceneCamera(p, im, scene, uploads)
                     for p, im in zip(poses, images)])
        n = params["means"].shape[0]
        states.append(prog["TrainState"](
            params=prog["GaussianParams"](**params),
            alive=torch.ones(n, dtype=torch.bool, device=dev),
            opt=prog["adam_init"](params), stats=prog["zero_stats"](n, dev)))
    fields = prog["TrainConfig"].__dataclass_fields__
    cfg = prog["TrainConfig"](**{k: v for k, v in train.items()
                                 if k in fields}, seed=seed)
    trainer, owners = builder(states, cams, cfg, dev, prog)
    del states
    scenes = []
    for sd, cs, owner in zip(seeds, cams, owners):
        owner.sampler = RecordingSampler(owner.sampler)
        scenes.append(Scene(sd, cs, owner.sampler))
    return Program(trainer, scenes, uploads, int(scene["n_gaussians"]))


def checked_steps(run: Program, first_step: int, n: int):
    """Run the first `n` steps; returns (the program's readings without
    the change norms, [(camera index of each scene, step)], each scene's
    parameters after them on the host)."""
    readings = correctness.Readings()
    views = []
    for i in range(n):
        out = run.trainer.run_step(first_step + i)
        views.append((run.step_cameras(), first_step + i))
        m = out.metrics
        readings.losses += [float(x) for x in
                            m.get("loss_per_scene", m["loss"]).reshape(-1)]
        readings.psnrs.append(float(m["psnr"]))
        if i == 0:
            mu = run.trainer.state.opt.mu
            readings.first_grads = [
                {k: run.scene_tensors(mu[k], s).detach().to("cpu")
                 / (1.0 - BETA1) for k in correctness.PARAMS}
                for s in range(len(run.scenes))]
            readings.grad_norms = [
                {k: correctness.leaf_norm(g[k]) for k in correctness.PARAMS}
                for g in readings.first_grads]
    for s in range(len(run.scenes)):
        if len({c[s] for c, _ in views}) != n:
            raise RuntimeError("splatbench: the checked steps repeat a "
                               "camera")
    params = run.trainer.state.params.as_dict()
    after = [{k: run.scene_tensors(v, s).detach().to("cpu", copy=True)
              for k, v in params.items()}
             for s in range(len(run.scenes))]
    return readings, views, after


class HostWatch:
    """What the host did over the window, printed to tell a slow run's
    cause: the process's and the main thread's CPU time, the garbage
    collector's passes and time, and the host's time between
    consecutive step ends."""

    def __init__(self):
        self.gc_passes = [0, 0, 0]
        self.gc_s = 0.0
        self._gc_t = 0.0
        self.ends: List[float] = []

    @staticmethod
    def _now() -> Dict[str, float]:
        return {"cpu_s": time.process_time(),
                "thread_cpu_s": time.thread_time()}

    def _gc(self, phase, info):
        if phase == "start":
            self._gc_t = time.perf_counter()
        else:
            self.gc_passes[info["generation"]] += 1
            self.gc_s += time.perf_counter() - self._gc_t

    def __enter__(self):
        self._start = self._now()
        gc.callbacks.append(self._gc)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self._gc)
        end = self._now()
        self.used = {k: end[k] - self._start[k] for k in end}

    def line(self, wall_s: float) -> str:
        gaps = [1e3 * (b - a) for a, b in zip(self.ends, self.ends[1:])]
        med = statistics.median(gaps) if gaps else math.nan
        slow = [g for g in gaps if g > 3.0 * med]
        q = (statistics.quantiles(gaps, n=20) if len(gaps) > 1
             else [math.nan] * 19)
        u = self.used
        return (f"host: wall {wall_s:.3f} s, process cpu "
                f"{u['cpu_s']:.3f} s, main thread cpu "
                f"{u['thread_cpu_s']:.3f} s; gc passes "
                f"{self.gc_passes} in {self.gc_s:.4f} s; host ms between "
                f"step ends p50 {med:.3f} p95 {q[18]:.3f} max "
                f"{max(gaps, default=math.nan):.3f}, {len(slow)} over 3x "
                f"the median ({sum(slow) - len(slow) * med:.1f} ms more)")


def run_window(job: Program, step: int, seconds: float, dev,
               t0: float) -> Window:
    """run_step calls for `seconds`, from the first call to a synchronize
    after the last."""
    marks, losses, isects = Marks(dev), [], []
    uploads0 = job.uploads[0]
    sync(dev)
    with HostWatch() as host:
        t_first = time.perf_counter()
        marks.mark()
        n = 0
        while True:
            out = job.trainer.run_step(step + n)
            n += 1
            marks.mark()
            losses.append(out.metrics["loss"])
            isects.append(out.metrics["n_isects"])
            t = time.perf_counter()
            host.ends.append(t)
            if t - t_first >= seconds:
                break
        sync(dev)
        t_end = time.perf_counter()
    for sc in job.scenes:
        sc.sampler.take()
    step_ms = marks.intervals_ms()
    half = len(step_ms) // 2
    if half:
        rate = [1e3 * len(p) / sum(p)
                for p in (step_ms[:half], step_ms[half:])]
        work = [float(torch.stack(p).double().mean())
                for p in (isects[:half], isects[half:])]
        print(f"stationarity: steps/s {rate[0]:.4f} in the first half, "
              f"{rate[1]:.4f} in the second; n_isects a step {work[0]:.1f} "
              f"and {work[1]:.1f}", file=sys.stderr)
    print(host.line(t_end - t_first), file=sys.stderr)
    return Window(
        steps=n, scenes_per_step=len(job.scenes), seconds=t_end - t_first,
        setup_s=t_first - t0, step_ms=step_ms,
        uploads=job.uploads[0] - uploads0,
        nonfinite=int(sum(not math.isfinite(float(x)) for x in losses)),
        peak_bytes=(torch.cuda.max_memory_allocated()
                    if dev.type == "cuda" else 0))


def traced_window(job: Program, step: int, n: int, dev):
    """n steps under torch.profiler tracing the device alone (no host
    operator is recorded, so the host issues at its own pace), with the
    trace's marker kernel before the first step and after each. Returns
    (trace, the camera index of each scene at each traced step)."""
    from torch.profiler import ProfilerActivity, profile

    cameras = []
    sync(dev)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(0)
        for i in range(n):
            job.trainer.run_step(step + i)
            torch.cuda._sleep(0)
            cameras.append(job.step_cameras())
        sync(dev)
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        trace = load_trace(path)
    finally:
        os.unlink(path)
    return trace, cameras


@torch.no_grad()
def step_work(params, alive, cam, background, dev) -> Dict:
    """The work (yardstick/counts.py) of one view of a step, from the
    benchmark's own plain forward."""
    _, raster, _ = render(params, alive, cam,
                          torch.tensor(background, device=dev),
                          count_work=True)
    return dict(raster.work, height=cam.height, width=cam.width,
                alive=int(alive.sum()),
                params_per_gaussian=sum(v[0].numel()
                                        for v in params.values()))


def traced_work(job: Program, cameras, steps, background, dev) -> List[Dict]:
    """[{"step", "views": the work of each scene's view}] of the traced
    steps `steps`, counted on the state after the window (a dozen steps
    later: n_isects moves ~0.005% a step)."""
    state = job.trainer.state
    params = {k: v.detach() for k, v in state.params.as_dict().items()}
    out = []
    for i in steps:
        views = []
        for s, c in enumerate(cameras[i]):
            views.append(step_work(
                {k: job.scene_tensors(v, s) for k, v in params.items()},
                job.scene_tensors(state.alive, s),
                correctness.to_camera(job.scenes[s].cams[c]), background,
                dev))
        out.append({"step": i, "views": views})
    return out


def load_reader(name: str):
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "splatbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def device_info(dev, chips: int) -> Dict:
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
            "count": chips}
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()
        info["power_limit"] = smi[dev.index or 0].strip()
    except (OSError, subprocess.SubprocessError, IndexError):
        pass
    return info


def run(cell: Cell, seed: int, seconds: float, trace: bool, dev,
        t0: float) -> Dict:
    """One run of `cell`; returns the result's line as a dict."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        torch.cuda.reset_peak_memory_stats()
    prog = program()
    traffic = cell.traffic
    job = build(cell, seed, dev, prog)
    step = int(traffic["first_step"])
    n_check = int(traffic["checked_steps"])
    readings, views, after = checked_steps(job, step, n_check)
    step += n_check
    n_cams = len(job.scenes[0].cams)
    warm = max(0, math.ceil(traffic["warmup_epochs"] * n_cams) - n_check)
    for i in range(warm):
        job.trainer.run_step(step + i)
    step += warm
    for sc in job.scenes:
        sc.sampler.take()
    window = run_window(job, step, seconds, dev, t0)
    step += window.steps
    device = dict(device_info(dev, cell.chips),
                  memory_peak_bytes=window.peak_bytes)

    kind = "per_layer" if trace else "end_to_end"
    readers = [m for m in cell.metrics if m["kind"] == kind]
    tr, work, breakdown = None, [], None
    if trace and dev.type == "cuda":
        n_traced = int(traffic["trace_steps"])
        tr, cameras = traced_window(job, step, n_traced, dev)
        device["busy_s"] = tr.busy_s()
        device["window_s"] = tr.window_s
        print(f"trace: {1e3 * tr.window_s / n_traced:.3f} ms a step on the "
              f"device's timeline traced, "
              f"{statistics.fmean(window.step_ms):.3f} untraced; device "
              f"busy {1e3 * tr.busy_s() / n_traced:.3f} ms a step, idle "
              f"{100.0 * (1.0 - tr.busy_s() / tr.window_s):.2f}% of the "
              f"traced window", file=sys.stderr)
        breakdown = {"device_ops": [list(r) for r in
                                    tr.device_by_stem()[:10]],
                     "idle_gaps": [list(r) for r in
                                   tr.idle_by_neighbours()[:10]]}
        # the sampled steps: the first traced steps the trace recorded a
        # kernel of
        recorded = sorted({o.step for o in tr.ops if o.step is not None})
        work = traced_work(job, cameras,
                           recorded[:int(traffic["trace_samples"])],
                           cell.config["train"]["background"], dev)
    job.trainer = None  # the program's state and GT cache go with it
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    ctx = Context(cell, window, dev, device["kind"], tr, work, prog["ssim"])
    metrics = {}
    for m in readers:
        value = load_reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    del ctx

    checks, correct = check(cell, dev, readings, views, after, job)
    out = {"correct": correct and window.nonfinite == 0,
           "attempted": window.steps * window.scenes_per_step,
           "failed": window.nonfinite * window.scenes_per_step,
           "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return out


def reference_scenes(cell: Cell, job: Program, dev, views):
    """What the reference starts from, scene by scene: (the initial
    parameters made again from the scene's seed, the alive mask, the
    checked views [(Camera, ground truth on the device, step)])."""
    for s, sc in enumerate(job.scenes):
        params0 = make_params(cell.config["scene"], sc.seed, dev)
        alive = torch.ones(params0["means"].shape[0], dtype=torch.bool,
                           device=dev)
        yield params0, alive, [
            (correctness.to_camera(sc.cams[c[s]]),
             torch.from_numpy(sc.cams[c[s]].image).to(dev), step)
            for c, step in views]
        del params0


def program_changes(cell: Cell, job: Program, dev, readings, after):
    """Fill the program's change norms: each scene's parameters after the
    checked steps (`after`, on the host) from its initial ones."""
    readings.change_norms = []
    for s, sc in enumerate(job.scenes):
        params0 = make_params(cell.config["scene"], sc.seed, dev)
        readings.change_norms.append(
            {k: correctness.leaf_norm(after[s][k], params0[k])
             for k in correctness.PARAMS})
        del params0


def check(cell, dev, readings, views, after, job):
    """The reference's steps over the checked views, the gaps and their
    limits: ({name: {"value", "limit"}}, all within)."""
    program_changes(cell, job, dev, readings, after)
    ref = correctness.reference_readings(
        reference_scenes(cell, job, dev, views), cell.config["train"])
    gaps = correctness.compare(readings, ref)
    checks = {k: {"value": gaps[k], "limit": float(cell.limits[k])}
              for k in correctness.NUMBERS}
    for k, c in checks.items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    return checks, all(c["value"] <= c["limit"] for c in checks.values())


def forbidden_modules() -> List[str]:
    return sorted({n.split(".")[0] for n in sys.modules}
                  & set(FORBIDDEN))


def main(argv, t0: float) -> int:
    ap = argparse.ArgumentParser(prog="splatbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = load_cell(args.workload)
    if not torch.cuda.is_available():
        print("splatbench: no CUDA device; the benchmark runs on the card "
              "only", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"splatbench: {args.workload} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    result = run(cell, args.seed, args.seconds, bool(args.trace),
                 torch.device("cuda", 0), t0)
    found = forbidden_modules()
    if found:
        print(f"splatbench: modules loaded that the port must not use: "
              f"{found}", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    return 0
