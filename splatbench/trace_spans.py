"""The program's spans and counters over a cell's windows, on the device
trace's clock: what the per-layer metrics of the Trainer, Step and
Optimizer layers read, before the harness reads them itself.

    python3 splatbench/trace_spans.py --workload <cell> --seed <n> \
        [--seconds 25] [--steps 12] [--sync-steps 20] [--out FILE]

from the root of a checkout, on a card. As run.py it builds the cell's
scenes and trainer and runs the warm-up epoch; then

1. an untraced window of `seconds` with the tracer off, the program's
   counters taken at its edges (host_syncs by site a step; the GT
   cache's misses, hit rate and upload bytes a scene-step), and one
   with the tracer on (its cost when nothing exports);
2. two traced windows of `steps` steps (harness.traced_window's
   markers, CUDA activity alone), the tracer off and on; the second
   puts each device operation and idle gap down to a span
   (yardstick/spans.py), with the host clock read just before the first
   marker's launch, and ends with the alignment probe: after a
   synchronize, torch.cuda._sleep(N) in a span, whose start is compared
   with the kernel's launch event;
3. `sync-steps` steps under torch.cuda.set_sync_debug_mode("warn"):
   the synchronizing operations that CUDA reports a step
   (step.host_syncs_per_step), against the program's host_syncs, its
   breakdown by site, over the same steps.

Prints one JSON line (and writes it to --out). No correctness check.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import threading  # noqa: E402
import traceback  # noqa: E402
import warnings  # noqa: E402
from collections import Counter  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from splatbench import harness  # noqa: E402
from splatbench.yardstick import spans as sp  # noqa: E402


def counted(c0, c1, key):
    return c1.get(key, 0) - c0.get(key, 0)


def window(job, step, seconds, dev, tracer, on):
    """harness.run_window with the tracer on or off; (window, the
    counters it added, its spans)."""
    c0 = tracer.counts()
    tracer.take_spans()
    with tracer.tracing(on):
        w = harness.run_window(job, step, seconds, dev, T0)
    c1 = tracer.counts()
    return (w, {k: counted(c0, c1, k) for k in c1 if counted(c0, c1, k)},
            tracer.take_spans())


def traced(job, step, n, dev, tracer, on, probe_cycles=1_000_000):
    """n steps under torch.profiler (CUDA activity), markers as in
    harness.traced_window, the tracer on or off; returns (timeline, the
    spans, the host clock before each marker's launch, host ms a step
    from the first marker to the synchronize after the last)."""
    from torch.profiler import ProfilerActivity, profile

    tracer.take_spans()
    harness.sync(dev)
    t_marks = []
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        with tracer.tracing(on):
            t_marks.append(time.perf_counter_ns())
            torch.cuda._sleep(0)
            for i in range(n):
                job.trainer.run_step(step + i)
                t_marks.append(time.perf_counter_ns())
                torch.cuda._sleep(0)
                job.step_cameras()
            harness.sync(dev)
            wall_ms = (time.perf_counter_ns() - t_marks[0]) / 1e6 / n
            with tracer.tracing(True), tracer.span("probe.sleep"):
                torch.cuda._sleep(probe_cycles)
            harness.sync(dev)
    spans = tracer.take_spans()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        tl = sp.load_timeline(path)
    finally:
        os.unlink(path)
    return tl, spans, t_marks, wall_ms


def sync_check(job, step, n, tracer):
    """n steps with CUDA's sync debug mode warning: (the synchronizing
    operations it reported, the program's host_syncs, the reports by
    the program's line that made them, the program's by site, other
    warnings, such as the mode's own notice)."""
    sites, other = Counter(), Counter()

    def hook(message, category, filename, lineno, file=None, line=None):
        if "synchronizing CUDA operation" not in str(message):
            other[str(message)[:160]] += 1
            return
        stack = traceback.extract_stack()[:-1]
        frames = [f for f in stack if f.filename.startswith(ROOT)
                  and "splatbench" not in f.filename]
        if frames:
            f = frames[-1]
            sites[f"{os.path.relpath(f.filename, ROOT)}:{f.lineno}"] += 1
        else:  # not the program's: where it came from
            sites["outside: " + " <- ".join(
                f"{os.path.basename(f.filename)}:{f.lineno}:{f.name}"
                for f in reversed(stack[-4:]))
                  + f" [{threading.current_thread().name}] {message}"] += 1

    c0 = tracer.counts()
    old = warnings.showwarning
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = hook
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for i in range(n):
                job.trainer.run_step(step + i)
                job.step_cameras()
        finally:
            torch.cuda.set_sync_debug_mode(0)
            warnings.showwarning = old
    c1 = tracer.counts()
    by_site = {k[len("host_syncs."):]: counted(c0, c1, k) for k in c1
               if k.startswith("host_syncs.") and counted(c0, c1, k)}
    return (sum(sites.values()), counted(c0, c1, "host_syncs"),
            dict(sites.most_common()), by_site, dict(other))


def span_host_ms(spans, steps):
    """The host's ms a step in the spans of each name."""
    by_name = Counter()
    for s in spans:
        by_name[s.name] += (s.end_ns - s.start_ns) / 1e6 / steps
    return dict(by_name.most_common())


def main(argv):
    ap = argparse.ArgumentParser(prog="splatbench/trace_spans.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=25.0)
    ap.add_argument("--steps", type=int, default=12)
    ap.add_argument("--sync-steps", type=int, default=20)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("trace_spans: no CUDA device; it runs on the card only",
              file=sys.stderr)
        return 2
    from opensplat_tpu_torch.utils import metrics as tracer

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(dev)
    cell = harness.load_cell(args.workload)
    job = harness.build(cell, args.seed, dev, harness.program())
    traffic = cell.traffic
    step = int(traffic["first_step"])
    n_cams = len(job.scenes[0].cams)
    for i in range(math.ceil(traffic["warmup_epochs"] * n_cams)):
        job.trainer.run_step(step + i)
    step += math.ceil(traffic["warmup_epochs"] * n_cams)
    for sc in job.scenes:
        sc.sampler.take()
    out = {"workload": args.workload, "seed": args.seed,
           "device": harness.device_info(dev, cell.chips)}

    # 1. untraced windows, the tracer off, on, on, off
    runs = []
    for on in (False, True, True, False):
        runs.append((on,) + window(job, step, args.seconds, dev, tracer, on))
        step += runs[-1][1].steps
    rate = lambda w: w.steps * w.scenes_per_step / w.seconds  # noqa: E731
    w_off, c_off = runs[0][1], runs[0][2]
    on_spans = runs[1][3]
    out["untraced"] = {
        "steps_per_s_tracer_off": [rate(r[1]) for r in runs if not r[0]],
        "steps_per_s_tracer_on": [rate(r[1]) for r in runs if r[0]],
        "step_ms_mean_off": [statistics.fmean(r[1].step_ms) for r in runs
                             if not r[0]],
        "step_ms_mean_on": [statistics.fmean(r[1].step_ms) for r in runs
                            if r[0]],
        "trainer.host_ms": sp.host_ms(on_spans, "trainer.run_step", "step"),
        "step.host_ms": sp.host_ms(on_spans, "step"),
        "span_host_ms": span_host_ms(on_spans, runs[1][1].steps),
        "steps": w_off.steps,
        "program_host_syncs_per_step": c_off.get("host_syncs", 0)
        / c_off["trainer.steps"],
        "host_syncs_by_site_per_step": {
            k[len("host_syncs."):]: v / c_off["trainer.steps"]
            for k, v in sorted(c_off.items())
            if k.startswith("host_syncs.")},
        "trainer.gt_misses_per_step": c_off.get("gt.misses", 0)
        / c_off["trainer.scene_steps"],
        "gt_hit_rate": c_off.get("gt.hits", 0)
        / max(1, c_off.get("gt.hits", 0) + c_off.get("gt.misses", 0)),
        "gt_upload_bytes_per_step": c_off.get("gt.upload_bytes", 0)
        / c_off["trainer.scene_steps"],
        "gt_uploads_per_step_by_cameras": w_off.uploads
        / (w_off.steps * w_off.scenes_per_step),
    }

    # 2. traced windows, the tracer off then on
    _, _, _, wall_off = traced(job, step, args.steps, dev, tracer, False)
    step += args.steps
    tl, spans, t_marks, wall_on = traced(job, step, args.steps, dev,
                                         tracer, True)
    step += args.steps
    tl, probe = sp.without_last_marker(tl)
    off, how = sp.offset_us(tl, t_marks)
    latency = sp.launch_latency_us(tl)
    first_off, _ = sp.offset_us(tl, t_marks[:1])
    trace, att = sp.attribute_window(tl, [s for s in spans
                                          if s.name != "probe.sleep"],
                                     off, latency, args.steps)
    probe_span = next(s for s in spans if s.name == "probe.sleep")
    probe_launch = tl.launches.get(probe[3])
    out["alignment"] = {
        "offset_from": how, "marker_launch_latency_us": latency,
        "first_marker_offset_minus_median_us": first_off - off,
        "probe_launch_minus_span_start_us":
            None if probe_launch is None
            else probe_launch.ts - (probe_span.start_ns / 1e3 + off),
        "probe_kernel_start_minus_span_start_us":
            probe[1] - (probe_span.start_ns / 1e3 + off),
        "launch_events": len(tl.launches),
        "ops_with_launch": sum(1 for d in tl.device
                               if d[3] in tl.launches),
        "ops": len(tl.device),
    }
    named = [s for s in spans if s.name != "probe.sleep"]
    out["traced"] = {
        "host_ms_a_step_tracer_off": wall_off,
        "host_ms_a_step_tracer_on": wall_on,
        "markers_in_trace": trace.steps + 1,
        "device_busy_ms_a_step": 1e3 * trace.busy_s() / args.steps,
        "window_ms_a_step": 1e3 * trace.window_s / args.steps,
        "trainer.host_ms": sp.host_ms(named, "trainer.run_step", "step"),
        "step.host_ms": sp.host_ms(named, "step"),
        "adam.device_ms": dict(att.span_device_ms(100)).get("step.adam"),
        "named_idle_share": att.named_idle_share(),
        "spans_a_step": len(named) / args.steps,
    }
    out["breakdown"] = {
        "idle_gaps": [list(r) for r in att.idle_gaps()],
        "idle_gaps_by_ops": [list(r) for r in
                             trace.idle_by_neighbours()[:10]],
        "span_device_ms": [list(r) for r in att.span_device_ms()],
        "idle_ms_a_step_by_span": [[k, 1e3 * v / args.steps]
                                   for k, v in att.idle_gaps(100)],
        "span_device_ms_all": [list(r) for r in att.span_device_ms(100)],
        "device_ops": [list(r) for r in trace.device_by_stem()[:10]],
    }
    out["span_host_ms"] = span_host_ms(named, args.steps)

    # 3. CUDA's count of synchronizing operations against the program's
    cuda_n, prog_n, sites, by_site, other = sync_check(
        job, step, args.sync_steps, tracer)
    out["sync_check"] = {"steps": args.sync_steps, "cuda_reported": cuda_n,
                         "step.host_syncs_per_step": cuda_n
                         / args.sync_steps,
                         "program_host_syncs": prog_n,
                         "cuda_by_line": sites, "program_by_site": by_site,
                         "other_warnings": other}
    line = json.dumps(out)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
