"""Device time of CUDA work by torch.profiler, free of the host's
launch gaps: what chip_smoke.py, the ablation bench and the step
profiler read beside their CUDA-event times."""
from __future__ import annotations

import re
from collections import defaultdict

import torch


def device_rows(fn, n, device="cuda", trace=None):
    """[(kernel name, device ms per recorded launch, launches recorded)]
    of n calls of `fn` under torch.profiler, by time per call: each
    kernel's own duration on the card, free of the host's launch gaps.
    On the CPU (`device`) the trace holds no device: the rows are then
    the operators' own (self) CPU time. `trace`: a path for the Chrome
    trace."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.device(device).type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    if cuda:
        torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        for _ in range(n):
            fn()
        if cuda:
            torch.cuda.synchronize()
    if trace:
        prof.export_chrome_trace(trace)
    # kernels only: an operator's row repeats its kernels' device time.
    # Times are per recorded launch: the trace has missed launches in
    # back-to-back loops, so callers print the recorded count beside them
    if cuda:
        rows = [(e.key, e.self_device_time_total / 1e3 / e.count, e.count)
                for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA
                and e.self_device_time_total > 0]
    else:
        rows = [(e.key, e.self_cpu_time_total / 1e3 / e.count, e.count)
                for e in prof.key_averages() if e.self_cpu_time_total > 0]
    return sorted(rows, key=lambda r: -r[1] * r[2])


def stem(name: str) -> str:
    """A kernel's name without its template arguments and parameter list
    (up to its first '<' or '(' once "(anonymous namespace)::" is gone,
    which the port's kernels and many of PyTorch's carry), and without
    a leading "void"."""
    name = name.replace("(anonymous namespace)::", "")
    name = re.split(r"[<(]", name, maxsplit=1)[0].strip()
    return name[5:] if name.startswith("void ") else name


def by_stem(rows, full_names=False):
    """device_rows' rows summed by name stem (`stem`: a kernel's template
    instances fall together; the whole name with full_names): [(stem,
    total ms, launches recorded)], by total time."""
    agg = defaultdict(lambda: [0.0, 0])
    for name, ms, count in rows:
        stem_ = name if full_names else stem(name)
        agg[stem_][0] += ms * count
        agg[stem_][1] += count
    return sorted(((k, t, c) for k, (t, c) in agg.items()),
                  key=lambda r: -r[1])


def device_ms(fn, reps, kernel=None):
    """(device ms per call of `fn`, launches recorded) by torch.profiler
    over `reps` calls after one warm-up: the kernels whose name holds
    `kernel`, or all it launches, each at its time per recorded launch
    times its launches per call. (None, 0) if the trace recorded none."""
    fn()
    rows = [r for r in device_rows(fn, reps)
            if kernel is None or kernel in r[0]]
    if not rows:
        return None, 0
    return (sum(t * max(1, round(k / reps)) for _, t, k in rows),
            sum(k for _, _, k in rows))
