"""Device time of CUDA work by torch.profiler, free of the host's
launch gaps: what chip_smoke.py and the ablation bench read beside their
CUDA-event times."""
from __future__ import annotations

import torch


def device_rows(fn, n):
    """[(kernel name, device ms per recorded launch, launches recorded)]
    of n calls of `fn` under torch.profiler, by time per call: each
    kernel's own duration on the card, free of the host's launch gaps."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    # kernels only: an operator's row repeats its kernels' device time.
    # Times are per recorded launch: the trace has missed launches in
    # back-to-back loops, so callers print the recorded count beside them
    rows = [(e.key, e.self_device_time_total / 1e3 / e.count, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    return sorted(rows, key=lambda r: -r[1] * r[2])


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
