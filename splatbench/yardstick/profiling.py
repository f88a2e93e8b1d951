"""Device time by torch.profiler, free of the host's launch gaps: frozen
copies of the port's tools/profiling.py (`device_rows`, `stem`,
`by_stem`) and of tools/profile_step.py's SSIM-alone timer. The trace
can miss launches in back-to-back loops, so every time here is per
recorded launch, with the count beside it."""
from __future__ import annotations

import re
from collections import defaultdict

import torch


def device_rows(fn, n):
    """[(kernel name, device ms per recorded launch, launches recorded)]
    of n calls of `fn` under torch.profiler, by time per call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    rows = [(e.key, e.self_device_time_total / 1e3 / e.count, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    return sorted(rows, key=lambda r: -r[1] * r[2])


def stem(name: str) -> str:
    """A kernel's name without its template arguments and parameter list
    (up to its first '<' or '(' once "(anonymous namespace)::" is gone)
    and without a leading "void"."""
    name = name.replace("(anonymous namespace)::", "")
    name = re.split(r"[<(]", name, maxsplit=1)[0].strip()
    return name[5:] if name.startswith("void ") else name


def by_stem(rows):
    """Rows of (name, ms, count) summed by `stem`: [(stem, total ms,
    launches recorded)], by total time."""
    agg = defaultdict(lambda: [0.0, 0])
    for name, ms, count in rows:
        agg[stem(name)][0] += ms * count
        agg[stem(name)][1] += count
    return sorted(((k, t, c) for k, (t, c) in agg.items()),
                  key=lambda r: -r[1])


def ssim_device_ms(ssim, height: int, width: int, device, n: int,
                   seed: int = 0):
    """Device ms of one call of `ssim`'s forward and backward, (1 - ssim)
    on an (height, width, 3) image against another, over n calls after
    one warm-up; None when the trace recorded no kernel."""
    gen = torch.Generator(device=device).manual_seed(seed)
    gt = torch.rand((height, width, 3), generator=gen, device=device)
    img = torch.rand((height, width, 3), generator=gen, device=device,
                     requires_grad=True)

    def one():
        (1.0 - ssim(img, gt)).backward()

    one()
    rows = device_rows(one, n)
    if not rows:
        return None
    return sum(ms * c for _, ms, c in rows) / n
