"""Reduction of a torch.profiler Chrome trace of the device alone (CUDA
activity) to what the per-layer metrics read. The harness launches a
marker kernel (torch.cuda._sleep(0), `spin_kernel`) before the first
traced step and after each, on the stream the steps run on, so on the
device's timeline step i's operations lie between markers i and i + 1
and the window runs from the first marker's end to the last one's
start. From that: the device's operations and their union, the idle
gaps named by the operations on either side, and each operation's step.
"""
from __future__ import annotations

import bisect
import json
from collections import defaultdict
from dataclasses import dataclass
from typing import List, Optional, Tuple

from .profiling import stem

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
MARKER = "spin_kernel"


@dataclass
class DeviceOp:
    name: str
    start: float  # microseconds on the trace's clock
    end: float
    step: Optional[int]  # index of the traced step it belongs to


@dataclass
class Trace:
    window: Tuple[float, float]
    ops: List[DeviceOp]  # the markers left out
    steps: int  # traced steps: markers less one

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    def _inside(self) -> List[DeviceOp]:
        lo, hi = self.window
        return sorted((o for o in self.ops if o.end > lo and o.start < hi),
                      key=lambda o: o.start)

    def busy_intervals(self) -> List[Tuple[float, float]]:
        """The union of the device operations' intervals inside the
        window, sorted and disjoint."""
        lo, hi = self.window
        out: List[List[float]] = []
        for o in self._inside():
            s, e = max(o.start, lo), min(o.end, hi)
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e6

    def gaps(self) -> List[Tuple[float, float, str]]:
        """The window's intervals in which no device operation runs, each
        named "<stem of the operation before> -> <stem of the one
        after>" ("window" at either end)."""
        out, t, last = [], self.window[0], "window"
        for o in self._inside():
            if o.start > t:
                out.append((t, o.start, f"{last} -> {stem(o.name)}"))
            if o.end >= t:
                t, last = o.end, stem(o.name)
        if self.window[1] > t:
            out.append((t, self.window[1], f"{last} -> window"))
        return out

    def idle_by_neighbours(self) -> List[Tuple[str, float]]:
        """Idle seconds summed by the gaps' names, longest first."""
        agg = defaultdict(float)
        for s, e, name in self.gaps():
            agg[name] += (e - s) / 1e6
        return sorted(agg.items(), key=lambda kv: -kv[1])

    def device_by_stem(self) -> List[Tuple[str, float]]:
        """Device seconds inside the window summed by kernel stem."""
        agg = defaultdict(float)
        lo, hi = self.window
        for o in self.ops:
            agg[stem(o.name)] += max(0.0, min(o.end, hi) - max(o.start, lo)) / 1e6
        return sorted(agg.items(), key=lambda kv: -kv[1])

    def kernel_seconds(self, kernel_stem: str, step: int) -> List[float]:
        """Durations (s) of the recorded launches of `kernel_stem` that
        step `step` made."""
        return [(o.end - o.start) / 1e6 for o in self.ops
                if o.step == step and stem(o.name) == kernel_stem]


def load_trace(path: str) -> Trace:
    """Parse the Chrome trace that torch.profiler exported to `path`."""
    with open(path) as f:
        events = json.load(f)
    if isinstance(events, dict):
        events = events.get("traceEvents", [])
    device = [(ev.get("name", ""), float(ev.get("ts", 0.0)),
               float(ev.get("ts", 0.0)) + float(ev.get("dur", 0.0)))
              for ev in events
              if ev.get("ph") == "X" and ev.get("cat", "") in DEVICE_CATS]
    return from_device_ops(device, path)


def is_marker(name: str) -> bool:
    """The marker kernel, in whatever namespace the trace names it."""
    return stem(name).rsplit("::", 1)[-1] == MARKER


def from_device_ops(device, where: str = "trace") -> Trace:
    """The Trace of device operations [(name, start, end)], markers
    among them."""
    markers = sorted((s, e) for n, s, e in device if is_marker(n))
    if len(markers) < 2:
        raise RuntimeError(f"{where}: {len(markers)} {MARKER} markers, "
                           "the traced window needs two or more")
    ends = [e for _, e in markers]

    def step_of(start):
        i = bisect.bisect_right(ends, start) - 1
        return i if 0 <= i < len(markers) - 1 and \
            start < markers[i + 1][0] else None

    ops = [DeviceOp(n, s, e, step_of(s)) for n, s, e in device
           if not is_marker(n)]
    return Trace(window=(markers[0][1], markers[-1][0]), ops=ops,
                 steps=len(markers) - 1)
