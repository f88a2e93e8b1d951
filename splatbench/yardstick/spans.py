"""The program's spans (opensplat_tpu_torch.utils.metrics) on the device
trace's clock: which span launched each device operation, which span the
device waited for in each idle gap, and the host's time a step in the
Trainer and the Step layers.

The spans are on time.perf_counter_ns(); a torch.profiler Chrome trace
of CUDA activity is on Kineto's clock, in microseconds, and holds for
each kernel, copy and memset the runtime call that launched it
(`cuda_runtime` or `cuda_driver` events, the same `correlation` id in
both). The offset between the clocks comes from the traced window's
markers (harness.traced_window's torch.cuda._sleep(0), the first
launched right after a synchronize) and the host clock read just before
each launch: the median of launch time less read over the pairs that
agree within `PAIR_US`. Pairs are found by their agreement, not by
position, as the trace can drop a marker's kernel. Without launch
events: the first marker's device start less `LAUNCH_US`, less its
read.

Attribution: a device operation belongs to the innermost span open at
its launch on the launching thread; a launch from a thread that opened
no span (autograd's engine thread runs the backward on the card) to the
innermost span of the main thread (the thread of the root spans) open
then. An operation whose launch the trace lacks belongs to the
innermost main-thread span open at its device start less the marker's
launch latency. An idle gap belongs to the span of the operation after
it: the launch the device waited for. Where no span was open the name
is "outside:<stem of the operation>".
"""
from __future__ import annotations

import bisect
import json
import statistics
from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from .profiling import stem
from .trace import DEVICE_CATS, Trace, from_device_ops, is_marker

RUNTIME_CATS = ("cuda_runtime", "cuda_driver")
LAUNCH_US = 5.0  # launch-to-start of a kernel on an idle card, no event
PAIR_US = 100.0  # a read and its launch agree to this; steps are ms apart


@dataclass
class Launch:
    ts: float  # microseconds on the trace's clock
    tid: int


@dataclass
class Timeline:
    """A trace's device operations [(name, start, end, correlation)] and
    the launches by correlation id."""
    device: List[Tuple[str, float, float, Optional[int]]]
    launches: Dict[int, Launch]


def load_timeline(path: str) -> Timeline:
    with open(path) as f:
        events = json.load(f)
    if isinstance(events, dict):
        events = events.get("traceEvents", [])
    return timeline_of(events)


def timeline_of(events: Sequence[dict]) -> Timeline:
    device, launches = [], {}
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat = ev.get("cat", "")
        corr = (ev.get("args") or {}).get("correlation")
        ts = float(ev.get("ts", 0.0))
        if cat in DEVICE_CATS:
            device.append((ev.get("name", ""), ts,
                           ts + float(ev.get("dur", 0.0)), corr))
        elif cat in RUNTIME_CATS and corr is not None:
            launches[corr] = Launch(ts, int(ev.get("tid", 0)))
    device.sort(key=lambda d: d[1])
    return Timeline(device, launches)


def without_last_marker(tl: Timeline) -> Tuple[Timeline, tuple]:
    """The timeline without its last marker kernel (the alignment
    probe launched after the window), and that kernel."""
    idx = max(i for i, d in enumerate(tl.device) if is_marker(d[0]))
    probe = tl.device[idx]
    return Timeline(tl.device[:idx] + tl.device[idx + 1:],
                    tl.launches), probe


def markers(tl: Timeline) -> List[tuple]:
    return [d for d in tl.device if is_marker(d[0])]


def offset_us(tl: Timeline, marker_host_ns: Sequence[int]
              ) -> Tuple[float, str]:
    """(trace clock minus perf_counter clock, in microseconds; what it
    was taken from), from the markers and the host clock read just
    before each marker's launch, in launch order."""
    ms = markers(tl)
    launches = [tl.launches[d[3]].ts for d in ms if d[3] in tl.launches]
    if not launches:
        return ms[0][1] - LAUNCH_US - marker_host_ns[0] / 1e3, \
            "device_start"
    diffs = sorted(ts - ns / 1e3 for ts in launches for ns in marker_host_ns)
    # the true pairs agree within PAIR_US; any other pair is a step off
    ends = [bisect.bisect_right(diffs, d + PAIR_US) for d in diffs]
    i = max(range(len(diffs)), key=lambda k: ends[k] - k)
    return statistics.median(diffs[i:ends[i]]), "launch"


def launch_latency_us(tl: Timeline) -> float:
    """The least device start less launch over the markers (the least
    queued): what an operation without a launch event is dated back
    by."""
    lat = [d[1] - tl.launches[d[3]].ts for d in markers(tl)
           if d[3] in tl.launches]
    return min(lat) if lat else LAUNCH_US


class SpanIndex:
    """The spans by thread, to find the innermost one open at a time:
    each thread's spans nest, so its timeline is a list of segments
    (start on the trace's clock, the innermost span from there on)."""

    def __init__(self, spans, offset: float):
        by_thread = defaultdict(list)
        for s in spans:
            by_thread[s.thread].append(s)
        self.segments = {t: self._segments(lst, offset)
                         for t, lst in by_thread.items()}
        self._times = {t: [x[0] for x in seg]
                       for t, seg in self.segments.items()}
        roots = [s for s in spans if s.parent is None]
        self.main = (statistics.mode(s.thread for s in roots)
                     if roots else None)

    @staticmethod
    def _segments(spans, offset):
        out, stack = [], []

        def close_until(t):
            while stack and stack[-1].end_ns / 1e3 + offset <= t:
                done = stack.pop()
                out.append((done.end_ns / 1e3 + offset,
                            stack[-1] if stack else None))

        for s in sorted(spans, key=lambda s: (s.start_ns, -s.end_ns)):
            start = s.start_ns / 1e3 + offset
            close_until(start)
            out.append((start, s))
            stack.append(s)
        close_until(float("inf"))
        return out

    def innermost(self, thread, ts: float):
        """The innermost span open at `ts` (trace clock) on `thread`."""
        times = self._times.get(thread)
        if not times:
            return None
        i = bisect.bisect_right(times, ts) - 1
        return self.segments[thread][i][1] if i >= 0 else None


def attribute(tl: Timeline, spans, offset: float,
              latency_us: float = LAUNCH_US) -> List[Optional[str]]:
    """The span name of each of tl.device's operations (None: outside
    every span). The trace names threads its own way: the thread that
    launched the first marker is the spans' main thread."""
    idx = SpanIndex(spans, offset)
    first = markers(tl)[0]
    tids = ({tl.launches[first[3]].tid: idx.main}
            if first[3] in tl.launches else {})
    out = []
    for name, start, _, corr in tl.device:
        launch = tl.launches.get(corr) if corr is not None else None
        if launch is not None:
            thread = tids.get(launch.tid, launch.tid)
            if thread not in idx.segments:
                thread = idx.main
            at = launch.ts
        else:
            thread, at = idx.main, start - latency_us
        s = idx.innermost(thread, at)
        out.append(None if s is None else s.name)
    return out


@dataclass
class Attribution:
    """What the per-layer metrics and the breakdown read."""
    steps: int
    span_device_s: Dict[str, float]  # summed over the window
    idle_s: Dict[str, float]  # idle gaps by the next operation's span

    def span_device_ms(self, top: int = 10) -> List[Tuple[str, float]]:
        """Device busy ms a step of each span's operations, top first."""
        rows = sorted(self.span_device_s.items(), key=lambda kv: -kv[1])
        return [(k, 1e3 * v / self.steps) for k, v in rows[:top]]

    def idle_gaps(self, top: int = 10) -> List[Tuple[str, float]]:
        """Idle seconds by span name, longest first."""
        return sorted(self.idle_s.items(), key=lambda kv: -kv[1])[:top]

    def named_idle_share(self) -> float:
        """The share of the idle time named by a program span."""
        total = sum(self.idle_s.values())
        named = sum(v for k, v in self.idle_s.items()
                    if not k.startswith("outside:"))
        return named / total if total > 0 else 1.0


def attribute_window(tl: Timeline, spans, offset: float,
                     latency_us: float = LAUNCH_US,
                     steps: Optional[int] = None) -> Tuple[Trace,
                                                           Attribution]:
    """The window's Trace (trace.py) and its attribution, a step being
    the window over `steps` (by default the markers less one: fewer
    where the trace dropped a marker)."""
    trace = from_device_ops([(n, s, e) for n, s, e, _ in tl.device])
    names = attribute(tl, spans, offset, latency_us)
    ops = [(d, n) for d, n in zip(tl.device, names) if not is_marker(d[0])]
    lo, hi = trace.window
    dev_s = defaultdict(float)
    idle = defaultdict(float)
    t = lo
    last_marker = next(d for d in reversed(tl.device) if is_marker(d[0]))
    for (name, start, end, _), span_name in ops:
        if end <= lo or start >= hi:
            continue
        label = span_name or f"outside:{stem(name)}"
        dev_s[label] += (min(end, hi) - max(start, lo)) / 1e6
        if start > t:
            idle[label] += (start - t) / 1e6
        t = max(t, end)
    if hi > t:  # the tail before the last marker: launched outside spans
        idle[f"outside:{stem(last_marker[0])}"] += (hi - t) / 1e6
    return trace, Attribution(steps or trace.steps, dict(dev_s),
                              dict(idle))


def host_ms(spans, root: str, less_child: Optional[str] = None
            ) -> Optional[float]:
    """Mean duration (ms) of the spans named `root`, less their
    `less_child` children and their sync.* descendants outside it."""
    kids = defaultdict(list)
    for s in spans:
        if s.parent is not None:
            kids[s.parent].append(s)

    def syncs(s):
        total = 0
        for k in kids[s.id]:
            if k.name.startswith("sync."):
                total += k.end_ns - k.start_ns
            elif k.name != less_child:
                total += syncs(k)
        return total

    vals = []
    for s in spans:
        if s.name != root:
            continue
        less = syncs(s)
        if less_child is not None:
            less += sum(k.end_ns - k.start_ns for k in kids[s.id]
                        if k.name == less_child)
        vals.append((s.end_ns - s.start_ns - less) / 1e6)
    return statistics.fmean(vals) if vals else None
