"""Structured training metrics, the program's tracer and profiling hooks.

Counterpart of opensplat_tpu/utils/metrics.py. The reference's
observability is stdout-only (loss every displayStep, opensplat.cpp:
163-166; densify counts, model.cpp:422,460,478). This module adds
per-step structured records (JSONL), rolling steps/s and Mpix/s
counters, refine event records, and a torch.profiler trace context that
exports a Chrome trace of the host and the card.

The tracer: `span(name)` times a piece of the program's host work and
`count(name, n)` adds to a named counter; `host_sync(site, device)` does
both for each point where the host waits on a CUDA device (a read of
device data, or a blocking upload from pageable memory, which
synchronizes the stream). Counters always count. Spans are recorded only
while tracing is on (`tracing()`, a call or a context manager;
`profile_trace` turns it on for its window): each is (id, name, thread,
parent id, start, end) on time.perf_counter_ns()'s clock, with one stack
of open spans a thread, and it opens
torch.profiler.record_function(name), so a profiler's trace shows the
spans beside the kernels. The spans stay in memory until `take_spans()`;
there is no exporter. Off, `span` costs one module-level check and
returns a shared no-op.
"""
from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from collections import Counter, deque
from typing import Dict, List, NamedTuple, Optional

import torch


class MetricsLogger:
    """Rolling-window throughput counters + optional JSONL sink.

    Call step(...) once per training step; refine(...) after each refine
    event. steps_per_sec / mpix_per_sec are computed over the last
    `window` steps of wall time.
    """

    def __init__(self, jsonl_path: str = "", window: int = 50):
        self._path = jsonl_path
        self._f = None
        if jsonl_path:
            os.makedirs(os.path.dirname(jsonl_path) or ".", exist_ok=True)
            self._f = open(jsonl_path, "a", buffering=1)
        self._times: deque = deque(maxlen=window + 1)
        self._pixels: deque = deque(maxlen=window)

    def tick(self, height: int, width: int):
        """Advance the throughput counters without reading any values
        (keeps the hot loop free of device syncs)."""
        self._times.append(time.perf_counter())
        self._pixels.append(height * width)

    def step(self, step: int, loss: float, psnr: float, n_alive: int,
             height: int, width: int, extra: Optional[dict] = None,
             tick: bool = True) -> dict:
        if tick:
            self._times.append(time.perf_counter())
            self._pixels.append(height * width)
        rec = {
            "type": "step",
            "step": step,
            "loss": round(float(loss), 6),
            "psnr": round(float(psnr), 3),
            "n_gaussians": int(n_alive),
            "steps_per_sec": round(self.steps_per_sec(), 3),
            "mpix_per_sec": round(self.mpix_per_sec(), 3),
        }
        if extra:
            rec.update(extra)
        if self._f:
            self._f.write(json.dumps(rec) + "\n")
        return rec

    def refine(self, step: int, counts: dict) -> dict:
        rec = {"type": "refine", "step": step, **{k: int(v) for k, v in counts.items()}}
        if self._f:
            self._f.write(json.dumps(rec) + "\n")
        return rec

    def steps_per_sec(self) -> float:
        if len(self._times) < 2:
            return 0.0
        dt = self._times[-1] - self._times[0]
        return (len(self._times) - 1) / dt if dt > 0 else 0.0

    def mpix_per_sec(self) -> float:
        if len(self._times) < 2:
            return 0.0
        dt = self._times[-1] - self._times[0]
        n = min(len(self._pixels), len(self._times) - 1)
        px = sum(list(self._pixels)[-n:])
        return px / dt / 1e6 if dt > 0 else 0.0

    def close(self):
        if self._f:
            self._f.close()
            self._f = None


@contextlib.contextmanager
def profile_trace(log_dir: str = ""):
    """torch.profiler trace (CPU and, where present, CUDA activity),
    with the tracer on so that the program's spans appear beside the
    kernels, exported as Chrome trace JSON into log_dir on exit; no-op
    when log_dir is empty. Open the file in chrome://tracing or
    Perfetto."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof, tracing(True):
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class Span(NamedTuple):
    """A finished span. `parent` is the id of the span that was open
    around it on its thread (None at a root); times are
    time.perf_counter_ns()."""
    id: int
    name: str
    thread: int
    parent: Optional[int]
    start_ns: int
    end_ns: int


_on = False  # the tracer's one switch, set by `tracing` alone
_spans: List[Span] = []
_counts: Counter = Counter()
_ids = itertools.count()
_open = threading.local()  # .stack: this thread's open spans
_OFF = contextlib.nullcontext()


class _Recording:
    """A span while it is open (tracing on)."""

    __slots__ = ("name", "id", "parent", "stack", "rf", "start")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = getattr(_open, "stack", None)
        if stack is None:
            stack = _open.stack = []
        self.parent = stack[-1].id if stack else None
        self.id = next(_ids)
        self.stack = stack
        stack.append(self)
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        self.rf.__exit__(*exc)
        self.stack.pop()
        _spans.append(Span(self.id, self.name, threading.get_ident(),
                           self.parent, self.start, end))
        return False


def span(name: str):
    """A context manager that records the span `name` while tracing is
    on; the shared no-op while it is off."""
    if not _on:
        return _OFF
    return _Recording(name)


def count(name: str, n: int = 1) -> None:
    """Add n to the counter `name` (always on)."""
    _counts[name] += n


def host_sync(site: str, device, n: int = 1):
    """The host waits on `device` at `site`, in `n` reads or blocking
    uploads: the span sync.<site> while tracing, and, where `device` is
    a CUDA device (elsewhere nothing waits), n added to host_syncs and
    host_syncs.<site>. The counts are a breakdown by the sites marked
    here; CUDA's own count of synchronizing calls is
    torch.cuda.set_sync_debug_mode's. Wrap the statements that wait,
    and nothing else."""
    if _waits(device):
        _counts["host_syncs"] += n
        _counts["host_syncs." + site] += n
    return span("sync." + site)


def _waits(device) -> bool:
    """Whether a read of, or blocking upload to, `device` makes the host
    wait (a CUDA device; a torch.device or its name)."""
    return str(device).startswith("cuda")


def counts() -> Dict[str, int]:
    """A copy of every counter: take one before and one after a window,
    and subtract."""
    return dict(_counts)


def take_spans() -> List[Span]:
    """The spans finished since the last call, in the order they ended;
    the tracer keeps none of them."""
    global _spans
    out, _spans = _spans, []
    return out


class tracing:
    """Turn the tracer on (or off, with on=False) now. As a context
    manager it restores the state it found on exit. The tracer has no
    other switch."""

    def __init__(self, on: bool = True):
        global _on
        self.was_on, _on = _on, bool(on)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        global _on
        _on = self.was_on
        return False
