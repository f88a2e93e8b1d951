"""Structured training metrics + profiling hooks.

Counterpart of opensplat_tpu/utils/metrics.py. The reference's
observability is stdout-only (loss every displayStep, opensplat.cpp:
163-166; densify counts, model.cpp:422,460,478). This module adds
per-step structured records (JSONL), rolling steps/s and Mpix/s
counters, refine event records, and a torch.profiler trace context that
exports a Chrome trace of the host and the card.
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from collections import deque
from typing import Optional


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
        self.last_record: Optional[dict] = None

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
        self.last_record = rec
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
    exported as Chrome trace JSON into log_dir on exit; no-op when
    log_dir is empty. Open the file in chrome://tracing or Perfetto."""
    if not log_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
