"""Timers and the device trace (port of `cld_tpu/utils/timer.py`): named
tic / toc aggregation, and `device_trace`, a `torch.profiler` context that
writes a Chrome trace of a block."""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict


class Timer:
    def __init__(self):
        self.total = 0.0
        self.count = 0
        self._start = None

    def tic(self):
        self._start = time.perf_counter()

    def toc(self) -> float:
        elapsed = time.perf_counter() - self._start
        self.total += elapsed
        self.count += 1
        return elapsed

    @property
    def average(self) -> float:
        return self.total / max(1, self.count)


class Timers:
    """Named tic / toc aggregation."""

    def __init__(self):
        self._timers: Dict[str, Timer] = defaultdict(Timer)

    def tic(self, name: str):
        self._timers[name].tic()

    def toc(self, name: str) -> float:
        return self._timers[name].toc()

    @contextlib.contextmanager
    def timed(self, name: str):
        self.tic(name)
        try:
            yield
        finally:
            self.toc(name)

    def report(self) -> Dict[str, Dict[str, float]]:
        return {
            k: {"total": t.total, "count": t.count, "average": t.average}
            for k, t in self._timers.items()
        }

    def __str__(self) -> str:
        return " | ".join(
            f"{k}: {t.average * 1e3:.2f}ms x{t.count}" for k, t in self._timers.items()
        )


@contextlib.contextmanager
def device_trace(log_dir: str, device="cuda"):
    """Profile a block with `torch.profiler` and write its Chrome trace
    (`trace.json`, viewable in chrome://tracing or Perfetto) into `log_dir`.
    It records CPU activity, and the card's kernels when `device` is a CUDA
    device. Yields the profiler; the trace's path is its `trace_path`."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.trace_path = os.path.join(log_dir, "trace.json")
    with prof:
        yield prof
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)
    prof.export_chrome_trace(prof.trace_path)
