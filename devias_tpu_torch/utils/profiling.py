"""Profiling: a `torch.profiler` trace and per-step timing (port of
`devias_tpu/utils/profiling.py`).

`profile_trace(log_dir)` records the host and, on `cuda`, the card around
the wrapped block and writes a Chrome trace (`trace.json`, for Perfetto or
`chrome://tracing`) into `log_dir`. `StepTimer` times steps with CUDA
events on `cuda` and the host clock on `cpu`; its `summary` is the JAX
class's text.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch

from devias_tpu_torch.device import DeviceLike, resolve_device

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str], device: DeviceLike = None):
    """Trace the wrapped block with `torch.profiler` (host activity, and the
    card's on `cuda`, the default) into `log_dir`/trace.json. With an empty
    `log_dir` it does nothing."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    dev = resolve_device(device)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    with profile(activities=activities) as prof:
        yield
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


class StepTimer:
    """Step times in seconds: between `start()` and `stop()`, measured by
    CUDA events on `cuda` (the default; `stop` waits for the card to reach
    its event) and by the host clock on `cpu`."""

    def __init__(self, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.times = []
        self._t0 = None

    def start(self) -> None:
        if self.device.type == "cuda":
            self._t0 = torch.cuda.Event(enable_timing=True)
            self._t0.record()
        else:
            self._t0 = time.perf_counter()

    def stop(self) -> float:
        if self.device.type == "cuda":
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            end.synchronize()
            dt = self._t0.elapsed_time(end) / 1e3
        else:
            dt = time.perf_counter() - self._t0
        self.times.append(dt)
        return dt

    @property
    def mean(self) -> float:
        return sum(self.times) / max(len(self.times), 1)

    def summary(self, batch_size: Optional[int] = None) -> str:
        if not self.times:
            return "no steps timed"
        s = f"steps={len(self.times)} mean={self.mean*1000:.1f}ms"
        if batch_size:
            s += f" throughput={batch_size/self.mean:.1f}/s"
        return s
