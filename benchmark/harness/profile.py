"""The traced run's reading of the device: a frozen copy of the port's
`scripts/profile_step.py::KERNEL_CLASSES` and `profile_breakdown`
arithmetic, with the idle gaps named by what the host was doing.

Device busy time is the union of the profiler's CUDA intervals; kernels are
grouped by name into classes. The profiler adds host time to every
operator, so the idle share it gives reads high against an unprofiled run.
"""

from __future__ import annotations

import collections
import time
from typing import Callable, Dict, List

import numpy as np
import torch

KERNEL_CLASSES = (
    ("attention (port's K1 and K2 kernels)", ("attention_fwd_kernel", "attention_bwd_")),
    ("GEMM (cuBLAS)", ("nvjet", "gemm", "sm90_xmma", "cutlass", "gemv", "splitKreduce")),
    ("copy", ("Memcpy", "Memset", "copy_", "CatArrayBatched")),
    ("reduction", ("reduce_kernel", "Reduce", "softmax", "norm")),
    ("elementwise", ("elementwise", "vectorized")),
)
# idle gaps attributed to a host operator: the longest this many
GAPS_NAMED = 2000


def kernel_class(name: str) -> str:
    return next((label for label, keys in KERNEL_CLASSES if any(k in name for k in keys)), "other")


def _merge(spans: List[tuple]) -> List[tuple]:
    merged: List[list] = []
    for start, end in sorted(spans):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return [tuple(s) for s in merged]


def profile_calls(fn: Callable[[], object], repeat: int, units: int, launch_counts: Callable[[], dict],
                  reset_counts: Callable[[], None], cuda: bool = True) -> Dict:
    """Run fn() `repeat` times under torch.profiler, then synchronize; the
    work done is `units` steps or batches. Returns per unit the device ms
    by class and the kernels' launch counters; over the window the wall
    and busy seconds, the ten device operations with the most time and the
    ten largest idle-gap totals by the host operator running in each gap.
    Without `cuda` (the CPU tests) only the host is traced."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    sync = torch.cuda.synchronize if cuda else (lambda: None)
    sync()
    reset_counts()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(repeat):
            fn()
        sync()
        wall_s = time.perf_counter() - t0
    counts = launch_counts()
    spans, host, by_name = [], [], collections.defaultdict(float)
    for e in prof.events():
        start, end = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            if getattr(e, "is_user_annotation", False):
                continue
            spans.append((start, end))
            by_name[e.name] += (end - start) / 1e6
        elif end > start:
            host.append((start, end, e.name))
    merged = _merge(spans)
    busy_s = sum(end - start for start, end in merged) / 1e6
    classes = collections.defaultdict(float)
    for name, s in by_name.items():
        classes[kernel_class(name)] += s
    return {"units": units, "wall_s": wall_s, "busy_s": busy_s,
            "device_ms_by_class": {k: v * 1e3 / units for k, v in classes.items()},
            "launches_per_unit": {k: v / units for k, v in counts.items()},
            "device_ops": [[name[:160], s] for name, s in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]],
            "idle_gaps": _idle_gaps(merged, host)}


def _idle_gaps(merged: List[tuple], host: List[tuple]) -> List[list]:
    """The gaps between device work, each named by the innermost host
    operator whose span holds the gap's middle (the longest GAPS_NAMED
    gaps), summed by name: the ten largest totals, in seconds."""
    gaps = [(merged[i][1], merged[i + 1][0]) for i in range(len(merged) - 1) if merged[i + 1][0] > merged[i][1]]
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:GAPS_NAMED]
    if not gaps or not host:
        return []
    starts = np.array([h[0] for h in host], dtype=np.float64)
    ends = np.array([h[1] for h in host], dtype=np.float64)
    totals = collections.defaultdict(float)
    for g0, g1 in gaps:
        mid = 0.5 * (g0 + g1)
        inside = np.nonzero((starts <= mid) & (ends >= mid))[0]
        name = host[inside[np.argmax(starts[inside])]][2] if inside.size else "(no host operator)"
        totals[name[:160]] += (g1 - g0) / 1e6
    return [[name, s] for name, s in sorted(totals.items(), key=lambda kv: -kv[1])[:10]]
