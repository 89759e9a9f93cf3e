"""Profiling: a `torch.profiler` trace, and the program's own spans and
counters (port of `devias_tpu/utils/profiling.py`).

`profile_trace(log_dir)` records the host and, on `cuda`, the card around
the wrapped block and writes a Chrome trace (`trace.json`, for Perfetto or
`chrome://tracing`) into `log_dir`.

`span(name)` marks a phase of the program and `count(name, n)` adds to a
counter. Both record only while a `torch.profiler` records (the CLIs'
`--profile_dir`, `scripts/profile_step.py`, the benchmark's traced
calls); otherwise a span costs one check of the profiler's state. Under a
profiler a span is a `record_function` range, so it shows in the trace on
the clock of the card's events (and as a `gpu_user_annotation` range over
the kernels it launched), and its host time goes to an in-memory tally:
`span_totals()` gives per name the calls, the total ns and the self ns
(the total less the time of the spans opened inside it on the same
thread), `counter_totals()` the counters. The tally holds the latest
stretch in which a profiler recorded: the first span or count recorded
under a profiler after one made without it starts it again. Nothing is
written to disk; the trace carries the spans.

The program's spans and counter:

| name | where | covers |
|---|---|---|
| `train.step` | `train/step.py::_run_step` | a whole train step |
| `train.fame` | `slot_loss`'s `mix_clips`, `hvu_loss`'s FAME-HVU | FAME (or the Segformer mix) |
| `train.teacher` | `slot_loss`, `multi_task_loss_of` | the frozen teacher's forward |
| `train.student` | `slot_loss`, `hvu_loss` | the student's backbone and heads |
| `nn.agg` | `nn/agg.py::AggregationBlock.forward` | the slot rounds, once a call |
| `train.loss` | `slot_loss`, `hvu_loss` | the slot loss with its matching |
| `train.backward` | `_run_step` | autograd's enqueue of the backward |
| `train.optimizer` | `_run_step` | the optimizer step, `zero_grad`, the EMA, the step count |
| `train.graph_wait` | `train/graph.py::StepGraph.replay` | the wait for the replay two back to finish, before a replay |
| `eval.forward` | `train/step.py::make_eval_step` | one eval forward, its staging included |
| `h2d.stage` | `train/step.py::to_device` | pinning a host array and enqueueing its copy to the card |
| `eval.fetch` | `eval/protocols.py::_finish_fetch` | the wait for the card's results and their numpy conversion |
| counter `h2d_bytes` | `train/step.py::to_device` | bytes of host arrays sent to the card |
| counter `train_graph_replays` | `train/graph.py::StepGraph.replay` | replays of a train step captured as a CUDA graph |

A replayed train step enters `train.step` and `train.graph_wait` only: the
host work of its phases is what the replay no longer does.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Dict, Optional

import torch

from devias_tpu_torch.device import DeviceLike, resolve_device

TRACE_FILE = "trace.json"
# the program's spans, as the module docstring's table lists them
SPANS = ("train.step", "train.fame", "train.teacher", "train.student", "nn.agg", "train.loss", "train.backward",
         "train.optimizer", "train.graph_wait", "eval.forward", "h2d.stage", "eval.fetch")

_profiler_on = torch._C._autograd._profiler_enabled


def recording() -> bool:
    """Whether a `torch.profiler` records now."""
    return _profiler_on()


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


class _Tally:
    """The spans and counters of the latest profiled stretch. Process-wide,
    as the profiler is; each thread keeps its own stack of open spans."""

    def __init__(self):
        self.lock = threading.Lock()
        self.local = threading.local()
        # set by a span or count made without a profiler: the next one
        # made under a profiler starts a new stretch
        self.stale = False
        self.spans: Dict[str, list] = {}  # name -> [calls, total ns, self ns]
        self.counters: Dict[str, int] = {}

    def recording(self) -> None:
        """Called under a profiler: start a new stretch if the last call
        was made without one."""
        if self.stale:
            with self.lock:
                self.spans, self.counters, self.stale = {}, {}, False

    def stack(self) -> list:
        """This thread's open spans, each entry the ns of its children."""
        if not hasattr(self.local, "stack"):
            self.local.stack = []
        return self.local.stack


_TALLY = _Tally()


class span:
    """`with span(name):` marks a phase of the program (module docstring).
    Without a running profiler it only notes that; under one it opens a
    `record_function(name)` range and adds its host time to the tally."""

    __slots__ = ("name", "_range", "_t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        if not _profiler_on():
            _TALLY.stale = True
            self._range = None
            return self
        _TALLY.recording()
        _TALLY.stack().append(0)
        self._range = torch.autograd.profiler.record_function(self.name)
        self._t0 = time.perf_counter_ns()
        self._range.__enter__()
        return self

    def __exit__(self, exc_type, exc, tb):
        if self._range is None:
            return False
        self._range.__exit__(exc_type, exc, tb)
        ns = time.perf_counter_ns() - self._t0
        stack = _TALLY.stack()
        children = stack.pop()
        if stack:
            stack[-1] += ns
        with _TALLY.lock:
            entry = _TALLY.spans.setdefault(self.name, [0, 0, 0])
            entry[0] += 1
            entry[1] += ns
            entry[2] += ns - children
        return False


def count(name: str, n: int) -> None:
    """Add `n` to the counter `name`, under a profiler (module docstring)."""
    if not _profiler_on():
        _TALLY.stale = True
        return
    _TALLY.recording()
    with _TALLY.lock:
        _TALLY.counters[name] = _TALLY.counters.get(name, 0) + n


def span_totals() -> Dict[str, Dict[str, int]]:
    """{name: {"calls", "total_ns", "self_ns"}} over the latest profiled
    stretch."""
    with _TALLY.lock:
        return {k: {"calls": c, "total_ns": t, "self_ns": s} for k, (c, t, s) in _TALLY.spans.items()}


def counter_totals() -> Dict[str, int]:
    """{name: total} over the latest profiled stretch."""
    with _TALLY.lock:
        return dict(_TALLY.counters)
