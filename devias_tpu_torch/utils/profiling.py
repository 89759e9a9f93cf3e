"""Profiling: a `torch.profiler` trace, and the program's own spans and
counters (port of `devias_tpu/utils/profiling.py`).

`profile_trace(log_dir)` records the host and, on `cuda`, the card around
the wrapped block and writes a Chrome trace (`trace.json`, for Perfetto or
`chrome://tracing`) into `log_dir`.

`span(name)` marks a phase of the program and `count(name, n)` adds to a
counter. Both record only while a `torch.profiler` records (the CLIs'
`--profile_dir`, `scripts/profile_step.py`, the benchmark's traced
calls); otherwise a span costs one check of the profiler's state. Inside
`captured_counts()` (a train step being captured as a CUDA graph,
`train/graph.py`) a count goes to the capture's own tally instead,
whatever the profiler's state, and each replay adds it again. Under a
profiler a span is a `record_function` range, so it shows in the trace on
the clock of the card's events (and as a `gpu_user_annotation` range over
the kernels it launched), and its host time goes to an in-memory tally:
`span_totals()` gives per name the calls, the total ns and the self ns
(the total less the time of the spans opened inside it on the same
thread), `counter_totals()` the counters. The tally holds the latest
stretch in which a profiler recorded: the first span or count recorded
under a profiler after one made without it starts it again. Nothing is
written to disk; the trace carries the spans.

`device_span(name, device)` times a block on the card: a pair of CUDA
timing events around it, recorded while a profiler records, as a span is,
and while a graph is being captured whatever the profiler's state, as
external events that become the graph's event-record nodes, so that every
replay times the block again. `device_span_ms(name)` waits for the last
recorded pair's end and gives its interval in ms: the latest eager call
or replay. Off the card it records nothing and reads None.

The program's spans and counter:

| name | where | covers |
|---|---|---|
| `train.step` | `train/step.py::_run_step` | a whole train step |
| `train.fame` | `slot_loss`'s `mix_clips`, `hvu_loss`'s FAME-HVU | FAME (or the Segformer mix) |
| `train.mask_model` | `train/step.py::_segformer_mix` | the mask model's person masks (`segformer_frame_masks`), inside `train.fame`; also a device span |
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
| counter `mask_frames` | `aug/segformer_mix.py::segformer_frame_masks` | frames the mask model masked (B T/2 a call) |

A replayed train step enters `train.step` and `train.graph_wait` only: the
host work of its phases is what the replay no longer does. Its captured
counts (`mask_frames`) and device spans (`train.mask_model`) still record:
the replay adds the one and re-times the other.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Dict, Iterator, Optional

import torch

from devias_tpu_torch.device import DeviceLike, resolve_device

TRACE_FILE = "trace.json"
# the program's spans, as the module docstring's table lists them
SPANS = ("train.step", "train.fame", "train.teacher", "train.student", "nn.agg", "train.loss", "train.backward",
         "train.optimizer", "train.graph_wait", "eval.forward", "h2d.stage", "eval.fetch", "train.mask_model")

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

    def captured(self) -> Optional[Dict[str, int]]:
        """This thread's capture tally (`captured_counts`), or None."""
        return getattr(self.local, "captured", None)


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
    """Add `n` to the counter `name`, under a profiler, or to the capture's
    tally inside `captured_counts` (module docstring)."""
    captured = _TALLY.captured()
    if captured is not None:
        captured[name] = captured.get(name, 0) + n
        return
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


@contextlib.contextmanager
def captured_counts() -> Iterator[Dict[str, int]]:
    """The counts this thread makes inside the block, {name: total}, kept
    apart from the tally whatever the profiler's state: what a CUDA graph
    captured in the block counts on each replay."""
    saved = _TALLY.captured()
    _TALLY.local.captured = counted = {}
    try:
        yield counted
    finally:
        _TALLY.local.captured = saved


# per device span, the CUDA events of its last recorded interval
_DEVICE_SPANS: Dict[str, tuple] = {}


class device_span:
    """`with device_span(name, device):` times the block on the card
    (module docstring): on a CUDA `device`, while a profiler records or
    this thread's stream is being captured."""

    __slots__ = ("name", "device", "_start")

    def __init__(self, name: str, device: torch.device):
        self.name = name
        self.device = device

    def __enter__(self):
        self._start = None
        if self.device.type == "cuda" and (_profiler_on() or torch.cuda.is_current_stream_capturing()):
            self._start = torch.cuda.Event(enable_timing=True, external=True)
            self._start.record()
        return self

    def __exit__(self, exc_type, exc, tb):
        if self._start is not None:
            end = torch.cuda.Event(enable_timing=True, external=True)
            end.record()
            _DEVICE_SPANS[self.name] = (self._start, end)
        return False


def device_span_ms(name: str) -> Optional[float]:
    """The card's ms of the device span `name`'s last recorded interval,
    once it has ended; None where none was recorded."""
    pair = _DEVICE_SPANS.get(name)
    if pair is None:
        return None
    start, end = pair
    end.synchronize()
    return start.elapsed_time(end)
