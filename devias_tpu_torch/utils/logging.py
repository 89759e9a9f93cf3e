"""Metric aggregation and scalar logging (port of
`devias_tpu/utils/logging.py`).

SmoothedValue windowed meters, MetricLogger with `log_every`, and the
TensorLogger scalar writer: TensorBoard event files when `tensorboardX`
imports, else one JSON line per update in `scalars.jsonl`, the JAX
package's record format. Cross-process sums go through `torch.distributed`
when a group of more than one process is initialised.
"""

from __future__ import annotations

import collections
import datetime
import json
import os
import time
from typing import Dict, Iterable, Optional

import numpy as np
import torch
import torch.distributed as dist


class SmoothedValue:
    """Windowed + global average meter (ref utils/utils.py:21-77)."""

    def __init__(self, window_size: int = 20, fmt: str = "{median:.4f} ({global_avg:.4f})"):
        self.deque = collections.deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0
        self.fmt = fmt

    def update(self, value, n: int = 1):
        self.deque.append(value)
        self.count += n
        self.total += value * n

    def synchronize_between_processes(self):
        """all_reduce count and total across processes (ref
        utils/utils.py:39-50); a no-op in one process."""
        if not (dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1):
            return
        t = torch.tensor([self.count, self.total], dtype=torch.float64)
        if dist.get_backend() == "nccl":
            t = t.cuda()
        dist.all_reduce(t)
        self.count = int(t[0].item())
        self.total = float(t[1].item())

    @property
    def median(self):
        return float(np.median(self.deque)) if self.deque else 0.0

    @property
    def avg(self):
        return float(np.mean(self.deque)) if self.deque else 0.0

    @property
    def global_avg(self):
        return self.total / max(self.count, 1)

    @property
    def max(self):
        return max(self.deque) if self.deque else 0.0

    @property
    def value(self):
        return self.deque[-1] if self.deque else 0.0

    def __str__(self):
        return self.fmt.format(
            median=self.median, avg=self.avg, global_avg=self.global_avg,
            max=self.max, value=self.value,
        )


class MetricLogger:
    """ref utils/utils.py:80-164: named meters + log_every with ETA."""

    def __init__(self, delimiter: str = "  "):
        self.meters: Dict[str, SmoothedValue] = collections.defaultdict(SmoothedValue)
        self.delimiter = delimiter

    def update(self, **kwargs):
        for k, v in kwargs.items():
            self.meters[k].update(float(v))

    def __getattr__(self, attr):
        if attr in self.meters:
            return self.meters[attr]
        raise AttributeError(attr)

    def synchronize_between_processes(self):
        for meter in self.meters.values():
            meter.synchronize_between_processes()

    def __str__(self):
        return self.delimiter.join(f"{k}: {m}" for k, m in self.meters.items())

    def log_every(self, iterable: Iterable, print_freq: int, header: str = ""):
        i = 0
        start = time.time()
        iter_time = SmoothedValue(fmt="{avg:.4f}")
        data_time = SmoothedValue(fmt="{avg:.4f}")
        end = time.time()
        try:
            total = len(iterable)  # type: ignore[arg-type]
        except TypeError:
            total = None
        for obj in iterable:
            data_time.update(time.time() - end)
            yield obj
            iter_time.update(time.time() - end)
            if i % print_freq == 0 or (total and i == total - 1):
                if total:
                    eta = iter_time.global_avg * (total - i)
                    eta_str = str(datetime.timedelta(seconds=int(eta)))
                    print(f"{header} [{i}/{total}] eta: {eta_str} {self} "
                          f"time: {iter_time} data: {data_time}")
                else:
                    print(f"{header} [{i}] {self} time: {iter_time} data: {data_time}")
            i += 1
            end = time.time()
        elapsed = time.time() - start
        print(f"{header} Total time: {datetime.timedelta(seconds=int(elapsed))}")


class TensorLogger:
    """Scalar writer: tensorboardX when importable, JSONL otherwise
    (ref utils/utils.py:167-188 TensorboardLogger + the head/step
    convention)."""

    def __init__(self, log_dir: Optional[str]):
        self.step = 0
        self.writer = None
        self.jsonl = None
        if not log_dir:
            return
        os.makedirs(log_dir, exist_ok=True)
        try:
            from tensorboardX import SummaryWriter

            self.writer = SummaryWriter(logdir=log_dir)
        except ImportError:
            self.jsonl = os.path.join(log_dir, "scalars.jsonl")

    def set_step(self, step: Optional[int] = None):
        self.step = step if step is not None else self.step + 1

    def update(self, head: str = "scalar", step: Optional[int] = None, **kwargs):
        s = step if step is not None else self.step
        if self.writer is not None:
            for k, v in kwargs.items():
                if v is not None:
                    self.writer.add_scalar(f"{head}/{k}", float(v), s)
        elif self.jsonl is not None:
            with open(self.jsonl, "a") as f:
                f.write(json.dumps({"step": s, "head": head, **{k: float(v) for k, v in kwargs.items() if v is not None}}) + "\n")

    def flush(self):
        if self.writer is not None:
            self.writer.flush()
