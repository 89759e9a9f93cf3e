"""Per-step cosine schedules with linear warmup (port of
`devias_tpu/core/schedules.py`).

The reference builds a per-iteration value array: a linear warmup from
`warmup_start` over `warmup_steps` (numpy linspace, so the last warmup step
reaches `base`), then a half cosine from `base` to `final` over the
remaining steps, its index clamped to the array's end. Here each schedule
is a function of the step count returning a Python float.
"""

from __future__ import annotations

import math
from typing import Callable


def cosine_schedule(base_value: float, final_value: float, total_steps: int, warmup_steps: int = 0,
                    warmup_start: float = 0.0) -> Callable[[int], float]:
    """f(step): warmup_start + (base - warmup_start) * step / (warmup - 1)
    for step < warmup, else final + (base - final)/2 (1 + cos(pi i / n))
    with i = clamp(step - warmup, 0, n - 1), n = max(total - warmup, 1)."""
    base_value, final_value = float(base_value), float(final_value)
    warmup_steps, total_steps = int(warmup_steps), int(total_steps)
    cos_steps = max(total_steps - warmup_steps, 1)

    def fn(step) -> float:
        step = float(step)
        if step < warmup_steps:
            if warmup_steps > 1:
                return warmup_start + (base_value - warmup_start) * step / (warmup_steps - 1)
            return base_value
        i = min(max(step - warmup_steps, 0.0), cos_steps - 1)
        return final_value + 0.5 * (base_value - final_value) * (1.0 + math.cos(math.pi * i / cos_steps))

    return fn


def cosine_wd_schedule(base_wd: float, final_wd: float, total_steps: int) -> Callable[[int], float]:
    """Weight-decay cosine, no warmup."""
    return cosine_schedule(base_wd, final_wd, total_steps, warmup_steps=0)
