"""The program's own spans and counter, read in a traced run: the tally
that `devias_tpu_torch.utils.profiling` keeps of the latest stretch in
which a profiler recorded. In a run that stretch is `profile_calls`' steps
or batches: set-up and the window run unprofiled, so the first span of the
profiled calls starts the tally again. A program without the tally (one
older than its spans) gives None, as a run that holds nothing to read."""

from __future__ import annotations

from typing import Optional

from harness.layers import _of


def _tally(name: str):
    """`span_totals()` or `counter_totals()` of the program, or None."""
    try:
        from devias_tpu_torch.utils import profiling
    except ImportError:
        return None
    read = getattr(profiling, name, None)
    return read() if read is not None else None


def span_ms(run: dict, kind: str, name: str, field: str = "self_ns") -> Optional[float]:
    """Host ms per profiled step or batch of the span `name`: its self time,
    or with `field="total_ns"` its whole time."""
    spans = _tally("span_totals") if _of(run, kind) else None
    if not spans or name not in spans:
        return None
    return spans[name][field] / 1e6 / run["profile"]["units"]


def counter_per_unit(run: dict, kind: str, name: str) -> Optional[float]:
    """The counter `name` per profiled step or batch."""
    counters = _tally("counter_totals") if _of(run, kind) else None
    if not counters or name not in counters:
        return None
    return counters[name] / run["profile"]["units"]
