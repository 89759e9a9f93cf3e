"""From a run's record to the result line: the end-to-end metrics, the
device entry and the breakdown."""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional

GIB = 2 ** 30


def p95(values: List[float]) -> float:
    """The nearest-rank 95th percentile: the smallest value with at least
    95 % of the values at or below it."""
    s = sorted(values)
    return s[max(math.ceil(0.95 * len(s)) - 1, 0)]


def _rate(kind: str) -> Callable[[dict], Optional[float]]:
    def read(rec: dict) -> Optional[float]:
        return rec["clips"] / rec["wall_s"] if rec["kind"] == kind and rec["clips"] else None
    return read


# each end-to-end metric from the window's record (host clock and CUDA
# events), with the set-up time passed in
END_TO_END: Dict[str, Callable[[dict], Optional[float]]] = {
    "train_clips_per_s": _rate("train"),
    "eval_clips_per_s": _rate("eval"),
    "step_ms_p95": lambda rec: p95(rec["step_ms"]) if rec.get("step_ms") else None,
    "peak_mem_gib": lambda rec: rec["peak_bytes"] / GIB if rec["peak_bytes"] else None,
    "setup_s": lambda rec: rec["setup_s"],
}


def end_to_end(metrics, rec: dict, strict: bool = True) -> Dict[str, dict]:
    """The cell's end-to-end metrics. One the run cannot read raises when
    `strict` (a run on the card) and is left out otherwise (a CPU run has
    no device metric)."""
    out = {}
    for m in metrics:
        value = END_TO_END[m["name"]](rec)
        if value is None:
            if strict:
                raise RuntimeError(f"the run holds no {m['name']}")
            continue
        out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out
