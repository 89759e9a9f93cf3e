"""The arithmetic behind the per-layer readers in `metrics/`. Each takes a
run's record ({"record": the window, "profile": the traced calls, "config",
"traffic"}) and returns None where the run holds nothing to read."""

from __future__ import annotations

import statistics
from typing import Optional

from harness import roofline

ATTENTION = "attention (port's K1 and K2 kernels)"


def _of(run: dict, kind: str, need_profile: bool = True) -> bool:
    return run["record"]["kind"] == kind and (run.get("profile") is not None or not need_profile)


def host_ms(run: dict, kind: str) -> Optional[float]:
    """Host milliseconds inside the program's calls per step (train) or per
    batch (eval: both forward functions), from the window."""
    rec = run["record"]
    if not _of(run, kind, False) or not rec["host_ms"]:
        return None
    if kind == "train":
        return statistics.fmean(rec["host_ms"])
    return sum(rec["host_ms"]) / rec["batches"] if rec["batches"] else None


def class_ms(run: dict, kind: str, label: str) -> Optional[float]:
    """Profiled device ms per step of one kernel class."""
    if not _of(run, kind):
        return None
    return run["profile"]["device_ms_by_class"].get(label)


def idle_share(run: dict, kind: str) -> Optional[float]:
    """Per cent of the profiled window in which the device ran nothing."""
    if not _of(run, kind):
        return None
    p = run["profile"]
    return (1.0 - p["busy_s"] / p["wall_s"]) * 100.0 if p["busy_s"] > 0 else None


def mfu(run: dict, kind: str) -> Optional[float]:
    """Model operations per second over the window against the bf16 peak,
    per cent."""
    rec = run["record"]
    if not _of(run, kind, False) or not rec["clips"]:
        return None
    return rec["flops_per_clip"] * rec["clips"] / rec["wall_s"] / roofline.BF16_PEAK * 100.0


def attention_roofline(run: dict, kind: str) -> Optional[float]:
    """The least time of the profiled unit's K1 launches (each at its
    model's B, H, N, D: no-stats forwards at the teacher's tokens in
    training and split by depth between the two models in eval; stats and
    backward at the student's), over the device time of the attention
    kernels, per cent."""
    if not _of(run, kind):
        return None
    cfg, B = run["config"], run["traffic"]["batch"]
    m, t = cfg["model"], cfg.get("teacher")
    n = run["profile"]["launches_per_unit"]
    ms = run["profile"]["device_ms_by_class"].get(ATTENTION, 0.0)
    if not ms or not any(n.get(k) for k in ("K1-fwd", "K1-fwd-stats", "K1-bwd")):
        return None
    H, D = m["num_heads"], m["embed_dim"] // m["num_heads"]
    Ns = roofline.tokens(m)
    if kind == "train":
        fwd = [(roofline.tokens(t) if t else Ns, 1.0)]
    else:
        total = m["depth"] + (t["depth"] if t else 0)
        fwd = [(Ns, m["depth"] / total)] + ([(roofline.tokens(t), t["depth"] / total)] if t else [])
    bound = n.get("K1-fwd", 0) * sum(w * roofline.attention_bound_ms(B, H, N, D) for N, w in fwd)
    bound += n.get("K1-fwd-stats", 0) * roofline.attention_bound_ms(B, H, Ns, D, stats=True)
    bound += n.get("K1-bwd", 0) * roofline.attention_bwd_bound_ms(B, H, Ns, D)
    return bound / ms * 100.0
