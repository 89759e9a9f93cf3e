"""Profile the flagship train step and aggregate the card's kernel times
(port of `scripts/profile_step.py`).

Traces the flagship slot step (FAME, the frozen teacher's forward, the
slot student's forward and backward, the loss, AdamW) with
`torch.profiler` through `utils/profiling.py::profile_trace`, then reads
the exported Chrome trace's CUDA kernel, copy and set events and prints
the card's ms per step, ms per step by kernel family (`KERNEL_CLASSES`),
the top kernels with their launches per step, the tail below them
grouped by name prefix, and the card's ms per step by program span
(`utils/profiling.py::SPANS`) and family: each kernel, copy or set goes
to the innermost span whose host range holds its launch, found through
the trace's correlation ids (the trace's `gpu_user_annotation` ranges
hold only what the span's own thread launched, and so none of the
backward's kernels, which autograd's thread launches). `--segformer`
swaps FAME for the frozen B3 mask model (random weights; `--mask_model
Segformer`).

    python -m devias_tpu_torch.scripts.profile_step [--steps 5] [--out DIR] [--aggregate_only]
        [--top 60] [--segformer] [--device cpu]

`--aggregate_only` re-reads the newest trace under `--out`. The family
table and `profile_breakdown` (the same classes, read in-process from
`torch.profiler`'s events) are also what `chip_smoke.py`'s profile phases
use.
"""

from __future__ import annotations

import argparse
import collections
import glob
import json
import os
import re
import tempfile
import time

import numpy as np
import torch

from devias_tpu_torch.aug import FAMEConfig
from devias_tpu_torch.device import DeviceLike, resolve_device
from devias_tpu_torch.losses import SlotLossConfig
from devias_tpu_torch.nn import create_model
from devias_tpu_torch.nn.segformer import create_segformer, segformer_b3
from devias_tpu_torch.train import OptimConfig, TrainState, TrainStepConfig, make_optimizer, make_slot_train_step
from devias_tpu_torch.utils.profiling import SPANS, profile_trace

BATCH = 12
WARMUP_STEPS = 3
# kernel classes of the profile, by substring of the kernel's name, first match
KERNEL_CLASSES = (
    ("attention (port's K1 and K2 kernels)", ("attention_fwd_kernel", "attention_bwd_")),
    ("GEMM (cuBLAS)", ("nvjet", "gemm", "sm90_xmma", "cutlass", "gemv", "splitKreduce")),
    ("copy", ("Memcpy", "Memset", "copy_", "CatArrayBatched")),
    ("reduction", ("reduce_kernel", "Reduce", "softmax", "norm")),
    ("elementwise", ("elementwise", "vectorized")),
)
# the Chrome trace's categories of work on the card
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
# the host's launches of the card's work
LAUNCH_CATEGORIES = ("cuda_runtime", "cuda_driver")
# the card's work that no program span launched
NO_SPAN = "(no span)"


def kernel_class(name: str) -> str:
    """The first class of KERNEL_CLASSES with a key in `name`, else "other"."""
    return next((label for label, keys in KERNEL_CLASSES if any(k in name for k in keys)), "other")


def name_prefix(name: str) -> str:
    """A kernel name without "void ", anonymous namespaces, template
    arguments, parameters and numbered suffixes: the tail's grouping key."""
    bare = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    return re.split(r"[<(]|_\d", bare)[0].strip() or name


def profile_breakdown(fn, n: int) -> dict:
    """Run fn() n times under torch.profiler. Per call: host-clock ms, the
    device's busy ms (union of its kernel and copy intervals) and idle
    share, device ms by KERNEL_CLASSES, the ten kernels with the most
    device time and the ten host operators with the most self CPU time
    (under the profiler, which adds its own to each)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    spans, by_name = [], {}
    for e in prof.events():
        # GPU-side annotation ranges (`Optimizer.step#...`) span kernels
        # counted on their own
        if e.device_type != DeviceType.CUDA or getattr(e, "is_user_annotation", False):
            continue
        start, end = e.time_range.start, e.time_range.end
        spans.append((start, end))
        total, count = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (total + (end - start) / 1e3, count + 1)
    busy_us, reach = 0.0, None
    for start, end in sorted(spans):
        if reach is None or start > reach:
            busy_us += end - start
            reach = end
        elif end > reach:
            busy_us += end - reach
            reach = end
    classes = {label: 0.0 for label, _ in KERNEL_CLASSES}
    classes["other"] = 0.0
    for name, (ms, _) in by_name.items():
        classes[kernel_class(name)] += ms / n
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    busy_ms = busy_us / 1e3 / n
    host = sorted((e for e in prof.key_averages() if e.self_cpu_time_total > 0),
                  key=lambda e: -e.self_cpu_time_total)[:10]
    return {"calls": n, "wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": 1.0 - busy_ms / wall_ms if spans else None,
            "device_ms_by_class": classes,
            "top_kernels": [{"name": name[:120], "ms": ms / n, "launches": c / n} for name, (ms, c) in top],
            "top_host_ops": [{"name": e.key[:80], "self_cpu_ms": e.self_cpu_time_total / 1e3 / n,
                              "calls": e.count / n} for e in host]}


def build_step(segformer: bool = False, device: DeviceLike = None):
    """The flagship slot step as the JAX script builds it (`:44-84`): the
    slot student (400 + 365 head, 2 latents, 8 tied agg rounds) and the CLS
    teacher at 365 classes, bf16, K1, the patchify embed; AdamW lr 5e-4
    over 1000 steps with 10 of warm-up; FAME (beta 0.5, prob_aug 0.8), or
    with `segformer` the B3 mask model on random weights and no FAME. Returns
    (step, state, batch of 12 seeded N(0, 1) clips)."""
    dev = resolve_device(device)
    kw = dict(device=dev, dtype=torch.bfloat16, fused_attention=True, patch_embed_mode="patchify")
    model = create_model("slot_vit_base_patch16_224", seed=0, num_classes=400, num_scene_classes=365, num_latents=2,
                         agg_depth=8, agg_weights_tie=True, **kw)
    teacher = create_model("vit_base_patch16_224", seed=1, num_classes=365, use_mean_pooling=False, **kw)
    opt, lr_fn = make_optimizer(model, OptimConfig(lr=5e-4, total_steps=1000, warmup_steps=10), device=dev)
    state = TrainState.create(model, opt, device=dev)
    seg = create_segformer(segformer_b3(), device=dev, seed=2, dtype=torch.bfloat16) if segformer else None
    step = make_slot_train_step(
        model, teacher, opt, SlotLossConfig(num_action_classes=400, num_scene_classes=365),
        TrainStepConfig(use_fame=not segformer, fame=FAMEConfig(beta=0.5, prob_aug=0.8)),
        lr_fn, segformer_apply=seg, device=dev,
    )
    rng = np.random.default_rng(0)
    batch = {"videos": torch.from_numpy(rng.normal(size=(BATCH, 16, 224, 224, 3)).astype(np.float32)).to(dev),
             "labels": torch.from_numpy(rng.integers(0, 400, size=BATCH)).to(dev)}
    return step, state, batch


def run_and_trace(out_dir: str, steps: int, segformer: bool = False, device: DeviceLike = None) -> None:
    """WARMUP_STEPS steps of `build_step`'s step, then `steps` more under
    `profile_trace(out_dir)`, each closed by fetching the loss."""
    dev = resolve_device(device)
    step, state, batch = build_step(segformer, dev)
    for _ in range(WARMUP_STEPS):
        metrics = step(state, batch)
    float(metrics["loss"])
    with profile_trace(out_dir, device=dev):
        for _ in range(steps):
            metrics = step(state, batch)
        float(metrics["loss"])


def innermost_span(ranges: list, ts: float) -> str:
    """The name of the innermost of `ranges` ((start, end, name), sorted by
    start, the longer first at one start) that holds `ts`: of those holding
    it, the last in that order; NO_SPAN for none or a `ts` of None."""
    name = NO_SPAN
    if ts is None:
        return name
    for start, end, n in ranges:
        if start > ts:
            break
        if ts < end:
            name = n
    return name


def aggregate(out_dir: str, steps: int, top: int = 60) -> dict:
    """Read the newest trace under `out_dir` and print the card's ms per
    step, by family, the `top` kernels (ms and launches per step), the
    tail below them by `name_prefix`, and by program span and family (each
    kernel under the innermost span whose host range holds its launch).
    Returns the same numbers."""
    files = glob.glob(os.path.join(out_dir, "**", "*.json"), recursive=True)
    if not files:
        raise FileNotFoundError(f"no trace json under {out_dir}")
    path = max(files, key=os.path.getmtime)
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    per_op, per_op_n = collections.Counter(), collections.Counter()
    # the program's spans on the host, by start, the longer first where two
    # start together; the host time of each launch by correlation id
    ranges = sorted(((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                     if e.get("ph") == "X" and e.get("cat") == "user_annotation" and e.get("name") in SPANS),
                    key=lambda r: (r[0], -r[1]))
    launched = {e["args"]["correlation"]: e["ts"] for e in events
                if e.get("cat") in LAUNCH_CATEGORIES and "correlation" in e.get("args", {})}
    by_span = collections.defaultdict(collections.Counter)
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in DEVICE_CATEGORIES and "dur" in e:
            per_op[e["name"]] += e["dur"]
            per_op_n[e["name"]] += 1
            launch = launched.get(e.get("args", {}).get("correlation"))
            by_span[innermost_span(ranges, launch)][kernel_class(e["name"])] += e["dur"]

    def ms(us):
        return us / 1000 / steps

    total_us = sum(per_op.values())
    print(f"trace: {path}")
    print(f"device total: {ms(total_us):.2f} ms/step over {steps} steps\n")

    fam = collections.Counter()
    for name, us in per_op.items():
        fam[kernel_class(name)] += us
    print("== per family (ms/step) ==")
    for k, us in fam.most_common():
        print(f"  {k:38s} {ms(us):8.2f}")

    print("\n== top kernels (ms/step, launches/step) ==")
    shown = per_op.most_common(top)
    for name, us in shown:
        print(f"  {ms(us):8.3f}  x{per_op_n[name] / steps:6.1f}  {name[:120]}")

    # the tail: everything below the top list, grouped by name prefix
    tail, tail_n = collections.Counter(), collections.Counter()
    shown_names = {name for name, _ in shown}
    for name, us in per_op.items():
        if name in shown_names:
            continue
        tail[name_prefix(name)] += us
        tail_n[name_prefix(name)] += per_op_n[name]
    print(f"\n== tail (below top {top}): {ms(sum(tail.values())):.2f} ms/step ==")
    for pref, us in tail.most_common(30):
        print(f"  {ms(us):8.3f}  x{tail_n[pref] / steps:6.1f}  {pref}")

    families = [k for k, _ in fam.most_common()]
    print("\n== by program span (ms/step): " + ", ".join(families) + " ==")
    for name, cls in sorted(by_span.items(), key=lambda kv: -sum(kv[1].values())):
        print(f"  {name:16s} {ms(sum(cls.values())):8.2f}  " + " ".join(f"{ms(cls[k]):8.2f}" for k in families))
    return {"trace": path, "steps": steps, "device_ms_per_step": ms(total_us),
            "ms_per_step_by_family": {k: ms(us) for k, us in fam.items()},
            "top": [{"name": n, "ms": ms(us), "launches": per_op_n[n] / steps} for n, us in shown],
            "tail_ms_per_step": ms(sum(tail.values())),
            "tail": [{"prefix": p, "ms": ms(us), "launches": tail_n[p] / steps} for p, us in tail.most_common()],
            "ms_per_step_by_span": {name: {k: ms(us) for k, us in cls.items()} for name, cls in by_span.items()}}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="trace the flagship train step and aggregate its kernel times")
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(), "prof_step"))
    ap.add_argument("--aggregate_only", action="store_true")
    ap.add_argument("--top", type=int, default=60)
    ap.add_argument("--segformer", action="store_true",
                    help="profile the frozen-MiT-B3 mask-model step instead of the FAME step")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    if not args.aggregate_only:
        run_and_trace(args.out, args.steps, segformer=args.segformer, device=args.device)
    return aggregate(args.out, args.steps, args.top)


if __name__ == "__main__":
    main()
