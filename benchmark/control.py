#!/usr/bin/env python3
"""The readings a cell's correctness limits are set from, on one GPU.

    python3 benchmark/control.py --workload <cell> --seeds S1 S2 ... [--controls K] [--seconds S]

For each seed, the program's compared numbers against the plain reference
(the lower reading: sound runs). For the first K seeds also the control's,
the reference computed with float8 (e4m3) dense products put in the
program's place, and the planted faults'. Train cells: half of each batch
left out, the mean taken over the rest, planted in the reference (a state
left unchanged reads 1 on change_gap by construction and is not run); the
worst leaves of each reading. The eval cell: the reference in the
program's place writing slot 0's logits for every clip (`wrong_slot`) or
the class after the teacher's argmax (`label_altered`), with each sampled
clip's gap between its two slots' selection criteria. One JSON line per
seed and reading; the benchmark's runs never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(BENCH_DIR), BENCH_DIR]

from run import set_caches  # noqa: E402

WORST = 3


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def _train_reading(entries, seed, name, got, ref):
    leaves = entries.moved_leaves(ref)
    worst = {}
    for key in ("grad_norms", "change_norms"):
        gaps = entries.leaf_gaps(got[key], ref[key], leaves)
        worst[key] = [[k, gaps[k], ref[key][k]] for k in sorted(gaps, key=gaps.get, reverse=True)[:WORST]]
    steps = [{k: [p[k], r[k]] for k in entries.LOSS_KEYS} for p, r in zip(got["steps"], ref["steps"])]
    emit({"seed": seed, "reading": name, **entries.train_gaps(got, ref), "steps": steps, "ref_margins": ref["margins"],
          "teacher_margins": ref.get("teacher_margins"),
          "near_ties": [t["sample"] for t in ref["first_step"]["near"]],
          "swapped": entries.resolve_near_ties(got, ref, leaves)["swapped"],
          "worst": worst})


def train_readings(entry, seed: int, controls: bool) -> None:
    from harness import entries

    entry.setup()
    entry.release()
    with entries.reference_precision():
        ref = entry.reference_readings()
        _train_reading(entries, seed, "program", entry.readings, ref)
        if controls:
            _train_reading(entries, seed, "control_fp8", entry.reference_readings(quant="fp8"), ref)
            _train_reading(entries, seed, "fault_half_batch", entry.reference_readings(half=True), ref)


def eval_readings(entry, cell, seed: int, controls: bool, seconds: float) -> None:
    from harness import entries

    try:
        entry.setup()
        entry.window(seconds)
        entry.release()
        prog = entry.readings(cell.traffic.get("check_rows", 36))
        with entries.reference_precision():
            ref = entry.reference(prog["clips"])
            crit = ref["crit"].sort(dim=-1, descending=True).values
            emit({"seed": seed, "reading": "program", **entries.eval_gaps(prog, ref),
                  "crit_gaps": sorted(float(g) for g in crit[:, 0] - crit[:, 1])})
            if not controls:
                return
            for fault in ("wrong_slot", "label_altered"):
                rows = entries.reference_rows(ref, fault)
                emit({"seed": seed, "reading": f"fault_{fault}", **entries.eval_gaps({"missing": 0, "rows": rows}, ref)})
            rows = entries.reference_rows(entry.reference(prog["clips"], quant="fp8"))
            emit({"seed": seed, "reading": "control_fp8", **entries.eval_gaps({"missing": 0, "rows": rows}, ref)})
    finally:
        entry.close()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="control and fault readings of one cell")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--controls", type=int, default=3, help="seeds (the first ones) that also run the control")
    ap.add_argument("--seconds", type=float, default=3.0, help="the eval cell's window")
    args = ap.parse_args(argv)
    set_caches()
    import torch

    from harness import spec

    if not torch.cuda.is_available():
        print("control.py: no CUDA device", file=sys.stderr)
        return 3
    cell = spec.load_cell(args.workload)
    device = torch.device("cuda", 0)
    for k, seed in enumerate(args.seeds):
        t0 = time.perf_counter()
        entry = spec.entry(cell.traffic["entry"]).make(cell.config, cell.traffic, seed, device)
        if entry.kind == "eval":
            eval_readings(entry, cell, seed, k < args.controls, args.seconds)
        else:
            train_readings(entry, seed, k < args.controls)
        print(f"control.py: seed {seed} took {time.perf_counter() - t0:.1f} s", file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
