#!/usr/bin/env python3
"""The readings the SegFormer mask step's limits are set from, on one GPU.

    python3 benchmark/control_mask.py --workload slot-k400-segformer-train --seeds S1 S2 ... [--controls K]

For each seed, the program's compared numbers against the plain reference
(the lower reading): the train step's (`harness/entries.py::train_gaps`)
and the mask model's (`entries/slot_segformer_train.py::mask_gaps`). For
the first K seeds also the control's, the reference computed with float8
(e4m3) products in the SegFormer, the student and the teacher, and the
planted faults': the masks of the odd frames in place of the even ones, a
mix with no mask, half of each batch left out. Each beside the reference
logits' standard deviation, the share of person pixels, the person bias's
raise and the near-ties of the first step. One JSON line per seed and
reading; the benchmark's runs never run this (`control.py` does the same
for the cells whose check has no mask model).
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

READINGS = (("control_fp8", {"quant": "fp8"}), ("fault_odd_frames", {"fault": "odd_frames"}),
            ("fault_no_mask", {"fault": "no_mask"}), ("fault_half_batch", {"half": True}))


def reading(entries, mask_gaps, seed, name, prog, prog_mask, ref) -> dict:
    leaves = entries.moved_leaves(ref)
    masks = prog_mask["masks"]
    return {"seed": seed, "reading": name, **entries.train_gaps(prog, ref), **mask_gaps(prog_mask, ref["mask"]),
            "sigma": ref["mask"]["sigma"], "person_share": sum(float(m.float().mean()) for m in masks) / len(masks),
            "teacher_margins": ref.get("teacher_margins"), "ref_margins": ref["margins"],
            "near_ties": [t["sample"] for t in ref["first_step"]["near"]],
            "swapped": entries.resolve_near_ties(prog, ref, leaves)["swapped"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="control and fault readings of the SegFormer mask step")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--controls", type=int, default=3, help="seeds (the first ones) that also run the control")
    args = ap.parse_args(argv)
    set_caches()
    import torch

    from harness import entries, spec

    if not torch.cuda.is_available():
        print("control_mask.py: no CUDA device", file=sys.stderr)
        return 3
    cell = spec.load_cell(args.workload)
    module = spec.entry(cell.traffic["entry"])
    device = torch.device("cuda", 0)
    for k, seed in enumerate(args.seeds):
        t0 = time.perf_counter()
        entry = module.make(cell.config, cell.traffic, seed, device)
        entry.setup()
        entry.release()
        with entries.reference_precision():
            ref = entry.reference_readings()
            line = reading(entries, module.mask_gaps, seed, "program", entry.readings, entry.mask, ref)
            print(json.dumps({**line, "person_raise": entry.person_raise}), flush=True)
            for name, kw in READINGS if k < args.controls else ():
                got = entry.reference_readings(**kw)
                print(json.dumps(reading(entries, module.mask_gaps, seed, name, got, got["mask"], ref)), flush=True)
        del entry, ref
        torch.cuda.empty_cache()
        print(f"control_mask.py: seed {seed} took {time.perf_counter() - t0:.1f} s", file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
