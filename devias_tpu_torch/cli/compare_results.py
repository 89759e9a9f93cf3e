"""Compare two evaluation result directories (both in the '<rank>.txt'
format) view by view: logit agreement and merged top-1 (port of
`devias_tpu/cli/compare_results.py` on the port's own `eval/merge.py`).

    python -m devias_tpu_torch.cli.compare_results DIR_A DIR_B \\
        [--num_tasks_a 1] [--num_tasks_b 8] [--rtol 1e-3]

The checkpoint-parity harness: run one checkpoint through two
implementations' final test (the port's, the JAX package's, the
reference's), then diff here. `main` prints the comparison and returns
the absolute top-1 difference.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from devias_tpu_torch.eval.merge import merge_results, parse_result_file, softmax_np


def load_views(path: str, num_tasks: int) -> dict:
    """{(name, chunk, split): (logits, label)} over the `num_tasks` result
    files of `path`."""
    views = {}
    for r in range(num_tasks):
        for name, data, label, chunk, split in parse_result_file(os.path.join(path, f"{r}.txt")):
            views[(name, chunk, split)] = (data, int(label))
    return views


def main(argv=None) -> float:
    p = argparse.ArgumentParser("compare eval result files")
    p.add_argument("dir_a")
    p.add_argument("dir_b")
    p.add_argument("--num_tasks_a", type=int, default=1)
    p.add_argument("--num_tasks_b", type=int, default=1)
    p.add_argument("--rtol", type=float, default=1e-3)
    args = p.parse_args(argv)

    a = load_views(args.dir_a, args.num_tasks_a)
    b = load_views(args.dir_b, args.num_tasks_b)
    common = sorted(set(a) & set(b))
    only_a, only_b = len(a) - len(common), len(b) - len(common)
    print(f"views: {len(common)} common, {only_a} only in A, {only_b} only in B")

    if common:
        max_rel = 0.0
        agree = prob_l1 = 0.0
        label_mismatch = 0
        for key in common:
            la, yla = a[key]
            lb, ylb = b[key]
            if yla != ylb:
                label_mismatch += 1
            denom = np.maximum(np.abs(la), np.abs(lb)).max() + 1e-9
            max_rel = max(max_rel, float(np.abs(la - lb).max() / denom))
            agree += float(np.argmax(la) == np.argmax(lb))
            prob_l1 += float(np.abs(softmax_np(la) - softmax_np(lb)).sum())
        n = len(common)
        print(f"per-view argmax agreement: {agree / n * 100:.2f}%")
        print(f"max relative logit diff:   {max_rel:.2e}")
        print(f"mean softmax L1 diff:      {prob_l1 / n:.2e}")
        print(f"label mismatches:          {label_mismatch}")

    t1a, t5a = merge_results(args.dir_a, args.num_tasks_a)
    t1b, t5b = merge_results(args.dir_b, args.num_tasks_b)
    print(f"A merged top-1/top-5: {t1a:.3f} / {t5a:.3f}")
    print(f"B merged top-1/top-5: {t1b:.3f} / {t5b:.3f}")
    print(f"top-1 delta: {abs(t1a - t1b):.3f} (parity budget 0.3, BASELINE.md)")
    return abs(t1a - t1b)


if __name__ == "__main__":
    main()
