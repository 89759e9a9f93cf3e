"""Multi-view test-result merging (port of `devias_tpu/eval/merge.py`).

Per-rank result files in the format '<id> [l0, l1, ...] <label> <chunk>
<split>', then a rank-0 merge that softmaxes each view, dedupes views by
the (chunk, split) STRING CONCAT key (a reference quirk: '1'+'2' == '12'
-- preserved), means the per-view probabilities per video, and scores
top-1/top-5. The files are byte-compatible with the JAX package's.
"""

from __future__ import annotations

import os
from typing import Dict, List, Sequence, Tuple

import numpy as np


def softmax_np(x: np.ndarray) -> np.ndarray:
    e = np.exp(x - x.max(axis=-1, keepdims=True))
    return e / e.sum(axis=-1, keepdims=True)


def write_result_file(
    path: str,
    ids: Sequence[str],
    logits: np.ndarray,
    labels: Sequence[int],
    chunks: Sequence[int],
    splits: Sequence[int],
    header: str = "0.0, 0.0",
) -> None:
    """Append-free writer for one host's results (ref final_test file dump,
    engine_for_slot.py:281-301). First line is the running-acc header the
    reference writes; the merge skips it."""
    with open(path, "w") as f:
        f.write(f"{header}\n")
        for i, vid in enumerate(ids):
            logit_str = str([float(v) for v in logits[i]])
            f.write(f"{vid} {logit_str} {int(labels[i])} {int(chunks[i])} {int(splits[i])}\n")


def parse_result_file(path: str):
    """Strict parser for '<id> [l0, l1, ...] <label> <chunk> <split>' lines.

    Raises ValueError (with file:line context) on malformed input instead of
    silently truncating — np.fromstring, which the reference's merge relies
    on, drops everything after the first bad token."""
    out = []
    with open(path) as f:
        lines = f.readlines()[1:]
    for lineno, line in enumerate(lines, start=2):
        line = line.strip()
        if not line:
            continue
        try:
            head, _, tail = line.partition("[")
            body, closed, rest = tail.partition("]")
            if not _ or not closed:
                raise ValueError("missing logit brackets")
            name = head.strip()
            fields = rest.split()
            if len(fields) != 3:
                raise ValueError(f"expected '<label> <chunk> <split>' after ']', got {rest!r}")
            label, chunk, split = fields
            int(label)  # must parse (chunk/split stay strings for the concat key)
            data = np.array([float(v) for v in body.split(",")], dtype=np.float64)
            if data.size == 0 or not np.isfinite(data).all():
                raise ValueError("empty or non-finite logit vector")
        except ValueError as exc:
            raise ValueError(f"{path}:{lineno}: malformed result line ({exc}): {line[:120]!r}") from exc
        out.append((name, data, label, chunk, split))
    return out


def merge_results(eval_path: str, num_tasks: int) -> Tuple[float, float]:
    """ref engine_for_slot.py:370-410. Returns (top1%, top5%)."""
    feats: Dict[str, List[np.ndarray]] = {}
    labels: Dict[str, str] = {}
    seen: Dict[str, List[str]] = {}
    for x in range(num_tasks):
        for name, data, label, chunk, split in parse_result_file(
            os.path.join(eval_path, f"{x}.txt")
        ):
            key = chunk + split  # string-concat dedup key (reference quirk)
            if name not in feats:
                feats[name], labels[name], seen[name] = [], "0", []
            if key in seen[name]:
                continue
            feats[name].append(softmax_np(data))
            seen[name].append(key)
            labels[name] = label
    top1, top5 = [], []
    for name, views in feats.items():
        mean = np.mean(views, axis=0)
        label = int(labels[name])
        pred = int(np.argmax(mean))
        top1.append(float(pred == label))
        top5.append(float(label in np.argsort(-mean)[:5]))
    return float(np.mean(top1) * 100), float(np.mean(top5) * 100)


def accuracy_topk(logits: np.ndarray, labels: np.ndarray, ks=(1, 5)):
    """timm-style accuracy over a batch (ref utils/utils.py accuracy use)."""
    order = np.argsort(-logits, axis=-1)
    out = []
    for k in ks:
        hit = (order[:, :k] == labels[:, None]).any(axis=1)
        out.append(float(hit.mean() * 100))
    return out
