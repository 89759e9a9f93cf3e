"""Evaluation protocols (port of `devias_tpu/eval/protocols.py`):
per-epoch validation, final_test with per-rank result files, and the
SCUBA and HAT loops over final_test.

Each protocol takes a `forward_fn(videos) -> logits` (an eval step from
`train/step.py`, or any callable returning a tensor or array) and a loader
of batch dicts. On `cuda` the loop is double-buffered: batch i is
dispatched before batch i-1's logits are read back, through a non-blocking
copy into pinned memory and an event.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from devias_tpu_torch.device import DeviceLike, resolve_device
from devias_tpu_torch.eval.merge import merge_results, write_result_file
from devias_tpu_torch.utils.profiling import span


def _pad_batch(videos: np.ndarray, batch_size: int):
    """Pad the last partial batch to `batch_size` rows by repeating its last
    clip; returns (padded, n_real)."""
    n = videos.shape[0]
    if n == batch_size:
        return videos, n
    pad = np.repeat(videos[-1:], batch_size - n, axis=0)
    return np.concatenate([videos, pad], axis=0), n


def _start_fetch(handles):
    """Start copying a (nested tuple of) output(s) to the host. Card tensors
    go into pinned memory without blocking, followed by one event."""
    on_card = False

    def copy(h):
        nonlocal on_card
        if isinstance(h, tuple):
            return tuple(copy(x) for x in h)
        if isinstance(h, torch.Tensor) and h.device.type == "cuda":
            host = torch.empty(h.shape, dtype=h.dtype, pin_memory=True)
            host.copy_(h, non_blocking=True)
            on_card = True
            return host
        return h

    copied = copy(handles)
    event = None
    if on_card:
        event = torch.cuda.Event()
        event.record()
    return copied, event


def _finish_fetch(fetch):
    """Wait for `_start_fetch`'s copies and return numpy arrays."""
    copied, event = fetch

    def to_np(h):
        if isinstance(h, tuple):
            return tuple(to_np(x) for x in h)
        if isinstance(h, torch.Tensor):
            h = h.detach().cpu()
            return (h.float() if h.dtype == torch.bfloat16 else h).numpy()
        return h

    with span("eval.fetch"):
        if event is not None:
            event.synchronize()
        return to_np(copied)


def _pipelined(loader, dispatch):
    """Double-buffered protocol loop: dispatch batch i's device work, then
    read back batch i-1's results while batch i computes. Yields (outputs
    as numpy, meta) in loader order, the same values as a serial loop."""
    pending = None
    for batch in loader:
        handles, meta = dispatch(batch)
        fetch = _start_fetch(handles)
        if pending is not None:
            yield _finish_fetch(pending[0]), pending[1]
        pending = (fetch, meta)
    if pending is not None:
        yield _finish_fetch(pending[0]), pending[1]


def validation_one_epoch(loader, forward_fn, batch_size: int,
                         device: DeviceLike = None) -> Dict[str, float]:
    """Top-1/top-5 and cross-entropy over the loader's center views."""
    resolve_device(device)
    correct1 = correct5 = total = 0
    loss_sum = 0.0

    def dispatch(batch):
        videos, n = _pad_batch(batch["videos"], batch_size)
        return forward_fn(videos), (batch, n)

    for out, (batch, n) in _pipelined(loader, dispatch):
        logits = np.asarray(out)[:n]
        labels = np.asarray(batch["labels"])[:n]
        order = np.argsort(-logits, axis=-1)
        correct1 += int((order[:, 0] == labels).sum())
        correct5 += int((order[:, :5] == labels[:, None]).any(axis=1).sum())
        logp = logits - np.log(np.exp(logits - logits.max(-1, keepdims=True)).sum(-1, keepdims=True)) - logits.max(-1, keepdims=True)
        loss_sum += float(-logp[np.arange(n), labels].sum())
        total += n
    return {
        "acc1": correct1 / max(total, 1) * 100,
        "acc5": correct5 / max(total, 1) * 100,
        "loss": loss_sum / max(total, 1),
    }


def final_test(loader, forward_fn, batch_size: int, output_dir: str, rank: int = 0,
               scene_label_fn: Optional[Callable] = None,
               device: DeviceLike = None) -> Dict[str, float]:
    """Run every (chunk, split) view, write '<rank>.txt' and return the
    running accuracy. With `scene_label_fn(videos) -> teacher logits` the
    targets are the teacher's argmax and `forward_fn` should return the
    scene logit slice."""
    resolve_device(device)
    ids: List[str] = []
    all_logits: List[np.ndarray] = []
    labels: List[int] = []
    chunks: List[int] = []
    splits: List[int] = []
    correct1 = correct5 = total = 0

    def dispatch(batch):
        videos, n = _pad_batch(batch["videos"], batch_size)
        handles = (
            forward_fn(videos),
            scene_label_fn(videos) if scene_label_fn is not None else None,
        )
        return handles, (batch, n)

    for (out, teacher_out), (batch, n) in _pipelined(loader, dispatch):
        logits = np.asarray(out)[:n]
        if teacher_out is not None:
            target = np.asarray(teacher_out)[:n].argmax(axis=-1)
        else:
            target = np.asarray(batch["labels"])[:n]
        ids.extend(batch["video_id"][:n])
        all_logits.append(logits)
        labels.extend(target.tolist())
        chunks.extend(np.asarray(batch["chunk"])[:n].tolist())
        splits.extend(np.asarray(batch["split"])[:n].tolist())
        order = np.argsort(-logits, axis=-1)
        correct1 += int((order[:, 0] == target).sum())
        correct5 += int((order[:, :5] == target[:, None]).any(axis=1).sum())
        total += n

    acc1 = correct1 / max(total, 1) * 100
    acc5 = correct5 / max(total, 1) * 100
    os.makedirs(output_dir, exist_ok=True)
    write_result_file(
        os.path.join(output_dir, f"{rank}.txt"),
        ids, np.concatenate(all_logits, axis=0) if all_logits else np.zeros((0, 1)),
        labels, chunks, splits, header=f"{acc1}, {acc5}",
    )
    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        # every rank writes its file before rank 0 merges
        dist.barrier()
    return {"acc1": acc1, "acc5": acc5}


def _write_log(path: str, top1: float, top5: float) -> None:
    with open(os.path.join(path, "log.txt"), "w") as f:
        f.write(json.dumps({"Final top-1": top1, "Final Top-5": top5}) + "\n")


def run_scuba(make_loader: Callable, forward_fn, batch_size: int, output_dir: str,
              scuba_variants: Sequence[str] = ("vqgan", "places365", "sinusoidal"),
              bg_forward_fn=None, bg_scene_label_fn=None, num_tasks: int = 1, rank: int = 0,
              device: DeviceLike = None) -> Dict[str, Dict[str, float]]:
    """For each SCUBA background variant: final_test on `make_loader(variant)`
    and merge into scuba/<variant>/log.txt. With `bg_forward_fn`, also the
    scene test against the teacher's argmax into scuba/<variant>_bg."""
    results = {}
    for variant in scuba_variants:
        vdir = os.path.join(output_dir, "scuba", variant)
        final_test(make_loader(variant), forward_fn, batch_size, vdir, rank=rank, device=device)
        if rank == 0:
            top1, top5 = merge_results(vdir, num_tasks)
            results[variant] = {"acc1": top1, "acc5": top5}
            _write_log(vdir, top1, top5)
        if bg_forward_fn is not None:
            bdir = os.path.join(output_dir, "scuba", f"{variant}_bg")
            final_test(make_loader(variant), bg_forward_fn, batch_size, bdir, rank=rank,
                       scene_label_fn=bg_scene_label_fn, device=device)
            if rank == 0:
                top1, top5 = merge_results(bdir, num_tasks)
                results[f"{variant}_bg"] = {"acc1": top1, "acc5": top5}
                _write_log(bdir, top1, top5)
    return results


HAT_VERSIONS = ("far", "rand", "close")
HAT_SPLITS = (1, 2, 3)


def hat_eval(make_loader: Callable, forward_fn, batch_size: int, output_dir: str,
             versions: Sequence[str] = HAT_VERSIONS, num_tasks: int = 1, rank: int = 0,
             scene_label_fn=None, device: DeviceLike = None) -> Dict[str, Dict[str, float]]:
    """For each version in {far, rand, close}: final_test on the three
    action-swap splits (`make_loader(version, split)`), a log.txt per split,
    then the mean over splits. With `scene_label_fn` this is the scene
    variant: targets are the teacher's argmax."""
    results = {}
    for ver in versions:
        per_split = []
        for split in HAT_SPLITS:
            sdir = os.path.join(output_dir, "hat", ver, str(split))
            final_test(make_loader(ver, split), forward_fn, batch_size, sdir, rank=rank,
                       scene_label_fn=scene_label_fn, device=device)
            if rank == 0:
                top1, top5 = merge_results(sdir, num_tasks)
                _write_log(sdir, top1, top5)
                per_split.append((top1, top5))
        if rank == 0:
            results[ver] = count_hat_acc(per_split)
    return results


def count_hat_acc(per_split) -> Dict[str, float]:
    """Mean over the splits."""
    top1 = float(np.mean([x[0] for x in per_split]))
    top5 = float(np.mean([x[1] for x in per_split]))
    return {"acc1": top1, "acc5": top5}
