"""k-NN disentanglement probe (port of `devias_tpu/eval/knn.py`).

ref: utils/eval/run_knn.py — extract action/scene slot features for train
and test splits, L2-normalize, then a temperature-weighted cosine k-NN
classifier, evaluated over the 4-way feature/label cross matrix
(action/action, scene/scene, action-feat x scene-labelled-test swaps) at
k in {10, 20}, T=0.07. The classifier runs on the host in numpy, as in the
JAX package.
"""

from __future__ import annotations

import os
from typing import Dict, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from devias_tpu_torch.eval.protocols import _pad_batch, _pipelined


def knn_classifier(
    train_features: np.ndarray,
    train_labels: np.ndarray,
    test_features: np.ndarray,
    test_labels: np.ndarray,
    k: int,
    T: float,
    num_classes: int = 1000,
) -> Tuple[float, float]:
    """Weighted cosine k-NN (ref run_knn.py:123-163): similarity topk,
    exp(sim/T) vote over neighbor labels."""
    n_test = test_features.shape[0]
    top1 = top5 = 0
    chunk = max(n_test // 100, 1)
    for s in range(0, n_test, chunk):
        feats = test_features[s : s + chunk]
        targets = test_labels[s : s + chunk]
        sim = feats @ train_features.T
        idx = np.argsort(-sim, axis=1)[:, :k]
        dist_k = np.take_along_axis(sim, idx, axis=1)
        neighbors = train_labels[idx]  # [b, k]
        weights = np.exp(dist_k / T)
        probs = np.zeros((feats.shape[0], num_classes))
        for c in range(feats.shape[0]):
            np.add.at(probs[c], neighbors[c], weights[c])
        order = np.argsort(-probs, axis=1)
        top1 += int((order[:, 0] == targets).sum())
        top5 += int((order[:, : min(5, k)] == targets[:, None]).any(axis=1).sum())
    return top1 * 100.0 / n_test, top5 * 100.0 / n_test


def _l2(x: np.ndarray) -> np.ndarray:
    return x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-12)


def extract_slot_features(loader, feature_fn, batch_size: int, scene_label_fn=None):
    """feature_fn(videos) -> (action_feat, scene_feat); optional
    scene_label_fn(videos) -> teacher logits for pseudo scene labels
    (ref run_knn.py:28-120). Double-buffered (`protocols._pipelined`): the
    feature download of batch i-1 overlaps batch i's forward. A last partial
    batch is padded to `batch_size` and its padding dropped. Returns
    (action feats, scene feats, action labels, scene labels or None) in
    loader order."""
    a_feats, s_feats, a_labels, s_labels = [], [], [], []

    def dispatch(batch):
        videos, n = _pad_batch(batch["videos"], batch_size)
        handles = (
            tuple(feature_fn(videos)),
            scene_label_fn(videos) if scene_label_fn is not None else None,
        )
        return handles, (batch, n)

    for ((af, sf), teacher_out), (batch, n) in _pipelined(loader, dispatch):
        a_feats.append(np.asarray(af)[:n])
        s_feats.append(np.asarray(sf)[:n])
        a_labels.append(np.asarray(batch["labels"])[:n])
        if teacher_out is not None:
            s_labels.append(np.asarray(teacher_out)[:n].argmax(axis=-1))
        elif "scene_labels" in batch:
            s_labels.append(np.asarray(batch["scene_labels"])[:n])
    return (
        np.concatenate(a_feats),
        np.concatenate(s_feats),
        np.concatenate(a_labels),
        np.concatenate(s_labels) if s_labels else None,
    )


def gather_features_across_hosts(*arrays, n_total: int, local_indices: np.ndarray):
    """Assemble per-process feature shards into the full bank on every
    process (ref run_knn.py:72-119 all-gathers the features and
    index_copy_'s them into a [len(dataset), D] bank): each process's rows
    are scattered to their dataset indices (`local_indices`) in a bank of
    `n_total` rows, so the duplicate rows of padded shards collapse as the
    reference's index_copy_ does. A no-op in one process. The arrays live
    on the host, so they travel as pickled objects (`all_gather_object`),
    which every backend carries."""
    if not (dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1):
        return arrays if len(arrays) > 1 else arrays[0]
    shards = [None] * dist.get_world_size()
    dist.all_gather_object(shards, (local_indices, arrays))
    idx_all = np.concatenate([np.asarray(idx) for idx, _ in shards])

    def assemble(i):
        if arrays[i] is None:
            return None
        rows = np.concatenate([a[i] for _, a in shards])
        bank = np.zeros((n_total,) + rows.shape[1:], rows.dtype)
        bank[idx_all] = rows  # duplicate indices overwrite with identical rows
        return bank

    out = tuple(assemble(i) for i in range(len(arrays)))
    return out if len(out) > 1 else out[0]


def save_knn_features(output_dir: str, data_set: str, banks: Dict[str, np.ndarray]):
    """Dump extracted feature banks as `{data_set}_{name}.pth` tensors (ref
    run_knn.py:230-237 saves 8 per dataset)."""
    os.makedirs(output_dir, exist_ok=True)
    for name, arr in banks.items():
        if arr is None:
            continue
        torch.save(torch.from_numpy(np.ascontiguousarray(arr)), os.path.join(output_dir, f"{data_set}_{name}.pth"))


def run_knn_matrix(
    train_action, train_scene, train_action_labels, train_scene_labels,
    test_action, test_scene, test_action_labels, test_scene_labels,
    nb_knn: Sequence[int] = (10, 20),
    temperature: float = 0.07,
    num_action_classes: int = 1000,
    num_scene_classes: int = 1000,
) -> Dict[str, Dict[int, Tuple[float, float]]]:
    """The 4-way cross matrix (ref run_knn.py:241-268)."""
    train_action = _l2(train_action)
    train_scene = _l2(train_scene)
    test_action = _l2(test_action)
    test_scene = _l2(test_scene)
    cells = {
        "action_feat/action_label": (train_action, train_action_labels, test_action, test_action_labels, num_action_classes),
        "scene_feat/scene_label": (train_scene, train_scene_labels, test_scene, test_scene_labels, num_scene_classes),
        "action_train/scene_test_feat": (train_action, train_action_labels, test_scene, test_action_labels, num_action_classes),
        "scene_train/action_test_feat": (train_scene, train_scene_labels, test_action, test_scene_labels, num_scene_classes),
    }
    out: Dict[str, Dict[int, Tuple[float, float]]] = {}
    for name, (trf, trl, tef, tel, nc) in cells.items():
        out[name] = {}
        for k in nb_knn:
            out[name][k] = knn_classifier(trf, trl, tef, tel, k, temperature, nc)
    return out
