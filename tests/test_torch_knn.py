"""The port's k-NN probe (`eval/knn.py`) against the JAX package's: the
weighted cosine classifier and the 4-way cross matrix on the same numpy
banks give the same numbers, and feature extraction returns the banks in
loader order with the last batch's padding dropped."""

import numpy as np
import pytest
import torch

from devias_tpu.eval import knn as jax_knn
from devias_tpu_torch.eval import knn


def _banks(seed=0, n_train=40, n_test=17, dim=24):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n_train, dim)).astype(np.float32), rng.normal(size=(n_train, dim)).astype(np.float32),
            rng.integers(0, 6, n_train), rng.integers(0, 9, n_train),
            rng.normal(size=(n_test, dim)).astype(np.float32), rng.normal(size=(n_test, dim)).astype(np.float32),
            rng.integers(0, 6, n_test), rng.integers(0, 9, n_test))


@pytest.mark.parametrize("k", [1, 3, 10])
def test_knn_classifier_equals_jax(k):
    tra, _, tral, _, tea, _, teal, _ = _banks(k)
    tra, tea = knn._l2(tra), knn._l2(tea)
    assert knn.knn_classifier(tra, tral, tea, teal, k, 0.07, 6) == \
        jax_knn.knn_classifier(tra, tral, tea, teal, k, 0.07, 6)


def test_knn_matrix_equals_jax():
    banks = _banks(5)
    kw = dict(nb_knn=(3, 10), temperature=0.07, num_action_classes=6, num_scene_classes=9)
    assert knn.run_knn_matrix(*banks, **kw) == jax_knn.run_knn_matrix(*banks, **kw)


def _loader(n=11, batch=4, scene_labels=False):
    rng = np.random.default_rng(3)
    clips = rng.normal(size=(n, 2, 4, 4, 3)).astype(np.float32)
    out = []
    for s in range(0, n, batch):
        b = {"videos": clips[s:s + batch], "labels": np.arange(s, min(s + batch, n))}
        if scene_labels:
            b["scene_labels"] = 100 + b["labels"]
        out.append(b)
    return out, clips


def _feature_fn(videos):
    x = torch.as_tensor(videos)
    return x.mean(dim=(1, 2, 3)), x.amax(dim=(1, 2, 3))


def _teacher_fn(videos):
    return np.asarray(videos).reshape(len(videos), -1)[:, :5]


def test_extract_slot_features_in_order_with_padding_dropped():
    loader, clips = _loader()
    a, s, al, sl = knn.extract_slot_features(loader, _feature_fn, 4, scene_label_fn=_teacher_fn)
    flat = torch.from_numpy(clips)
    np.testing.assert_array_equal(a, flat.mean(dim=(1, 2, 3)).numpy())
    np.testing.assert_array_equal(s, flat.amax(dim=(1, 2, 3)).numpy())
    np.testing.assert_array_equal(al, np.arange(11))
    np.testing.assert_array_equal(sl, clips.reshape(11, -1)[:, :5].argmax(-1))
    # the JAX package's extraction on the same loader and functions
    jax_out = jax_knn.extract_slot_features(loader, lambda v: tuple(t.numpy() for t in _feature_fn(v)), 4,
                                            scene_label_fn=_teacher_fn)
    for got, want in zip((a, s, al, sl), jax_out):
        np.testing.assert_array_equal(got, want)


def test_extract_slot_features_scene_labels_from_batches():
    loader, _ = _loader(scene_labels=True)
    *_, sl = knn.extract_slot_features(loader, _feature_fn, 4)
    np.testing.assert_array_equal(sl, 100 + np.arange(11))
    loader, _ = _loader()
    assert knn.extract_slot_features(loader, _feature_fn, 4)[3] is None


def test_save_knn_features(tmp_path):
    knn.save_knn_features(str(tmp_path), "UCF101", {"train_action_labels": np.arange(3), "test_scene_labels": None})
    assert torch.load(tmp_path / "UCF101_train_action_labels.pth").tolist() == [0, 1, 2]
    assert not (tmp_path / "UCF101_test_scene_labels.pth").exists()
