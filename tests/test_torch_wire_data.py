"""The host side of the I420 wire (`DataConfig.wire_format='yuv420'`,
`data/yuv.py::rgb_clip_to_i420`) against the JAX package's: synthetic
`VideoDataset` train (one and two samples a clip), validation and test
items for the same config, aug seed, epoch and index, bitwise, both
packages' C++ augment cores off (their cv2 paths); the packing itself
bitwise on random clips and its refusal of odd sizes; and the refusal of
`host_normalize=True` where JAX refuses it (train and validation; a test
item normalises and ships RGB floats in both)."""

import numpy as np
import pytest

from devias_tpu.data import datasets as jax_datasets
from devias_tpu.data import native_augment
from devias_tpu.data import yuv as jax_yuv
from devias_tpu_torch.data import DataConfig, build_dataset
from devias_tpu_torch.data import native_augment as port_native_augment
from devias_tpu_torch.data import yuv


@pytest.fixture(autouse=True)
def no_native_augment(monkeypatch):
    for module in (native_augment, port_native_augment):
        monkeypatch.setattr(module, "_LIB", None)
        monkeypatch.setattr(module, "_SEARCHED", True)


@pytest.fixture(scope="module")
def filelists(tmp_path_factory):
    d = tmp_path_factory.mktemp("fl")
    for name, n in (("train.csv", 6), ("val.csv", 3), ("test.csv", 2)):
        (d / name).write_text("\n".join(f"v{name[0]}{i}.mp4 {i % 5}" for i in range(n)))
    return str(d)


def _cfg(filelists, jax_side, **kw):
    kw = dict(dict(data_set="UCF101", data_path=filelists, synthetic=True, num_frames=8, sampling_rate=2,
                   input_size=64, short_side_size=64, test_num_segment=2, test_num_crop=2, nb_classes=5,
                   host_normalize=False, wire_format="yuv420"), **kw)
    return (jax_datasets.DataConfig if jax_side else DataConfig)(**kw)


def _same_item(got, want):
    assert set(got) == set(want)
    for k in want:
        if isinstance(want[k], str):
            assert got[k] == want[k]
        else:
            a, b = np.asarray(got[k]), np.asarray(want[k])
            assert a.dtype == b.dtype and a.shape == b.shape, k
            np.testing.assert_array_equal(a, b, err_msg=k)


@pytest.mark.parametrize("num_sample", [1, 2])
def test_train_items_bitwise_equal(filelists, num_sample):
    mine, _ = build_dataset(True, False, _cfg(filelists, False, num_sample=num_sample))
    ref, _ = jax_datasets.build_dataset(True, False, _cfg(filelists, True, num_sample=num_sample))
    for epoch in (0, 3):
        mine.set_epoch(epoch)
        ref.set_epoch(epoch)
        for index in range(3):
            item = mine[index]
            assert item["videos"].dtype == np.uint8 and item["videos"].shape[-2:] == (96, 64)
            _same_item(item, ref[index])


@pytest.mark.parametrize("test_mode", [False, True], ids=["validation", "test"])
def test_val_and_test_items_bitwise_equal(filelists, test_mode):
    mine, nb = build_dataset(False, test_mode, _cfg(filelists, False))
    ref, nb_ref = jax_datasets.build_dataset(False, test_mode, _cfg(filelists, True))
    assert len(mine) == len(ref) and nb == nb_ref
    for index in range(len(ref)):
        item = mine[index]
        assert item["videos"].dtype == np.uint8 and item["videos"].shape == (8, 96, 64)
        _same_item(item, ref[index])


def test_rgb_clip_to_i420_is_jax_bitwise():
    clip = np.random.default_rng(0).integers(0, 256, size=(3, 6, 10, 3), dtype=np.uint8)
    got = yuv.rgb_clip_to_i420(clip)
    assert got.shape == (3, 9, 10) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, jax_yuv.rgb_clip_to_i420(clip))
    for odd in ((2, 5, 10, 3), (2, 6, 7, 3)):
        with pytest.raises(ValueError, match="even"):
            yuv.rgb_clip_to_i420(np.zeros(odd, np.uint8))


def test_host_normalize_refusal_matches_jax(filelists):
    for is_train, test_mode in ((True, False), (False, False)):
        mine, _ = build_dataset(is_train, test_mode, _cfg(filelists, False, host_normalize=True))
        ref, _ = jax_datasets.build_dataset(is_train, test_mode, _cfg(filelists, True, host_normalize=True))
        for ds in (mine, ref):
            with pytest.raises(ValueError, match="host_normalize=False"):
                ds[0]
    mine, _ = build_dataset(False, True, _cfg(filelists, False, host_normalize=True))
    ref, _ = jax_datasets.build_dataset(False, True, _cfg(filelists, True, host_normalize=True))
    assert mine[0]["videos"].dtype == np.float32
    _same_item(mine[0], ref[0])
