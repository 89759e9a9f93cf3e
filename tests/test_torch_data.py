"""The port's data pipeline against the JAX package's: synthetic
`VideoDataset` train, validation and test items for the same `DataConfig`,
aug seed, epoch and index; the frame samplers; the filelist formats; the
loader's seeded shuffle and shards; the device prefetch's order on the CPU;
and that `import devias_tpu_torch` needs neither cv2 nor PIL.

Both packages send some RandAugment ops to a C++ core: the JAX package to
its `native/augment_core.cpp` library, the port to its own copy
(`devias_tpu_torch/data/native_augment.py`). The train items are held
bitwise with both cores on, and with both switched off in this process,
where both sides run the same cv2 and numpy arithmetic; the other tests
switch both off.
"""

import subprocess
import sys

import numpy as np
import pytest
import torch

from devias_tpu.data import datasets as jax_datasets
from devias_tpu.data import loader as jax_loader
from devias_tpu.data import native_augment
from devias_tpu_torch.data import native_augment as port_native_augment
from devias_tpu.data import samplers as jax_samplers
from devias_tpu.data.filelist import read_filelist as jax_read_filelist
from devias_tpu_torch.data import DataConfig, DataLoader, build_dataset, device_prefetch, read_filelist
from devias_tpu_torch.data import samplers


def switch_off_augment_cores(monkeypatch):
    """The JAX package's and the port's C++ augment cores off, so both
    sides take their numpy/cv2 path."""
    for module in (native_augment, port_native_augment):
        monkeypatch.setattr(module, "_LIB", None)
        monkeypatch.setattr(module, "_SEARCHED", True)


@pytest.fixture
def no_native_augment(monkeypatch):
    switch_off_augment_cores(monkeypatch)


@pytest.fixture(scope="module")
def filelists(tmp_path_factory):
    d = tmp_path_factory.mktemp("fl")
    for name, n in (("train.csv", 12), ("val.csv", 4), ("test.csv", 3)):
        (d / name).write_text("\n".join(f"v{name[0]}{i}.mp4 {i % 5}" for i in range(n)))
    return str(d)


CFGS = {
    "float": dict(reprob=0.25, num_sample=2),
    "uint8": dict(reprob=0.0, num_sample=1, host_normalize=False),
    "bilinear": dict(reprob=0.0, num_sample=1, train_interpolation="bilinear", aa="rand-m9-n4-mstd0.5-inc1"),
}


def _cfg(kind, filelists, jax_side):
    kw = dict(data_set="UCF101", data_path=filelists, synthetic=True, num_frames=8, sampling_rate=2, input_size=64,
              short_side_size=64, test_num_segment=2, test_num_crop=2, nb_classes=5, **CFGS[kind])
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


@pytest.mark.parametrize("kind,cores", [pytest.param(k, False, id=k) for k in sorted(CFGS)]
                         + [pytest.param(k, True, id=f"{k}-cores_on") for k in sorted(CFGS)])
def test_train_items_bitwise_equal(kind, cores, filelists, monkeypatch):
    """Twelve clips over two epochs: the RandAugment op draws, the crop,
    flip and erase draws and the frame window all come from the
    per-(aug_seed, epoch, index) streams. With `cores` both packages run
    their C++ augment cores (AutoContrast, Equalize, Color, Contrast,
    Sharpness and the shear/translate warps); without, their cv2 paths."""
    if cores:
        assert native_augment.has_sharpness() and port_native_augment.has_sharpness()
    else:
        switch_off_augment_cores(monkeypatch)
    mine, _ = build_dataset(True, False, _cfg(kind, filelists, False))
    ref, _ = jax_datasets.build_dataset(True, False, _cfg(kind, filelists, True))
    for epoch in (0, 3):
        mine.set_epoch(epoch)
        ref.set_epoch(epoch)
        for index in range(6):
            _same_item(mine[index], ref[index])


@pytest.mark.parametrize("test_mode", [False, True])
def test_val_and_test_items_bitwise_equal(test_mode, filelists):
    mine, nb = build_dataset(False, test_mode, _cfg("float", filelists, False))
    ref, nb_ref = jax_datasets.build_dataset(False, test_mode, _cfg("float", filelists, True))
    assert len(mine) == len(ref) and nb == nb_ref
    for index in range(len(ref)):
        _same_item(mine[index], ref[index])


def test_knn_datasets_match(filelists):
    for split in (True, False):
        mine, nb = jax_datasets.knn_build_dataset(split, _cfg("float", filelists, True))
        from devias_tpu_torch.data import knn_build_dataset

        port, nb_port = knn_build_dataset(split, _cfg("float", filelists, False))
        assert nb == nb_port and len(port) == len(mine) and port.mode == mine.mode == "validation"
        _same_item(port[1], mine[1])


def test_unported_datasets_raise(filelists):
    """Every dataset of the JAX factory is ported (Places365 and the HAT
    sets since the HAT slice; their items are held to JAX's in
    `tests/test_torch_hat.py`); a name the factory does not know raises."""
    cfg = _cfg("float", filelists, False)
    cfg.data_set = "Places365"
    ds, nb = build_dataset(False, True, cfg)
    assert nb == 365 and len(ds) == 3
    cfg.data_set = "Places-365"
    with pytest.raises(ValueError, match="unknown dataset"):
        build_dataset(False, True, cfg)


def test_samplers_equal():
    for n, clip, rate in ((300, 16, 4), (40, 16, 4), (7, 8, 2), (64, 16, 4)):
        for seed in range(3):
            np.testing.assert_array_equal(
                samplers.train_window_indices(n, clip, rate, rng=np.random.default_rng(seed)),
                jax_samplers.train_window_indices(n, clip, rate, rng=np.random.default_rng(seed)))
            np.testing.assert_array_equal(
                samplers.tsn_train_indices(n, clip, rng=np.random.default_rng(seed)),
                jax_samplers.tsn_train_indices(n, clip, rng=np.random.default_rng(seed)))
            np.testing.assert_array_equal(
                samplers.activitynet_indices(n, 1.5, 9.0, 12.0, clip, rng=np.random.default_rng(seed)),
                jax_samplers.activitynet_indices(n, 1.5, 9.0, 12.0, clip, rng=np.random.default_rng(seed)))
        np.testing.assert_array_equal(samplers.test_stride_indices(n, clip, rate),
                                      jax_samplers.test_stride_indices(n, clip, rate))
        np.testing.assert_array_equal(samplers.tsn_test_indices(n, clip), jax_samplers.tsn_test_indices(n, clip))
        for chunk in range(2):
            for split in range(3):
                args = (n, (240, 320), clip, 224, chunk, split, 2, 3)
                assert samplers.test_view_offsets(*args) == jax_samplers.test_view_offsets(*args)


def test_filelist_formats_equal(tmp_path):
    rows = {"standard": "a b/c.mp4 3\nd.mp4 1", "with_length": "f 30 2\ng h 12 0",
            "hvu": "x 4 7\ny z 1 2", "activitynet": "v_a 1.5 9.0 12.0 5"}
    for fmt, text in rows.items():
        p = tmp_path / f"{fmt}.csv"
        p.write_text(text)
        assert [vars(e) for e in read_filelist(str(p), "root", fmt=fmt)] == \
            [vars(e) for e in jax_read_filelist(str(p), "root", fmt=fmt)]


class _Indices:
    """A dataset whose item i is {"videos": [i, i], "labels": i}."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"videos": np.full(2, i, np.float32), "labels": np.int64(i), "video_id": f"v{i}"}


@pytest.mark.parametrize("shuffle,drop_last,shards", [(True, True, 1), (True, True, 3), (False, False, 2)])
def test_loader_order_equals_jax(shuffle, drop_last, shards):
    for shard in range(shards):
        for epoch in (0, 2):
            kw = dict(batch_size=4, shuffle=shuffle, drop_last=drop_last, num_workers=2, seed=7, shard=shard,
                      num_shards=shards)
            mine, ref = DataLoader(_Indices(23), **kw), jax_loader.DataLoader(_Indices(23), **kw)
            mine.set_epoch(epoch)
            ref.set_epoch(epoch)
            got, want = list(mine), list(ref)
            mine.close()
            assert len(mine) == len(ref) == len(want)
            assert [b["labels"].tolist() for b in got] == [b["labels"].tolist() for b in want]
            assert [b["video_id"] for b in got] == [b["video_id"] for b in want]


def test_device_prefetch_on_cpu_keeps_order_and_raises_in_place():
    batches = [{"videos": np.full((2, 3), i, np.float32), "labels": np.arange(2) + i, "video_id": [f"a{i}", "b"]}
               for i in range(5)]
    out = list(device_prefetch(iter(batches), torch.device("cpu"), size=2))
    assert [int(b["videos"][0, 0]) for b in out] == list(range(5))
    assert all(isinstance(b["videos"], torch.Tensor) and b["videos"].device.type == "cpu" for b in out)
    assert out[3]["video_id"] == ["a3", "b"] and out[3]["labels"].tolist() == [3, 4]

    def broken():
        yield batches[0]
        raise OSError("decode failed")

    it = device_prefetch(broken(), torch.device("cpu"))
    assert int(next(it)["videos"][0, 0]) == 0
    with pytest.raises(OSError, match="decode failed"):
        next(it)


def test_import_needs_no_cv2_or_pil():
    """With cv2 and PIL hidden, the whole port imports; a transform that
    needs cv2 raises ImportError instead of running something else."""
    code = (
        "import sys\n"
        "sys.modules['cv2'] = None\nsys.modules['PIL'] = None\n"
        "import numpy as np\n"
        "import devias_tpu_torch, devias_tpu_torch.data, devias_tpu_torch.cli.run_slot_finetuning\n"
        "import devias_tpu_torch.data.fast_augment, devias_tpu_torch.data.video_reader\n"
        "from devias_tpu_torch.data import transforms\n"
        "try:\n"
        "    transforms.val_transform(np.zeros((2, 48, 64, 3), np.uint8), 32, 32)\n"
        "except ImportError:\n"
        "    print('raised')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "raised"
