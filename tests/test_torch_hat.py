"""The port's HAT action-swap data and `--hat_eval`, and its Places365
scene probe, against the JAX package's, on synthetic assets written as
`tests/test_hat.py` writes them (frame, person-mask and inpainted
background folders plus actionswap pickles), in both layouts:

- Kinetics-HAT: original/videos/<vid>/NNNNNN.jpg, seg/videos/<vid>/NNNNNN.png,
  inpaint/videos/<vid>/NNNNNN.jpg (1-based);
- UCF101-HAT: rawframes/<cls>/<vid>/image_NNNNN.jpg (1-based),
  seg/<cls>/<vid>/img_NNNNN.png and inpaint/<cls>/<vid>/img_NNNNN.jpg
  (0-based).

Annotations, composites and every dataset mode's items must be bitwise
equal to JAX's (the train mode draws its window and augmentation from the
process's global states, seeded alike for both sides, with both
packages' C++ augment cores switched off as in `tests/test_torch_data.py`).
`--hat_eval` runs through both CLIs in float32 on exported JAX models (the
CLIs build bf16 models; the test patches each one's `build_models` dtype),
with action and with scene targets."""

import functools
import json
import os
import pickle
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from devias_tpu.cli import common as jax_common
from devias_tpu.cli import run_slot_finetuning as jax_cli
from devias_tpu.data import datasets as jax_datasets
from devias_tpu.data import hat as jax_hat
from devias_tpu.data import native_augment
from devias_tpu_torch.cli import common
from devias_tpu_torch.cli import run_slot_finetuning as cli
from devias_tpu_torch.data import DataConfig, build_dataset, knn_build_dataset
from devias_tpu_torch.data import hat
from devias_tpu_torch.data import native_augment as port_native_augment
from devias_tpu_torch.eval import merge_results, parse_result_file

N_FRAMES, H, W = 16, 64, 80
# (fg class, fg video, person box, bg video); bg0's person stands at
# (30, 40), bg1's at (12, 50)
RECORDS = (("classB", "fg0", (10, 20), "bg0"), ("classD", "fg1", (40, 8), "bg1"), ("classA", "fg2", (24, 60), "bg0"))
CLASSES = ("classA", "classB", "classC", "classD", "classE")


def _write_video(fdir, mdir, frame_name, mask_name, color, box):
    fdir.mkdir(parents=True, exist_ok=True)
    mdir.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(color)
    for i in range(N_FRAMES):
        frame = np.clip(color + rng.integers(-20, 20, size=(H, W, 3)), 0, 255).astype(np.uint8)
        mask = np.zeros((H, W), np.uint8)
        y, x = box
        frame[y:y + 16, x:x + 12] = 255 - 4 * i  # the "person"
        mask[y:y + 16, x:x + 12] = 255
        Image.fromarray(frame).save(fdir / frame_name(i), quality=95)
        Image.fromarray(mask).save(mdir / mask_name(i))


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    """Both layouts under one root; annotations in a version dir per
    version (hat/kinetics/<ver>/, hat/ucf101/<ver>/) and flat
    (hat/kinetics_flat/), labels.csv two directories above every pickle."""
    root = tmp_path_factory.mktemp("hat")
    hat_dir = root / "anno" / "hat"
    hat_dir.mkdir(parents=True)
    for d in (hat_dir, hat_dir / "kinetics", hat_dir / "ucf101"):
        d.mkdir(exist_ok=True)
        (d / "labels.csv").write_text("\n".join(f"{i},{c}" for i, c in enumerate(CLASSES)) + "\n")
    kin, ucf = root / "kinetics", root / "ucf101"
    for n, (cls, fg, box, _) in enumerate(RECORDS):
        _write_video(kin / "original/videos" / f"{fg}.mp4", kin / "seg/videos" / f"{fg}.mp4",
                     lambda i: f"{i + 1:06d}.jpg", lambda i: f"{i + 1:06d}.png", 30 + 20 * n, box)
        _write_video(ucf / "rawframes" / cls / fg, ucf / "seg" / cls / fg,
                     lambda i: f"image_{i + 1:05d}.jpg", lambda i: f"img_{i:05d}.png", 30 + 20 * n, box)
    for n, (bg, box) in enumerate((("bg0", (30, 40)), ("bg1", (12, 50)))):
        _write_video(kin / "inpaint/videos" / f"{bg}.mp4", kin / "seg/videos" / f"{bg}.mp4",
                     lambda i: f"{i + 1:06d}.jpg", lambda i: f"{i + 1:06d}.png", 200 - 30 * n, box)
        _write_video(ucf / "inpaint/classC" / bg, ucf / "seg/classC" / bg,
                     lambda i: f"img_{i:05d}.jpg", lambda i: f"img_{i:05d}.png", 200 - 30 * n, box)
    kin_anno = {f"{c}/{fg}.mp4": (f"x/{bg}.mp4", N_FRAMES) for c, fg, _, bg in RECORDS}
    ucf_anno = {f"{c}/{fg}": (f"classC/{bg}", N_FRAMES) for c, fg, _, bg in RECORDS}
    for ver in ("far", "rand", "close"):
        for layout in ("kinetics", "ucf101"):
            (hat_dir / layout / ver).mkdir()
        (hat_dir / "kinetics_flat").mkdir(exist_ok=True)
        for split in (1, 2, 3):
            for d, anno in ((hat_dir / "kinetics" / ver, kin_anno), (hat_dir / "ucf101" / ver, ucf_anno),
                            (hat_dir / "kinetics_flat", kin_anno)):
                with open(d / f"actionswap_{ver}_{split}.pickle", "wb") as f:
                    pickle.dump(anno, f)
    return {"Kinetics-HAT": (str(kin), str(hat_dir / "kinetics")), "UCF101-HAT": (str(ucf), str(hat_dir / "ucf101")),
            "flat": str(hat_dir / "kinetics_flat")}


LAYOUTS = ("Kinetics-HAT", "UCF101-HAT")


def _pickle(assets, layout, ver="far", split=1):
    return os.path.join(assets[layout][1], ver, f"actionswap_{ver}_{split}.pickle")


def _cfg(assets, layout, jax_side=False, **kw):
    kw = dict(data_set=layout, anno_path=_pickle(assets, layout), data_prefix=assets[layout][0], nb_classes=5,
              num_frames=8, sampling_rate=2, input_size=32, short_side_size=32, test_num_segment=2,
              test_num_crop=3, **kw)
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


@pytest.fixture
def seeded_globals(monkeypatch):
    """The JAX package's and the port's C++ augment cores off;
    `np.random.default_rng()` without a seed and the global `random` made
    repeatable, so both sides draw alike."""
    for module in (native_augment, port_native_augment):
        monkeypatch.setattr(module, "_LIB", None)
        monkeypatch.setattr(module, "_SEARCHED", True)
    default_rng = np.random.default_rng
    monkeypatch.setattr(np.random, "default_rng", lambda seed=None: default_rng(1234 if seed is None else seed))

    def reseed():
        random.seed(99)

    return reseed


@pytest.mark.parametrize("layout", LAYOUTS)
def test_annotation_matches_jax(assets, layout):
    got = hat.load_hat_annotation(_pickle(assets, layout), assets[layout][0], layout)
    want = jax_hat.load_hat_annotation(_pickle(assets, layout), assets[layout][0], layout)
    assert len(got) == len(want) == len(RECORDS)
    for g, w in zip(got, want):
        assert {s: getattr(g, s) for s in w.__slots__} == {s: getattr(w, s) for s in w.__slots__}
    assert [r.label for r in got] == [CLASSES.index(c) for c, *_ in RECORDS]
    assert all(os.path.isdir(r.fg_frames) and os.path.isdir(r.bg_inpaint) for r in got)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_composite_clip_matches_jax(assets, layout):
    recs = hat.load_hat_annotation(_pickle(assets, layout), assets[layout][0], layout)
    for rec in recs:
        idx = np.asarray([0, 3, 7, 11], np.int64)
        got = hat.composite_clip(rec, idx, layout, N_FRAMES)
        want = jax_hat.composite_clip(rec, idx, layout, N_FRAMES)
        assert got.shape == (4, H, W, 3) and got.dtype == np.uint8
        np.testing.assert_array_equal(got, want)
    # the person moved onto the background (test_hat.py's check)
    assert (got[0] > 240).all(axis=-1).sum() > 50


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("mode", ["train", "validation", "test"])
def test_dataset_items_match_jax(assets, layout, mode, seeded_globals):
    got_ds = hat.HATDataset(_cfg(assets, layout, reprob=0.25), mode)
    want_ds = jax_hat.HATDataset(_cfg(assets, layout, True, reprob=0.25), mode)
    assert len(got_ds) == len(want_ds) == (6 * len(RECORDS) if mode == "test" else len(RECORDS))
    for index in range(len(want_ds)):
        seeded_globals()
        got = got_ds[index]
        seeded_globals()
        _same_item(got, want_ds[index])


@pytest.mark.parametrize("layout", LAYOUTS)
def test_build_dataset_hat_matches_jax(assets, layout):
    got, nb = build_dataset(False, True, _cfg(assets, layout))
    want, nb_want = jax_datasets.build_dataset(False, True, _cfg(assets, layout, True))
    assert isinstance(got, hat.HATDataset) and nb == nb_want == 5 and len(got) == len(want)
    for index in (0, len(want) - 1):
        _same_item(got[index], want[index])


def test_places365_matches_jax(tmp_path):
    (tmp_path / "train.csv").write_text("\n".join(f"img{i}.jpg {i * 7 % 365}" for i in range(4)))
    for split in ("val", "test"):
        (tmp_path / f"{split}.csv").write_text("\n".join(f"{split}{i}.jpg {i * 11 % 365}" for i in range(3)))
    kw = dict(data_set="Places365", data_path=str(tmp_path), synthetic=True, num_frames=4)
    for is_train, test_mode in ((True, False), (False, False), (False, True)):
        got, nb = build_dataset(is_train, test_mode, DataConfig(**kw))
        want, nb_want = jax_datasets.build_dataset(is_train, test_mode, jax_datasets.DataConfig(**kw))
        assert nb == nb_want == 365 and len(got) == len(want)
        _same_item(got[1], want[1])
    for split in (True, False):
        got, nb = knn_build_dataset(split, DataConfig(**kw))
        want, nb_want = jax_datasets.knn_build_dataset(split, jax_datasets.DataConfig(**kw))
        assert nb == nb_want == 365 and len(got) == len(want) == (4 if split else 3)
        assert got[0]["videos"].shape == (4, 224, 224, 3)
        for index in range(len(want)):
            _same_item(got[index], want[index])


@pytest.mark.parametrize("anno,versions,nested", [
    ("version", ("far",), False),
    ("versions", ("far", "rand", "close"), True),
    ("flat", ("far", "rand", "close"), False),
])
def test_hat_loader_factory_matches_jax(assets, anno, versions, nested):
    """A version dir runs its three splits; a dir of version dirs or a flat
    dir of pickles runs all three versions; the flavour comes from the
    path. The loaders' batches are bitwise JAX's."""
    path = {"version": os.path.join(assets["Kinetics-HAT"][1], "far"), "versions": assets["Kinetics-HAT"][1],
            "flat": assets["flat"]}[anno]
    flags = ["--data_set", "Kinetics-400", "--data_prefix", assets["Kinetics-HAT"][0], "--hat_anno_path", path,
             "--num_frames", "8", "--sampling_rate", "2", "--input_size", "32", "--short_side_size", "32",
             "--batch_size", "4", "--num_workers", "2"]
    make, got_versions = common.make_hat_loader_factory(cli.get_args(flags))
    make_jax, want_versions = jax_common.make_hat_loader_factory(jax_cli.get_args(flags))
    assert got_versions == want_versions == versions
    for ver in versions:
        loader, jax_loader = make(ver, 2), make_jax(ver, 2)
        ds = loader.dataset
        assert ds.cfg.data_set == "Kinetics-HAT" and len(ds) == 6 * len(RECORDS)
        assert ds.cfg.anno_path == jax_loader.dataset.cfg.anno_path
        assert ds.cfg.anno_path == os.path.join(path, *([ver] if nested else []), f"actionswap_{ver}_2.pickle")
        try:
            _same_item(next(iter(loader)), next(iter(jax_loader)))
        finally:
            loader.close()


def _export_models(tmp_path):
    """A tiny JAX student and CLS teacher with heads far from their
    near-zero init, exported to .pth (as `tests/test_torch_cli.py` does)."""
    import jax

    from devias_tpu.ckpt.torch_export import save_torch_checkpoint
    from devias_tpu.nn import create_model as jax_create_model

    x = jnp.zeros((1, 8, 32, 32, 3))
    small = dict(depth=2, embed_dim=64, num_heads=4)
    slot = jax_create_model("slot_vit_base_patch16_224", num_classes=5, num_latents=2, agg_depth=2,
                            agg_weights_tie=True, **small)
    params = slot.init({"params": jax.random.PRNGKey(3)}, x)["params"]
    params = dict(params, head=jax.tree.map(
        lambda a: np.random.default_rng(0).normal(size=a.shape).astype(np.float32) * 0.5, params["head"]))
    teacher = jax_create_model("vit_base_patch16_224", num_classes=365, use_mean_pooling=False, **small)
    tparams = teacher.init({"params": jax.random.PRNGKey(4)}, x)["params"]
    tparams = dict(tparams, head=jax.tree.map(
        lambda a: np.random.default_rng(1).normal(size=a.shape).astype(np.float32) * 0.5, tparams["head"]))
    paths = str(tmp_path / "slot.pth"), str(tmp_path / "teacher.pth")
    save_torch_checkpoint(paths[0], params, "slot", agg_depth=2)
    save_torch_checkpoint(paths[1], tparams, "plain")
    return paths


@pytest.mark.parametrize("scene", [False, True])
def test_hat_eval_matches_jax_cli(assets, tmp_path, monkeypatch, scene):
    """--hat_eval on a version dir through both CLIs: the same per-split
    accuracies, and logits within 1e-4 of their RMS."""
    slot_pth, teacher_pth = _export_models(tmp_path)
    flags = ["--smoke_tiny", "--batch_size", "4", "--num_frames", "8", "--sampling_rate", "2", "--input_size", "32",
             "--short_side_size", "32", "--num_workers", "2", "--nb_classes", "5", "--num_latents", "2",
             "--agg_depth", "2", "--agg_weights_tie", "--data_set", "Kinetics-400", "--data_prefix",
             assets["Kinetics-HAT"][0], "--hat_eval", "--hat_anno_path",
             os.path.join(assets["Kinetics-HAT"][1], "far"), "--finetune", slot_pth, "--scene_model_path",
             teacher_pth] + (["--eval_scene"] if scene else [])
    monkeypatch.setattr(jax_cli, "build_models", functools.partial(jax_cli.build_models, dtype=jnp.float32))
    monkeypatch.setattr(cli, "build_models", functools.partial(cli.build_models, dtype=torch.float32))
    jax_cli.main(jax_cli.get_args(flags + ["--output_dir", str(tmp_path / "jax")]))
    result = cli.main(cli.get_args(flags + ["--device", "cpu", "--output_dir", str(tmp_path / "port")]))

    assert sorted(os.listdir(tmp_path / "port" / "hat")) == ["far"]
    for split in ("1", "2", "3"):
        got_dir, want_dir = (str(tmp_path / side / "hat" / "far" / split) for side in ("port", "jax"))
        rows, want_rows = parse_result_file(os.path.join(got_dir, "0.txt")), parse_result_file(
            os.path.join(want_dir, "0.txt"))
        assert [r[0] for r in rows] == [r[0] for r in want_rows] and [r[2:] for r in rows] == [
            r[2:] for r in want_rows]
        got, want = np.stack([r[1] for r in rows]), np.stack([r[1] for r in want_rows])
        assert got.shape == want.shape == (6 * len(RECORDS), 365 if scene else 370)
        assert np.abs(got - want).max() <= 1e-4 * np.sqrt(np.mean(want ** 2)), split
        with open(os.path.join(got_dir, "log.txt")) as f, open(os.path.join(want_dir, "log.txt")) as g:
            assert json.load(f) == json.load(g)
        assert merge_results(got_dir, 1) == merge_results(want_dir, 1)
    top1 = np.mean([merge_results(str(tmp_path / "jax" / "hat" / "far" / s), 1)[0] for s in "123"])
    assert result["hat"]["far"]["acc1"] == pytest.approx(top1)
