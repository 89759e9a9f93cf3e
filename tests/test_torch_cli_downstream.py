"""The port's downstream, multi-task and result-comparison entry points on
the CPU, at the `--smoke_tiny` size (64 wide, 4 heads, depth 2) on
synthetic 8x32x32 clips:

(a) flag parity: every flag and default of the JAX parsers of
    `run_slot_downstream`, `run_multi_task_finetuning` and
    `compare_results`, `--device` aside (`tpu` there, `cuda` here);
(b) `--eval` parity: a tiny JAX slot-fusion model (MLP fusion head, tied
    agg) and a tiny JAX multi-task model (unified head, with a CLS scene
    teacher) exported to `.pth` and evaluated through both packages' CLIs
    in float32 (the CLIs build bf16 models; the test patches each one's
    model dtype in this process): the result files' logits within 1e-4 of
    their RMS, the merged accuracies equal (with `--eval_scene` for the
    multi-task model);
(c) an exact resume of each train CLI (drop-path and EMA on): one epoch, a
    stop, then `--auto_resume` for the second equals two epochs in one
    run, bitwise in the checkpoint, log.txt and the final test's file;
(d) the multi-task CLI's `--run_scuba` (action and scene tests on every
    background), `--hat_eval` (action and scene) and `--run_knn` (on the
    CLS and scene tokens) through both CLIs in float32 on the same
    exported weights (SCUBA and HAT on in-memory batches of synthetic
    clips): logits within 1e-4 of their RMS, the same accuracies and k-NN
    matrices;
(e) `compare_results` on two result directories (one in two rank files):
    the same printed report and return value as the JAX tool."""

import argparse
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from devias_tpu.ckpt.torch_export import save_torch_checkpoint
from devias_tpu.cli import common as jax_common
from devias_tpu.cli import compare_results as jax_compare
from devias_tpu.cli import run_multi_task_finetuning as jax_mt
from devias_tpu.cli import run_slot_downstream as jax_ds
from devias_tpu.nn import create_model as jax_create_model
from devias_tpu_torch.cli import common
from devias_tpu_torch.cli import compare_results as compare
from devias_tpu_torch.cli import run_multi_task_finetuning as mt_cli
from devias_tpu_torch.cli import run_slot_downstream as ds_cli
from devias_tpu_torch.eval import merge_results, parse_result_file, write_result_file

TINY = ["--synthetic_data", "--smoke_tiny", "--batch_size", "4", "--num_frames", "8", "--sampling_rate", "2",
        "--input_size", "32", "--short_side_size", "32", "--test_num_segment", "2", "--test_num_crop", "2",
        "--num_workers", "2", "--data_set", "UCF101", "--nb_classes", "5"]
DS_FLAGS = TINY + ["--downstream_nb_classes", "5", "--num_latents", "2", "--agg_depth", "2", "--agg_weights_tie",
                   "--head_type", "mlp"]
MT_FLAGS = TINY + ["--unified_head"]
SMALL = dict(depth=2, embed_dim=64, num_heads=4)


@pytest.fixture(scope="module")
def filelists(tmp_path_factory):
    d = tmp_path_factory.mktemp("fl")
    for name, rows in (("train.csv", 16), ("val.csv", 8), ("test.csv", 8)):
        (d / name).write_text("\n".join(f"{name[0]}{i}.mp4 {i % 5}" for i in range(rows)))
    return str(d)


def _compare_args(argv):
    """The namespace `compare_results.main` parses from `argv`."""
    seen = []

    def capture(self, args=None, namespace=None):
        seen.append(argparse.ArgumentParser.parse_known_args(self, args, namespace)[0])
        raise SystemExit

    return seen, capture


@pytest.mark.parametrize("jax_mod,mod", [(jax_ds, ds_cli), (jax_mt, mt_cli), (jax_compare, compare)])
def test_flag_parity(jax_mod, mod, monkeypatch):
    if mod is compare:
        got, want = [], []
        for side, main in ((got, mod.main), (want, jax_mod.main)):
            seen, capture = _compare_args(["a", "b"])
            with monkeypatch.context() as m:
                m.setattr(argparse.ArgumentParser, "parse_args", capture)
                with pytest.raises(SystemExit):
                    main(["a", "b"])
            side.append(vars(seen[0]))
        assert got == want
        return
    want, got = vars(jax_mod.get_args([])), vars(mod.get_args([]))
    assert set(got) == set(want)
    for dest, value in want.items():
        if dest == "device":
            assert (value, got[dest]) == ("tpu", "cuda")  # entry points run on the card unless asked for the CPU
        else:
            assert got[dest] == value, dest


def _f32(module):
    """`module.create_model`, building float32 models."""
    build = module.create_model
    return lambda *a, **k: build(*a, **{**k, "dtype": jnp.float32})


def _spread(params, name, seed):
    """`params` with `name`'s leaves far from their near-zero init, so the
    slot selection and the rankings are not ties."""
    rng = np.random.default_rng(seed)
    return dict(params, **{name: jax.tree.map(lambda a: rng.normal(size=a.shape).astype(np.float32) * 0.5,
                                              params[name])})


def _export(tmp_path):
    """Tiny JAX models in reference-layout `.pth` files: the slot-fusion
    model, the multi-task model (unified head) and its CLS scene teacher."""
    x = jnp.zeros((1, 8, 32, 32, 3))
    fusion = jax_create_model("slot_fusion_vit_base_patch16_224", num_classes=5, downstream_nb_classes=5,
                              num_latents=2, agg_depth=2, agg_weights_tie=True, head_type="mlp", **SMALL)
    fp = _spread(_spread(fusion.init({"params": jax.random.PRNGKey(3)}, x)["params"], "head", 0), "fusion_head", 1)
    mt = jax_create_model("disentangle_vit_base_patch16_224", num_classes=5, unified_head=True, **SMALL)
    mp = _spread(mt.init({"params": jax.random.PRNGKey(4)}, x)["params"], "head", 2)
    teacher = jax_create_model("vit_base_patch16_224", num_classes=365, use_mean_pooling=False, **SMALL)
    tp = _spread(teacher.init({"params": jax.random.PRNGKey(5)}, x)["params"], "head", 3)
    paths = {k: str(tmp_path / f"{k}.pth") for k in ("fusion", "mt", "teacher")}
    save_torch_checkpoint(paths["fusion"], fp, "slot_fusion", agg_depth=2)
    save_torch_checkpoint(paths["mt"], mp, "multi_task")
    save_torch_checkpoint(paths["teacher"], tp, "plain")
    return paths


def _patch_f32(monkeypatch):
    for mod in (jax_ds, jax_mt):
        monkeypatch.setattr(mod, "create_model", _f32(mod))
    monkeypatch.setattr(ds_cli, "build_fusion_model", functools.partial(ds_cli.build_fusion_model,
                                                                        dtype=torch.float32))
    monkeypatch.setattr(mt_cli, "build_models", functools.partial(mt_cli.build_models, dtype=torch.float32))


def _same_results(got_dir, want_dir, width):
    got, want = parse_result_file(os.path.join(got_dir, "0.txt")), parse_result_file(os.path.join(want_dir, "0.txt"))
    assert [r[0] for r in got] == [r[0] for r in want] and [r[2:] for r in got] == [r[2:] for r in want]
    g, w = np.stack([r[1] for r in got]), np.stack([r[1] for r in want])
    assert g.shape == w.shape and g.shape[1] == width
    assert np.abs(g - w).max() <= 1e-4 * np.sqrt(np.mean(w ** 2)), got_dir
    assert merge_results(got_dir, 1) == merge_results(want_dir, 1)


@pytest.mark.parametrize("cli", ["downstream", "multi_task"])
def test_eval_parity_with_jax_cli(cli, filelists, tmp_path, monkeypatch):
    paths = _export(tmp_path)
    _patch_f32(monkeypatch)
    if cli == "downstream":
        jax_mod, mod, subs = jax_ds, ds_cli, {"test": 5}
        flags = DS_FLAGS + ["--finetune", paths["fusion"]]
    else:
        jax_mod, mod, subs = jax_mt, mt_cli, {"test": 370, "scene_test": 370}
        flags = MT_FLAGS + ["--eval_scene", "--finetune", paths["mt"], "--scene_model_path", paths["teacher"]]
    flags += ["--data_path", filelists, "--eval"]
    jax_mod.main(jax_mod.get_args(flags + ["--output_dir", str(tmp_path / "jax")]))
    result = mod.main(mod.get_args(flags + ["--device", "cpu", "--output_dir", str(tmp_path / "port")]))
    for sub, width in subs.items():
        _same_results(str(tmp_path / "port" / sub), str(tmp_path / "jax" / sub), width)
    assert result["eval"] == dict(zip(("top1", "top5"), merge_results(str(tmp_path / "jax" / "test"), 1)))


class _Stop(Exception):
    pass


def _records(path):
    with open(path) as f:
        return [{k: v for k, v in json.loads(line).items() if k != "train_time_s"} for line in f]


@pytest.mark.parametrize("cli", ["downstream", "multi_task"])
def test_train_and_exact_resume(cli, filelists, tmp_path, monkeypatch):
    mod, base = (ds_cli, DS_FLAGS) if cli == "downstream" else (mt_cli, MT_FLAGS + ["--logit_criterion", "CE"])
    flags = base + ["--device", "cpu", "--data_path", filelists, "--epochs", "2", "--max_steps_per_epoch", "2",
                    "--warmup_epochs", "1", "--model_ema", "--save_ckpt_freq", "1", "--drop_path", "0.1"]
    straight, resumed = str(tmp_path / "straight"), str(tmp_path / "resumed")
    result = mod.main(mod.get_args(flags + ["--output_dir", straight]))
    assert [e["epoch"] for e in result["epochs"]] == [0, 1] and all(e["n_steps"] == 2 for e in result["epochs"])

    write = common.JsonlLogger.write

    def write_then_stop(self, record):
        write(self, record)
        if record.get("epoch") == 0:
            raise _Stop  # the run ends after epoch 0's checkpoint and record

    with monkeypatch.context() as m:
        m.setattr(common.JsonlLogger, "write", write_then_stop)
        with pytest.raises(_Stop):
            mod.main(mod.get_args(flags + ["--output_dir", resumed]))
    assert sorted(os.listdir(os.path.join(resumed, "ckpt"))) == ["checkpoint-0.pth"]
    result = mod.main(mod.get_args(flags + ["--output_dir", resumed, "--auto_resume"]))
    assert [e["epoch"] for e in result["epochs"]] == [1]

    a = torch.load(os.path.join(straight, "ckpt", "checkpoint-1.pth"), weights_only=True)
    b = torch.load(os.path.join(resumed, "ckpt", "checkpoint-1.pth"), weights_only=True)
    assert a["step"] == b["step"] == 4 and torch.equal(a["rng"], b["rng"])
    want_keys = ("fusion_head.fc_scene_down.weight", "agg_block.layers.1.0.fn.to_q.weight") if cli == "downstream" \
        else ("scene_token", "cls_token")
    assert all(k in a["model"] for k in want_keys)
    for part in ("model", "model_ema"):
        for k, v in a[part].items():
            assert torch.equal(v, b[part][k]), (part, k)
    records = _records(os.path.join(straight, "log.txt"))
    assert records == _records(os.path.join(resumed, "log.txt"))
    assert [r.get("epoch") for r in records] == [0, 1, None]
    assert np.isfinite([records[1]["train_loss"], records[1]["val_acc1"], records[2]["final_top1"]]).all()
    with open(os.path.join(straight, "test", "0.txt")) as f, open(os.path.join(resumed, "test", "0.txt")) as g:
        assert f.read() == g.read()


def _fake_batches(seed, n=6):
    """Two in-memory test batches of synthetic clips in the loaders'
    format."""
    rng = np.random.default_rng(seed)
    return [{"videos": rng.normal(size=(k, 8, 32, 32, 3)).astype(np.float32), "labels": rng.integers(0, 5, size=k),
             "video_id": [f"v{seed}_{i}_{j}" for j in range(k)], "chunk": np.zeros(k, np.int64),
             "split": np.arange(k) % 2} for i, k in enumerate((4, n - 4))]


@pytest.mark.parametrize("mode", ["run_scuba", "hat_eval", "hat_eval_scene", "run_knn"])
def test_multi_task_evaluations_match_jax_cli(mode, filelists, tmp_path, monkeypatch):
    paths = _export(tmp_path)
    _patch_f32(monkeypatch)
    flags = MT_FLAGS + ["--data_path", filelists, "--finetune", paths["mt"], "--scene_model_path", paths["teacher"]]
    if mode == "run_scuba":
        flags += ["--run_scuba"]
        loader = lambda args, variant: _fake_batches(len(variant))  # noqa: E731
        monkeypatch.setattr(jax_common, "make_scuba_loader", loader)
        monkeypatch.setattr(mt_cli, "make_scuba_loader", loader)
    elif mode.startswith("hat_eval"):
        flags += ["--hat_eval"] + (["--eval_scene"] if mode == "hat_eval_scene" else [])
        factory = lambda args: (lambda ver, split: _fake_batches(10 * split), ("far",))  # noqa: E731
        monkeypatch.setattr(jax_common, "make_hat_loader_factory", factory)
        monkeypatch.setattr(mt_cli, "make_hat_loader_factory", factory)
    else:
        flags += ["--run_knn", "--nb_knn", "3"]
        knn_jax = {}
        run_knn = jax_common.run_knn_protocol
        monkeypatch.setattr(jax_common, "run_knn_protocol", lambda *a: knn_jax.setdefault("r", run_knn(*a)))
    jax_mt.main(jax_mt.get_args(flags + ["--output_dir", str(tmp_path / "jax")]))
    result = mt_cli.main(mt_cli.get_args(flags + ["--device", "cpu", "--output_dir", str(tmp_path / "port")]))
    if mode == "run_knn":
        # the CLS and scene tokens over three datasets' lists; the features
        # agree to float32 rounding, far from any tie in the votes
        assert set(result["knn"]) == {"HMDB51", "UCF101", "Diving-48"}
        assert json.loads(json.dumps(result["knn"])) == json.loads(json.dumps(knn_jax["r"]))
        return
    if mode == "run_scuba":
        dirs = [f"scuba/{v}{bg}" for v in ("vqgan", "places365", "sinusoidal") for bg in ("", "_bg")]
    else:
        dirs = [f"hat/far/{s}" for s in (1, 2, 3)]
    for sub in dirs:
        _same_results(str(tmp_path / "port" / sub), str(tmp_path / "jax" / sub), 370)
        with open(tmp_path / "port" / sub / "log.txt") as f, open(tmp_path / "jax" / sub / "log.txt") as g:
            assert json.load(f) == json.load(g)
    key = "scuba" if mode == "run_scuba" else "hat"
    assert set(result) == {key} and all(np.isfinite(list(v.values())).all() for v in result[key].values())


def test_compare_results_matches_jax_tool(tmp_path, capsys):
    rng = np.random.default_rng(0)
    ids = [f"v{i}" for i in range(6)]
    labels = [i % 5 for i in range(6)]
    chunks, splits = [0] * 6, [i % 2 for i in range(6)]
    logits = rng.normal(size=(6, 5)).astype(np.float32)
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    write_result_file(str(tmp_path / "a" / "0.txt"), ids, logits, labels, chunks, splits)
    # B: the same views over two rank files, slightly moved, one view
    # missing and one label different
    other = logits + 0.05 * rng.normal(size=logits.shape).astype(np.float32)
    b_labels = labels[:3] + [(labels[3] + 1) % 5] + labels[4:5]
    write_result_file(str(tmp_path / "b" / "0.txt"), ids[:3], other[:3], b_labels[:3], chunks[:3], splits[:3])
    write_result_file(str(tmp_path / "b" / "1.txt"), ids[3:5], other[3:5], b_labels[3:], chunks[3:5], splits[3:5])
    argv = [str(tmp_path / "a"), str(tmp_path / "b"), "--num_tasks_b", "2"]
    want = jax_compare.main(argv)
    want_out = capsys.readouterr().out
    got = compare.main(argv)
    got_out = capsys.readouterr().out
    assert got == want and got_out == want_out
    assert "5 common, 1 only in A, 0 only in B" in got_out and "label mismatches:          1" in got_out
