"""The port's HVU and classification entry points on the CPU, at the
`--smoke_tiny` size (64 wide, 4 heads, depth 2) on synthetic 8x32x32
clips:

(a) flag parity: every flag and default of the JAX parsers of
    `run_slot_finetuning_hvu`, `eval_slot_finetuning_hvu` and
    `run_class_finetuning`, `--device` aside (`tpu` there, `cuda` here);
(b) evaluation parity: a tiny JAX HVU model (739 + 248 head, untied agg)
    and a tiny CLS classifier, exported to `.pth` and evaluated through
    both packages' CLIs in float32 (the CLIs build bf16 models; the test
    patches each one's model dtype in this process): the HVU eval's four
    blocks (action and scene on SEEN and UNSEEN) equal, and the class
    CLI's `--eval` logits to 1e-4 of their RMS;
(c) the HVU train CLI with FAME, EMA and drop-path: an exact resume (one
    epoch, a stop, then `--auto_resume` for the second equals two epochs
    in one run, bitwise), its validation blocks in log.txt, then the eval
    CLI's four blocks on the trained checkpoint;
(d) `run_class_finetuning --opt sgd --mixup 0.8 --cutmix 1.0 --use_cls
    --scene_labels_from TEACHER`: every step's labels are the teacher's
    argmax on its clips, the metrics finite, the final test merged, and
    `--eval` on the trained checkpoint gives the same top-1."""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from devias_tpu.ckpt.torch_export import save_torch_checkpoint
from devias_tpu.cli import eval_slot_finetuning_hvu as jax_eval_hvu
from devias_tpu.cli import run_class_finetuning as jax_class
from devias_tpu.cli import run_slot_finetuning_hvu as jax_hvu
from devias_tpu.nn import create_model as jax_create_model
from devias_tpu_torch.cli import common
from devias_tpu_torch.cli import eval_slot_finetuning_hvu as eval_hvu
from devias_tpu_torch.cli import run_class_finetuning as class_cli
from devias_tpu_torch.cli import run_slot_finetuning_hvu as hvu_cli
from devias_tpu_torch.eval import merge_results, parse_result_file
from devias_tpu_torch.nn import create_model

TINY = ["--synthetic_data", "--smoke_tiny", "--batch_size", "4", "--num_frames", "8", "--sampling_rate", "2",
        "--input_size", "32", "--short_side_size", "32", "--num_workers", "2"]
HVU_FLAGS = TINY + ["--agg_depth", "2"]
CLASS_FLAGS = TINY + ["--data_set", "UCF101", "--nb_classes", "5", "--test_num_segment", "2", "--test_num_crop", "2"]
SMALL = dict(depth=2, embed_dim=64, num_heads=4)


@pytest.fixture(scope="module")
def filelists(tmp_path_factory):
    """HVU lists (`<name> <action> <scene>`: train, val, SEEN, UNSEEN) and
    classification lists (`<name> <label>`)."""
    d = tmp_path_factory.mktemp("fl")
    for name, rows in (("train.csv", 16), ("val.csv", 8), ("seen.csv", 8), ("unseen.csv", 6)):
        (d / name).write_text("\n".join(f"{name[0]}{i} {(7 * i) % 739} {(5 * i) % 248}" for i in range(rows)))
    c = d / "class"
    c.mkdir()
    for name, rows in (("train.csv", 16), ("val.csv", 8), ("test.csv", 8)):
        (c / name).write_text("\n".join(f"{name[0]}{i}.mp4 {i % 5}" for i in range(rows)))
    return d


@pytest.mark.parametrize("jax_mod,mod", [(jax_hvu, hvu_cli), (jax_eval_hvu, eval_hvu), (jax_class, class_cli)])
def test_flag_parity(jax_mod, mod):
    want, got = vars(jax_mod.get_args([])), vars(mod.get_args([]))
    assert set(got) == set(want)
    for dest, value in want.items():
        if dest == "device":
            assert (value, got[dest]) == ("tpu", "cuda")  # entry points run on the card unless asked for the CPU
        else:
            assert got[dest] == value, dest


def _f32(module, name):
    """Patch `module.create_model` to build float32 models."""
    build = getattr(module, name)
    return lambda *a, **k: build(*a, **{**k, "dtype": jnp.float32})


def test_hvu_eval_parity_with_jax_cli(filelists, tmp_path, monkeypatch):
    x = jnp.zeros((1, 8, 32, 32, 3))
    model = jax_create_model("slot_vit_base_patch16_224", num_classes=739, num_scene_classes=248, num_latents=4,
                             agg_depth=2, agg_weights_tie=False, **SMALL)
    params = model.init({"params": jax.random.PRNGKey(3)}, x)["params"]
    # a head far from its near-zero init, so the slot selection and the
    # rankings are not ties
    params = dict(params, head=jax.tree.map(
        lambda a: np.random.default_rng(0).normal(size=a.shape).astype(np.float32) * 0.5, params["head"]))
    pth = str(tmp_path / "hvu.pth")
    save_torch_checkpoint(pth, params, "slot", agg_depth=2)
    flags = HVU_FLAGS + ["--anno_path", str(filelists / "seen.csv"), str(filelists / "unseen.csv"), "--finetune", pth]
    monkeypatch.setattr(jax_hvu, "create_model", _f32(jax_hvu, "create_model"))
    monkeypatch.setattr(eval_hvu, "build_hvu_model", functools.partial(hvu_cli.build_hvu_model, dtype=torch.float32))
    ranked = {"jax": [], "port": []}
    for side, mod in (("jax", jax_eval_hvu), ("port", eval_hvu)):
        topk = mod.accuracy_topk
        monkeypatch.setattr(mod, "accuracy_topk", lambda lg, lb, _s=side, _f=topk: ranked[_s].append((lg, lb)) or _f(lg, lb))
    want = jax_eval_hvu.main(jax_eval_hvu.get_args(flags))
    got = eval_hvu.main(eval_hvu.get_args(flags + ["--device", "cpu"]))
    assert list(got) == list(want) == ["action_seen", "scene_seen", "action_unseen", "scene_unseen"]
    assert got == want
    # the ranked logits themselves: full-width [n, 987], scene labels shifted
    # by the 739 action classes
    assert len(ranked["jax"]) == len(ranked["port"]) == 4
    for (g, gl), (w, wl) in zip(ranked["port"], ranked["jax"]):
        assert g.shape == w.shape and g.shape[1] == 987
        np.testing.assert_array_equal(gl, wl)
        assert np.abs(g - w).max() <= 1e-4 * np.sqrt(np.mean(w ** 2))
    assert min(lb.min() for _, lb in ranked["port"][1::2]) >= 739


def test_class_eval_parity_with_jax_cli(filelists, tmp_path, monkeypatch):
    x = jnp.zeros((1, 8, 32, 32, 3))
    model = jax_create_model("vit_base_patch16_224", num_classes=5, use_mean_pooling=False, **SMALL)
    params = model.init({"params": jax.random.PRNGKey(4)}, x)["params"]
    params = dict(params, head=jax.tree.map(
        lambda a: np.random.default_rng(1).normal(size=a.shape).astype(np.float32) * 0.5, params["head"]))
    pth = str(tmp_path / "cls.pth")
    save_torch_checkpoint(pth, params, "plain")
    flags = CLASS_FLAGS + ["--data_path", str(filelists / "class"), "--use_cls", "--eval", "--finetune", pth]
    monkeypatch.setattr(jax_class, "create_model", _f32(jax_class, "create_model"))
    monkeypatch.setattr(class_cli, "build_class_model",
                        functools.partial(class_cli.build_class_model, dtype=torch.float32))
    jax_class.main(jax_class.get_args(flags + ["--output_dir", str(tmp_path / "jax")]))
    result = class_cli.main(class_cli.get_args(flags + ["--device", "cpu", "--output_dir", str(tmp_path / "port")]))
    got = parse_result_file(str(tmp_path / "port" / "test" / "0.txt"))
    want = parse_result_file(str(tmp_path / "jax" / "test" / "0.txt"))
    assert [r[0] for r in got] == [r[0] for r in want] and len(got) == 32
    g, w = np.stack([r[1] for r in got]), np.stack([r[1] for r in want])
    assert np.abs(g - w).max() <= 1e-4 * np.sqrt(np.mean(w ** 2))
    assert result["eval"]["top1"] == merge_results(str(tmp_path / "jax" / "test"), 1)[0]


class _Stop(Exception):
    pass


def _records(path):
    with open(path) as f:
        return [{k: v for k, v in json.loads(line).items() if k != "train_time_s"} for line in f]


def test_hvu_train_exact_resume_and_eval_blocks(filelists, tmp_path, monkeypatch):
    flags = HVU_FLAGS + ["--device", "cpu", "--data_path", str(filelists), "--epochs", "2", "--max_steps_per_epoch",
                         "2", "--warmup_epochs", "1", "--mask_model", "FAME", "--model_ema", "--save_ckpt_freq", "1",
                         "--drop_path", "0.1"]
    straight, resumed = str(tmp_path / "straight"), str(tmp_path / "resumed")
    result = hvu_cli.main(hvu_cli.get_args(flags + ["--output_dir", straight]))
    assert [e["epoch"] for e in result["epochs"]] == [0, 1] and all(e["n_steps"] == 2 for e in result["epochs"])

    write = common.JsonlLogger.write

    def write_then_stop(self, record):
        write(self, record)
        if record.get("epoch") == 0:
            raise _Stop  # the run ends after epoch 0's checkpoint and record

    with monkeypatch.context() as m:
        m.setattr(common.JsonlLogger, "write", write_then_stop)
        with pytest.raises(_Stop):
            hvu_cli.main(hvu_cli.get_args(flags + ["--output_dir", resumed]))
    assert sorted(os.listdir(os.path.join(resumed, "ckpt"))) == ["checkpoint-0.pth"]
    result = hvu_cli.main(hvu_cli.get_args(flags + ["--output_dir", resumed, "--auto_resume"]))
    assert [e["epoch"] for e in result["epochs"]] == [1]

    a = torch.load(os.path.join(straight, "ckpt", "checkpoint-1.pth"), weights_only=True)
    b = torch.load(os.path.join(resumed, "ckpt", "checkpoint-1.pth"), weights_only=True)
    assert a["step"] == b["step"] == 4 and torch.equal(a["rng"], b["rng"])
    assert "agg_block.layers.1.0.fn.to_q.weight" in a["model"] and a["model"]["head.weight"].shape[0] == 987
    for part in ("model", "model_ema"):
        for k, v in a[part].items():
            assert torch.equal(v, b[part][k]), (part, k)
    records = _records(os.path.join(straight, "log.txt"))
    assert records == _records(os.path.join(resumed, "log.txt"))
    assert all(np.isfinite([r["train_loss"], r["val_acc1"], r["val_scene_acc1"]]).all() for r in records)

    blocks = eval_hvu.main(eval_hvu.get_args(HVU_FLAGS + [
        "--device", "cpu", "--anno_path", str(filelists / "seen.csv"), str(filelists / "unseen.csv"),
        "--finetune", os.path.join(straight, "ckpt", "checkpoint-1.pth")]))
    assert set(blocks) == {"action_seen", "scene_seen", "action_unseen", "scene_unseen"}
    assert all(set(v) == {"acc1", "acc5"} and 0 <= v["acc1"] <= v["acc5"] <= 100 for v in blocks.values())


def test_class_cli_sgd_mixup_cls_with_teacher_labels(filelists, tmp_path, monkeypatch):
    teacher = create_model("vit_base_patch16_224", device="cpu", seed=9, num_classes=365, use_mean_pooling=False,
                           **SMALL)
    with torch.no_grad():  # spread the head, so the argmax varies by clip
        teacher.head.weight.normal_(0, 1.0, generator=torch.Generator().manual_seed(0))
    pth = str(tmp_path / "teacher.pth")
    torch.save({"model": teacher.state_dict()}, pth)
    seen = []
    make_step = class_cli.make_classification_train_step

    def recording_make_step(*a, **k):
        step = make_step(*a, **k)

        def wrapped(state, batch, **kw):
            with torch.no_grad():
                want = teacher(batch["videos"]).get("logits").argmax(-1)
            seen.append(torch.equal(batch["labels"], want))
            return step(state, batch, **kw)

        return wrapped

    monkeypatch.setattr(class_cli, "make_classification_train_step", recording_make_step)
    out = str(tmp_path / "cls")
    flags = CLASS_FLAGS + ["--device", "cpu", "--data_path", str(filelists / "class"), "--use_cls", "--opt", "sgd",
                           "--lr", "0.1", "--mixup", "0.8", "--cutmix", "1.0", "--epochs", "1", "--nb_classes", "365",
                           "--scene_labels_from", pth]
    result = class_cli.main(class_cli.get_args(flags + ["--output_dir", out]))
    assert seen == [True] * 4  # 16 samples / batch 4, every batch relabelled
    records = _records(os.path.join(out, "log.txt"))
    assert np.isfinite([records[0]["train_loss"], records[0]["train_grad_norm"], result["final_top1"]]).all()
    ckpt = torch.load(os.path.join(out, "ckpt", "checkpoint-0.pth"), weights_only=True)
    assert "momentum_buffer" in next(iter(ckpt["optimizer"]["state"].values()))
    assert "cls_token" in ckpt["model"] and "fc_norm.weight" not in ckpt["model"]
    again = class_cli.main(class_cli.get_args(flags + ["--output_dir", str(tmp_path / "eval"), "--eval",
                                                       "--finetune", os.path.join(out, "ckpt", "checkpoint-0.pth")]))
    assert again["eval"]["top1"] == result["final_top1"]
