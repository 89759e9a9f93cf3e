"""The port's `run_slot_finetuning` CLI against the JAX package's:
(a) every flag and default of the JAX parser, `--device` aside (`tpu`
there, `cuda` here); (b) evaluation parity: a tiny JAX model and teacher
exported to `.pth`, evaluated with --eval --eval_scene --run_knn through
both CLIs in float32 (the CLIs build bf16 models; the test patches each
one's `build_models` dtype in this process); (c) a CPU train run, and an
exact resume: one epoch, a stop, then --auto_resume for the second, equals
two epochs in one run, bitwise in the parameters and in log.txt and
test/0.txt (train_time_s aside), and a train run with each of --pp_stages
2, --tp_size 2, --zero1 and --fsdp over two gloo processes; (d) the choice
of K1 by head dim, which lets `--smoke_tiny` (64 wide, 4 heads: head dim
16) run on the card with the plain attention while K1's wrapper keeps
refusing that head dim."""

import functools
import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from devias_tpu.ckpt.torch_export import save_torch_checkpoint
from devias_tpu.cli import common as jax_common
from devias_tpu.cli import run_slot_finetuning as jax_cli
from devias_tpu.nn import create_model as jax_create_model
from devias_tpu_torch.cli import common
from devias_tpu_torch.cli import run_slot_finetuning as cli
from devias_tpu_torch.eval import merge_results, parse_result_file

BASE = [
    "--synthetic_data", "--smoke_tiny", "--batch_size", "4", "--num_frames", "8", "--sampling_rate", "2",
    "--input_size", "32", "--short_side_size", "32", "--test_num_segment", "2", "--test_num_crop", "2",
    "--num_workers", "2", "--data_set", "UCF101", "--nb_classes", "5", "--num_latents", "2", "--agg_depth", "2",
    "--agg_weights_tie",
]
# the JAX parser's default, and the reason each differs
DIFFERENT_DEFAULTS = {"device": ("tpu", "cuda")}  # entry points run on the card unless asked for the CPU


@pytest.fixture(scope="module")
def filelists(tmp_path_factory):
    d = tmp_path_factory.mktemp("fl")
    for name, rows in (("train.csv", 16), ("val.csv", 8), ("test.csv", 8)):
        (d / name).write_text("\n".join(f"{name[0]}{i}.mp4 {i % 5}" for i in range(rows)))
    return str(d)


def test_flag_parity():
    want, got = vars(jax_cli.get_args([])), vars(cli.get_args([]))
    assert set(got) == set(want)
    for dest, value in want.items():
        if dest in DIFFERENT_DEFAULTS:
            assert (value, got[dest]) == DIFFERENT_DEFAULTS[dest]
        else:
            assert got[dest] == value, dest


@pytest.mark.parametrize("flags", [["--pp_stages", "2"], ["--tp_size", "2"], ["--zero1"], ["--fsdp"]])
def test_unported_flags_raise(flags, filelists, tmp_path):
    """The parallel flags the port once refused now train: the tiny CPU run
    with each over two gloo processes (a pipe or model group of two, or two
    data rows whose state is cut in halves) trains 2 steps, validates, tests
    and writes a checkpoint of the full, unsharded tensors."""
    out = tmp_path / "out"
    argv = BASE + ["--device", "cpu", "--data_path", filelists, "--epochs", "1", "--max_steps_per_epoch", "2",
                   "--mask_model", "FAME", "--model_ema", "--output_dir", str(out)] + flags
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    code = f"from devias_tpu_torch.cli import run_slot_finetuning as c\nc.main(c.get_args({argv!r}))\n"
    procs = [subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True, env={**os.environ, "DEVIAS_TPU_COORDINATOR": f"127.0.0.1:{port}",
                                              "DEVIAS_TPU_NUM_PROCS": "2", "DEVIAS_TPU_PROC_ID": str(r),
                                              "OMP_NUM_THREADS": "2"})
             for r in range(2)]
    try:
        outs = [p.communicate(timeout=180)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0, 0], outs
    with open(out / "log.txt") as f:
        records = [json.loads(line) for line in f]
    assert records[0]["n_steps"] == 2 and np.isfinite(records[0]["train_loss"]) and "val_acc1" in records[0]
    assert os.path.exists(out / "test" / "0.txt")
    ckpt = torch.load(out / "ckpt" / "checkpoint-0.pth", weights_only=True)
    fresh = cli.build_models(cli.get_args(argv), torch.device("cpu"))[0]
    assert ckpt["step"] == 2
    assert {k: v.shape for k, v in ckpt["model"].items()} == {k: v.shape for k, v in fresh.state_dict().items()}
    assert {k: v.shape for k, v in ckpt["model_ema"].items()} == {k: v.shape for k, v in fresh.named_parameters()}


def _train_with(flag, filelists, out):
    """The tiny CPU train run (one epoch of 2 steps with FAME) with `flag`,
    which must train and write its result files; returns the student and
    the teacher it built."""
    built = []
    build = cli.build_models

    def keep(*a, **k):
        built.extend(build(*a, **k))
        return built[-2:]

    with pytest.MonkeyPatch.context() as m:
        m.setattr(cli, "build_models", keep)
        result = cli.main(cli.get_args(BASE + ["--device", "cpu", "--data_path", filelists, "--epochs", "1",
                                               "--max_steps_per_epoch", "2", "--mask_model", "FAME",
                                               "--output_dir", out, flag]))
    with open(os.path.join(out, "log.txt")) as f:
        records = [json.loads(line) for line in f]
    assert result["epochs"][0]["n_steps"] == 2 and np.isfinite(records[0]["train_loss"])
    assert os.listdir(os.path.join(out, "ckpt")) == ["checkpoint-0.pth"]
    assert os.path.exists(os.path.join(out, "test", "0.txt"))
    return built


def test_segformer_needs_its_checkpoint(filelists, tmp_path):
    """--mask_model Segformer without --segformer_ckpt stops with the JAX
    CLI's message."""
    with pytest.raises(SystemExit, match="requires --segformer_ckpt"):
        cli.main(cli.get_args(BASE + ["--device", "cpu", "--data_path", filelists, "--epochs", "1",
                                      "--mask_model", "Segformer", "--output_dir", str(tmp_path / "out")]))


def test_segformer_mask_model_trains(filelists, tmp_path):
    """--mask_model Segformer (16) with a b0 HF-layout checkpoint: the
    frozen mask model runs in bfloat16 on every other frame of each
    training clip, and the run trains and writes its results."""
    from devias_tpu_torch.nn.segformer import create_segformer, segformer_b0

    seg = create_segformer(segformer_b0(), device="cpu", seed=3)
    torch.save(seg.state_dict(), tmp_path / "segformer_b0.pth")
    frames = []
    build = cli.build_segformer

    def counted(*a, **k):
        model = build(*a, **k)
        model.register_forward_hook(lambda m, inp, out: frames.append((inp[0].shape[0], out.dtype)))
        return model

    out = str(tmp_path / "out")
    with pytest.MonkeyPatch.context() as m:
        m.setattr(cli, "build_segformer", counted)
        result = cli.main(cli.get_args(BASE + [
            "--device", "cpu", "--data_path", filelists, "--epochs", "1", "--max_steps_per_epoch", "2",
            "--mask_model", "Segformer", "--segformer_variant", "b0", "--segformer_ckpt",
            str(tmp_path / "segformer_b0.pth"), "--output_dir", out]))
    # 2 steps of 8 clips (--num_sample 2), 4 of their 8 frames each
    assert frames == [(32, torch.bfloat16)] * 2
    with open(os.path.join(out, "log.txt")) as f:
        records = [json.loads(line) for line in f]
    assert result["epochs"][0]["n_steps"] == 2 and np.isfinite(records[0]["train_loss"])
    assert os.path.exists(os.path.join(out, "test", "0.txt"))


def test_use_checkpoint_trains(filelists, tmp_path):
    """--use_checkpoint (10a): the student's blocks are checkpointed."""
    model, teacher = _train_with("--use_checkpoint", filelists, str(tmp_path / "out"))
    assert model.remat and not teacher.remat


def test_teacher_int8_trains(filelists, tmp_path):
    """--teacher_int8 (15): the scene teacher's four dense layers per block
    run w8a8; the student's do not."""
    model, teacher = _train_with("--teacher_int8", filelists, str(tmp_path / "out"))
    assert teacher.blocks[0].attn.qkv.int8_dense and teacher.blocks[1].mlp.fc2.int8_dense
    assert not model.blocks[0].attn.qkv.int8_dense


@pytest.mark.parametrize("device,embed_dim,num_heads,want", [
    ("cuda", 768, 12, True),   # the flagship and its teacher: head dim 64
    ("cuda", 64, 4, False),    # --smoke_tiny: head dim 16
    ("cuda", 256, 8, False),   # head dim 32
    ("cpu", 768, 12, False),   # the CPU always takes the plain version
])
def test_attention_kernel_only_at_its_head_dim(device, embed_dim, num_heads, want):
    assert cli.use_attention_kernel(torch.device(device), embed_dim, num_heads) is want


def test_attention_wrapper_still_refuses_head_dim_16_on_a_cuda_tensor():
    """The CLI's choice is configuration, not a fallback: K1's wrapper still
    raises for a CUDA tensor of head dim 16 (a fake tensor here, which
    carries the device and shape without a card)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from devias_tpu_torch.kernels.attention import fused_attention_qkv

    with FakeTensorMode():
        qkv = torch.empty(1, 8, 3 * 64, device="cuda", dtype=torch.bfloat16)
        with pytest.raises(ValueError, match="head dim 64; got 16"):
            fused_attention_qkv(qkv, 4, 0.25)


def _export_models(tmp_path):
    x = jnp.zeros((1, 8, 32, 32, 3))
    small = dict(depth=2, embed_dim=64, num_heads=4)
    slot = jax_create_model("slot_vit_base_patch16_224", num_classes=5, num_latents=2, agg_depth=2,
                            agg_weights_tie=True, **small)
    params = slot.init({"params": jax.random.PRNGKey(3)}, x)["params"]
    # a head far from its near-zero init, so the slot selection and the
    # logits are not ties
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


def _logits(path):
    rows = parse_result_file(path)
    return [r[0] for r in rows], np.stack([r[1] for r in rows]), [r[2:] for r in rows]


def test_eval_parity_with_jax_cli(filelists, tmp_path, monkeypatch):
    slot_pth, teacher_pth = _export_models(tmp_path)
    flags = BASE + ["--data_path", filelists, "--eval", "--eval_scene", "--run_knn", "--nb_knn", "3",
                    "--finetune", slot_pth, "--scene_model_path", teacher_pth]
    monkeypatch.setattr(jax_cli, "build_models", functools.partial(jax_cli.build_models, dtype=jnp.float32))
    monkeypatch.setattr(cli, "build_models", functools.partial(cli.build_models, dtype=torch.float32))
    knn_jax = {}
    run_knn = jax_common.run_knn_protocol
    monkeypatch.setattr(jax_common, "run_knn_protocol", lambda *a: knn_jax.setdefault("r", run_knn(*a)))
    jax_cli.main(jax_cli.get_args(flags + ["--output_dir", str(tmp_path / "jax")]))
    result = cli.main(cli.get_args(flags + ["--device", "cpu", "--output_dir", str(tmp_path / "port")]))

    for sub in ("test", "scene_test"):
        ids, got, meta = _logits(str(tmp_path / "port" / sub / "0.txt"))
        ids_j, want, meta_j = _logits(str(tmp_path / "jax" / sub / "0.txt"))
        assert ids == ids_j and meta == meta_j and got.shape == want.shape == (32, 370 if sub == "test" else 365)
        rms = np.sqrt(np.mean(want ** 2))
        assert np.abs(got - want).max() <= 1e-4 * rms, sub
        assert merge_results(str(tmp_path / "port" / sub), 1) == merge_results(str(tmp_path / "jax" / sub), 1)
    assert result["eval"] == dict(zip(("top1", "top5"), merge_results(str(tmp_path / "jax" / "test"), 1)))
    # the k-NN matrices: three datasets over the same filelists; the
    # features agree to float32 rounding, far from any tie in the votes
    assert json.loads(json.dumps(result["knn"])) == json.loads(json.dumps(knn_jax["r"]))
    for name in os.listdir(tmp_path / "jax"):
        if name.endswith("features.pth"):
            np.testing.assert_allclose(torch.load(tmp_path / "port" / name).numpy(),
                                       torch.load(tmp_path / "jax" / name).numpy(), rtol=1e-4, atol=1e-5)


class _Stop(Exception):
    pass


def _records(path):
    with open(path) as f:
        return [{k: v for k, v in json.loads(line).items() if k != "train_time_s"} for line in f]


def test_train_and_exact_resume(filelists, tmp_path, monkeypatch):
    flags = BASE + ["--device", "cpu", "--data_path", filelists, "--epochs", "2", "--max_steps_per_epoch", "2",
                    "--warmup_epochs", "1", "--mask_model", "FAME", "--beta", "0.25", "--model_ema", "--save_ckpt_freq", "1",
                    "--drop_path", "0.1"]
    straight, resumed = str(tmp_path / "straight"), str(tmp_path / "resumed")
    result = cli.main(cli.get_args(flags + ["--output_dir", straight]))
    assert [e["epoch"] for e in result["epochs"]] == [0, 1] and all(e["n_steps"] == 2 for e in result["epochs"])

    write = common.JsonlLogger.write

    def write_then_stop(self, record):
        write(self, record)
        if record.get("epoch") == 0:
            raise _Stop  # the run ends after epoch 0's checkpoint and record

    with monkeypatch.context() as m:
        m.setattr(common.JsonlLogger, "write", write_then_stop)
        with pytest.raises(_Stop):
            cli.main(cli.get_args(flags + ["--output_dir", resumed]))
    assert sorted(os.listdir(os.path.join(resumed, "ckpt"))) == ["checkpoint-0.pth"]
    result = cli.main(cli.get_args(flags + ["--output_dir", resumed, "--auto_resume"]))
    assert [e["epoch"] for e in result["epochs"]] == [1]

    a = torch.load(os.path.join(straight, "ckpt", "checkpoint-1.pth"), weights_only=True)
    b = torch.load(os.path.join(resumed, "ckpt", "checkpoint-1.pth"), weights_only=True)
    assert a["step"] == b["step"] == 4 and torch.equal(a["rng"], b["rng"])
    for part in ("model", "model_ema"):
        for k, v in a[part].items():
            assert torch.equal(v, b[part][k]), (part, k)
    assert _records(os.path.join(straight, "log.txt")) == _records(os.path.join(resumed, "log.txt"))
    with open(os.path.join(straight, "test", "0.txt")) as f, open(os.path.join(resumed, "test", "0.txt")) as g:
        assert f.read() == g.read()

