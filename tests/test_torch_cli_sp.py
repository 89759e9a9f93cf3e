"""`run_slot_finetuning --sp_shards 2` of the port over two gloo processes
on the CPU: one seq group (a data axis of one), each rank's backbone on
half the frames, FAME on the group's first rank and broadcast. The run
must end on both ranks, rank 0 writing the log and the checkpoint and each
rank its test-result file. The SP step itself is held to the JAX SP path in
`tests/test_torch_seq_parallel.py`. With `--use_checkpoint` the run must
equal the one without it bitwise."""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import torch

BASE = [
    "--synthetic_data", "--smoke_tiny", "--batch_size", "4", "--num_frames", "8", "--sampling_rate", "2",
    "--input_size", "32", "--short_side_size", "32", "--test_num_segment", "2", "--test_num_crop", "2",
    "--num_workers", "2", "--data_set", "UCF101", "--nb_classes", "5", "--num_latents", "2", "--agg_depth", "2",
    "--agg_weights_tie",
]


def _filelists(tmp_path):
    data = tmp_path / "fl"
    data.mkdir()
    for name, rows in (("train.csv", 16), ("val.csv", 8), ("test.csv", 8)):
        (data / name).write_text("\n".join(f"{name[0]}{i}.mp4 {i % 5}" for i in range(rows)))
    return data


def _run_two_ranks(runs):
    """Each of two gloo processes runs `main` on each argv of `runs` in
    turn; both must exit 0."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    code = "from devias_tpu_torch.cli import run_slot_finetuning as c\n" + "".join(
        f"c.main(c.get_args({argv!r}))\n" for argv in runs)
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


def test_sp_shards_trains_over_two_processes(tmp_path):
    data = _filelists(tmp_path)
    out = tmp_path / "out"
    _run_two_ranks([BASE + ["--device", "cpu", "--data_path", str(data), "--epochs", "1", "--max_steps_per_epoch",
                            "1", "--mask_model", "FAME", "--sp_shards", "2", "--output_dir", str(out)]])
    with open(out / "log.txt") as f:
        records = [json.loads(line) for line in f]
    assert len(records) == 2 and records[0]["n_steps"] == 1 and np.isfinite(records[0]["train_loss"])
    assert sorted(os.listdir(out / "test")) == ["0.txt", "1.txt"]
    assert os.listdir(out / "ckpt") == ["checkpoint-0.pth"]


def test_use_checkpoint_under_sp_shards_equals_the_step_without_it(tmp_path):
    """`--use_checkpoint --sp_shards 2`: the recompute re-runs the K/V
    all-gather in the backward on both ranks, and the blocks' dropout
    (`--drop 0.1`) and drop-path (the default 0.1, from the separate
    generator the token shards share) redraw their forward masks. Two steps
    must leave the model, the EMA and the logged metrics bitwise equal to
    the same run without checkpointing."""
    data = _filelists(tmp_path)
    argv = BASE + ["--device", "cpu", "--data_path", str(data), "--epochs", "1", "--max_steps_per_epoch", "2",
                   "--mask_model", "FAME", "--sp_shards", "2", "--drop", "0.1", "--model_ema",
                   "--disable_eval_during_finetuning"]
    plain, remat = tmp_path / "plain", tmp_path / "remat"
    _run_two_ranks([argv + ["--output_dir", str(plain)], argv + ["--use_checkpoint", "--output_dir", str(remat)]])
    a = torch.load(plain / "ckpt" / "checkpoint-0.pth", weights_only=True)
    b = torch.load(remat / "ckpt" / "checkpoint-0.pth", weights_only=True)
    assert a["step"] == b["step"] == 2 and torch.equal(a["rng"], b["rng"])
    for part in ("model", "model_ema"):
        for k, v in a[part].items():
            assert torch.equal(v, b[part][k]), (part, k)
    with open(plain / "log.txt") as f, open(remat / "log.txt") as g:
        drop = ("train_time_s",)
        assert [{k: v for k, v in json.loads(line).items() if k not in drop} for line in f] == \
            [{k: v for k, v in json.loads(line).items() if k not in drop} for line in g]
