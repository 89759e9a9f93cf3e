"""`run_slot_finetuning --sp_shards 2` of the port over two gloo processes
on the CPU: one seq group (a data axis of one), each rank's backbone on
half the frames, FAME on the group's first rank and broadcast. The run
must end on both ranks, rank 0 writing the log and the checkpoint and each
rank its test-result file. The SP step itself is held to the JAX SP path in
`tests/test_torch_seq_parallel.py`."""

import json
import os
import socket
import subprocess
import sys

import numpy as np

BASE = [
    "--synthetic_data", "--smoke_tiny", "--batch_size", "4", "--num_frames", "8", "--sampling_rate", "2",
    "--input_size", "32", "--short_side_size", "32", "--test_num_segment", "2", "--test_num_crop", "2",
    "--num_workers", "2", "--data_set", "UCF101", "--nb_classes", "5", "--num_latents", "2", "--agg_depth", "2",
    "--agg_weights_tie",
]


def test_sp_shards_trains_over_two_processes(tmp_path):
    data = tmp_path / "fl"
    data.mkdir()
    for name, rows in (("train.csv", 16), ("val.csv", 8), ("test.csv", 8)):
        (data / name).write_text("\n".join(f"{name[0]}{i}.mp4 {i % 5}" for i in range(rows)))
    out = tmp_path / "out"
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    argv = BASE + ["--device", "cpu", "--data_path", str(data), "--epochs", "1", "--max_steps_per_epoch", "1",
                   "--mask_model", "FAME", "--sp_shards", "2", "--output_dir", str(out)]
    code = f"from devias_tpu_torch.cli import run_slot_finetuning as c; c.main(c.get_args({argv!r}))"
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
    assert len(records) == 2 and records[0]["n_steps"] == 1 and np.isfinite(records[0]["train_loss"])
    assert sorted(os.listdir(out / "test")) == ["0.txt", "1.txt"]
    assert os.listdir(out / "ckpt") == ["checkpoint-0.pth"]
