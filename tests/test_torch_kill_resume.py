"""The port's `run_slot_finetuning` killed by SIGKILL mid-training, then
relaunched with the same flags (`--auto_resume` is on by default), against
an uninterrupted run: the counterpart of `tests/test_kill_resume.py`, on
the CPU with that test's flags, `--model_ema` added.

The kill point is deterministic: the program (`tests/_torch_kill_resume_worker.py`)
stops at a fixed point, writes a marker and waits; the parent then sends
SIGKILL. Two points:

- mid-epoch: before the second step of epoch 2, after `checkpoint-1.pth`
  was written; the relaunch resumes after epoch 1;
- mid-write: inside epoch 1's checkpoint write, half of its temporary file
  on disk; the relaunch resumes after epoch 0 and ignores the stale
  `.tmp`.

The resumed run must equal the uninterrupted one bitwise: every train
record of `log.txt` (`train_time_s`, a wall clock, aside) and the final
checkpoint, model, EMA, optimizer state and count, step and generator
state. Each process runs torch on one thread."""

import json
import os
import signal
import subprocess
import sys
import time

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "_torch_kill_resume_worker.py")
EPOCHS, STEPS = 4, 3
TIMEOUT = 300


def _flags(filelist_dir, out_dir):
    return [
        "--device", "cpu", "--synthetic_data", "--smoke_tiny", "--batch_size", "4",
        "--epochs", str(EPOCHS), "--max_steps_per_epoch", str(STEPS),
        "--num_frames", "8", "--sampling_rate", "2", "--input_size", "32",
        "--short_side_size", "32", "--test_num_segment", "1",
        "--test_num_crop", "1", "--num_workers", "2", "--seed", "42",
        "--warmup_epochs", "0", "--drop_path", "0.0",
        "--save_ckpt_freq", "1", "--disable_eval_during_finetuning",
        "--data_path", filelist_dir, "--data_set", "UCF101",
        "--nb_classes", "5", "--num_latents", "2", "--agg_depth", "2",
        "--mask_model", "FAME", "--beta", "0.25", "--model_ema",
        "--output_dir", out_dir,
    ]


def _spawn(filelist_dir, out_dir, tag, kill_at=None):
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    env.pop("DEVIAS_KILL_AT", None)
    if kill_at is not None:
        env.update(DEVIAS_KILL_AT=kill_at, DEVIAS_KILL_MARKER=os.path.join(out_dir, "stopped"))
    log = open(os.path.join(out_dir, f"stdout_{tag}.log"), "w")
    p = subprocess.Popen([sys.executable, WORKER] + _flags(filelist_dir, out_dir), env=env, stdout=log,
                         stderr=subprocess.STDOUT, text=True)
    p.log = log
    return p


def _finish(p):
    p.wait(timeout=TIMEOUT)
    p.log.close()
    with open(p.log.name) as f:
        text = f.read()
    assert p.returncode == 0, text[-3000:]
    return text


def _kill_at_marker(p, out_dir):
    marker = os.path.join(out_dir, "stopped")
    deadline = time.monotonic() + TIMEOUT
    while not os.path.exists(marker):
        assert p.poll() is None, "the run ended before its stopping point"
        assert time.monotonic() < deadline, "the stopping point was never reached"
        time.sleep(0.05)
    os.kill(p.pid, signal.SIGKILL)
    p.wait(timeout=60)
    p.log.close()
    assert p.returncode == -signal.SIGKILL
    os.remove(marker)


def _train_records(out_dir):
    recs = {}
    with open(os.path.join(out_dir, "log.txt")) as f:
        for line in f:
            r = json.loads(line)
            if "epoch" in r and "train_loss" in r:
                recs[r["epoch"]] = {k: v for k, v in r.items()
                                    if k.startswith("train_") and k != "train_time_s"}
    return recs


def _assert_same(a, b, where):
    if isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor) and a.dtype == b.dtype and torch.equal(a, b), where
    elif isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a, key=str) == sorted(b, key=str), where
        for k in a:
            _assert_same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{where}[{i}]")
    else:
        assert a == b, (where, a, b)


def _final_checkpoint(out_dir):
    return torch.load(os.path.join(out_dir, "ckpt", f"checkpoint-{EPOCHS - 1}.pth"), map_location="cpu",
                      weights_only=True)


@pytest.fixture(scope="module")
def filelist_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("fl")
    (d / "train.csv").write_text("\n".join(f"v{i}.mp4 {i % 5}" for i in range(16)))
    (d / "val.csv").write_text("\n".join(f"w{i}.mp4 {i % 5}" for i in range(8)))
    (d / "test.csv").write_text("\n".join(f"w{i}.mp4 {i % 5}" for i in range(4)))
    return str(d)


@pytest.fixture(scope="module")
def uninterrupted(filelist_dir, tmp_path_factory):
    out = str(tmp_path_factory.mktemp("uninterrupted"))
    _finish(_spawn(filelist_dir, out, "full"))
    recs = _train_records(out)
    assert sorted(recs) == list(range(EPOCHS))
    return recs, _final_checkpoint(out)


@pytest.mark.parametrize("kill_at, resumed_from", [("step", 1), ("save", 0)], ids=["mid_epoch", "mid_write"])
def test_sigkill_then_resume_equals_the_uninterrupted_run(filelist_dir, uninterrupted, tmp_path, kill_at,
                                                          resumed_from):
    out = str(tmp_path)
    ckpt = os.path.join(out, "ckpt")
    point = f"step:{2 * STEPS + 1}" if kill_at == "step" else "save:1"
    _kill_at_marker(_spawn(filelist_dir, out, "killed", point), out)
    saved = sorted(os.listdir(ckpt))
    if kill_at == "step":
        assert saved == ["checkpoint-0.pth", "checkpoint-1.pth"], saved
        assert sorted(_train_records(out)) == [0, 1]
    else:
        assert saved[0] == "checkpoint-0.pth" and len(saved) == 2, saved
        stale = saved[1]
        assert stale.startswith("checkpoint-1.pth.") and stale.endswith(".tmp"), saved
        assert sorted(_train_records(out)) == [0]

    text = _finish(_spawn(filelist_dir, out, "resumed"))
    assert f"auto-resumed from epoch {resumed_from}" in text
    if kill_at == "save":
        assert stale in os.listdir(ckpt)

    want_recs, want_ckpt = uninterrupted
    assert _train_records(out) == want_recs
    got = _final_checkpoint(out)
    assert sorted(got) == sorted(want_ckpt)
    assert got["model_ema"] is not None and got["rng"] is not None
    _assert_same(got, want_ckpt, "checkpoint")
