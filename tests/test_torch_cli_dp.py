"""`run_slot_finetuning` of the port over two gloo processes on the CPU,
tiny model, synthetic clips:

- data parallelism (two data rows): the shuffled training shards of an
  epoch are disjoint and cover the list; the logged `train_lr` is twice a
  one-process run's (the global batch doubles); a run stopped after epoch
  0 and resumed with --auto_resume equals two epochs straight, bitwise;
  --dist_eval's two result files merge to the one-process merge of the
  same list, and the --run_knn banks equal the one-process banks;
- `--sp_shards 2` (one data row of two seq ranks) logs the one-process
  `train_lr`: both ranks read the same batch, so the global batch is one
  rank's.

The file is also the program of each process (`python
tests/test_torch_cli_dp.py SPEC_JSON`), which records the loader's
training shards and can stop the run after epoch 0's record."""

import json
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from _torch_parallel import join, start_ranks  # noqa: E402

N_TRAIN = 16
BASE = [
    "--device", "cpu", "--synthetic_data", "--smoke_tiny", "--batch_size", "4", "--num_frames", "8",
    "--sampling_rate", "2", "--input_size", "32", "--short_side_size", "32", "--test_num_segment", "2",
    "--test_num_crop", "2", "--num_workers", "2", "--data_set", "UCF101", "--nb_classes", "5", "--num_latents", "2",
    "--agg_depth", "2", "--agg_weights_tie",
]
# one step an epoch and no warmup: each epoch's logged train_lr is the
# schedule at its first step, and epoch 0's is the scaled lr itself,
# 0.064 x 4 / 256 = 1e-3 in one process (the log keeps six decimals)
TRAIN = ["--epochs", "2", "--max_steps_per_epoch", "1", "--warmup_epochs", "0", "--lr", "0.064", "--mask_model",
         "FAME", "--save_ckpt_freq", "1", "--model_ema", "--drop_path", "0.1"]
EVAL = ["--eval", "--run_knn", "--nb_knn", "3"]
RANKS_TIMEOUT = 180  # s: over three times the file's slowest test under -n 6, 49.64 s


class _Stop(Exception):
    pass


def _process_main(spec: dict) -> None:
    """One process of a run: `spec` holds argv, the file to write and
    whether to stop after epoch 0's record."""
    import torch.distributed as dist

    from devias_tpu_torch.cli import common
    from devias_tpu_torch.cli import run_slot_finetuning as cli
    from devias_tpu_torch.data import loader

    shards = []
    shard_indices = loader.shard_indices

    def recording(n, shard, num_shards, shuffle, seed, epoch, pad=True):
        idx = shard_indices(n, shard, num_shards, shuffle, seed, epoch, pad)
        if shuffle:  # the training loader's epoch order
            shards.append({"epoch": epoch, "shard": shard, "num_shards": num_shards, "indices": idx.tolist()})
        return idx

    loader.shard_indices = recording
    if spec["stop"]:
        write = common.JsonlLogger.write

        def write_then_stop(self, record):
            write(self, record)
            if record.get("epoch") == 0:
                raise _Stop

        common.JsonlLogger.write = write_then_stop
    try:
        cli.main(cli.get_args(spec["argv"]))
    except _Stop:
        pass
    rank = dist.get_rank()
    with open(spec["out"] + f".{rank}.json", "w") as f:
        json.dump({"shards": shards}, f)
    dist.destroy_process_group()


def _start(argv, out, stop=False):
    """Start one run of two processes (`_process_main`)."""
    spec = json.dumps({"argv": argv, "out": str(out), "stop": stop})
    return start_ranks([[__file__, spec]] * 2, timeout=RANKS_TIMEOUT)


def _records(path):
    with open(path) as f:
        return [{k: v for k, v in json.loads(line).items() if k != "train_time_s"} for line in f]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from devias_tpu_torch.cli import run_slot_finetuning as cli

    tmp = tmp_path_factory.mktemp("clidp")
    data = tmp / "fl"
    data.mkdir()
    for name, rows in (("train.csv", N_TRAIN), ("val.csv", 8), ("test.csv", 8)):
        (data / name).write_text("\n".join(f"{name[0]}{i}.mp4 {i % 5}" for i in range(rows)))
    base = BASE + ["--data_path", str(data)]
    out = {k: tmp / k for k in ("dp", "dp_stop", "dp_eval", "sp", "one", "one_eval")}
    first = {
        "dp": _start(base + TRAIN + ["--dist_eval", "--output_dir", str(out["dp"])], out["dp"]),
        "dp_stop": _start(base + TRAIN + ["--dist_eval", "--output_dir", str(out["dp_stop"])], out["dp_stop"],
                          stop=True),
        "dp_eval": _start(base + EVAL + ["--dist_eval", "--output_dir", str(out["dp_eval"])], out["dp_eval"]),
        "sp": _start(base + TRAIN + ["--sp_shards", "2", "--epochs", "1", "--output_dir", str(out["sp"])], out["sp"]),
    }
    try:
        # the one-process runs, meanwhile
        cli.main(cli.get_args(base + TRAIN + ["--epochs", "1", "--output_dir", str(out["one"])]))
        cli.main(cli.get_args(base + EVAL + ["--output_dir", str(out["one_eval"])]))
    finally:
        join(*first.values())
    join(_start(base + TRAIN + ["--dist_eval", "--auto_resume", "--output_dir", str(out["dp_stop"])],
                tmp / "dp_resume"))
    out["dp_resume"] = tmp / "dp_resume"
    return out


def _shards(out):
    return [json.load(open(f"{out}.{r}.json"))["shards"] for r in range(2)]


def test_train_shards_are_disjoint_and_cover_the_list(runs):
    ranks = _shards(runs["dp"])
    for epoch in (0, 1):
        parts = [[s for s in r if s["epoch"] == epoch] for r in ranks]
        assert [len(p) for p in parts] == [1, 1]
        a, b = parts[0][0], parts[1][0]
        assert (a["shard"], a["num_shards"], b["shard"], b["num_shards"]) == (0, 2, 1, 2)
        assert not set(a["indices"]) & set(b["indices"])
        assert sorted(a["indices"] + b["indices"]) == list(range(N_TRAIN))
    assert ranks[0][0]["indices"] != ranks[0][1]["indices"]  # reshuffled each epoch


def test_data_parallel_lr_scales_with_the_data_rows(runs):
    one = _records(runs["one"] / "log.txt")[0]["train_lr"]
    dp = _records(runs["dp"] / "log.txt")[0]["train_lr"]
    assert (one, dp) == (1e-3, 2e-3)


def test_sp_shards_lr_counts_batch_copies_not_seq_ranks(runs):
    """Both seq ranks of the one data row read the same batch: the lr is
    the one-process run's, not twice it."""
    one = _records(runs["one"] / "log.txt")[0]["train_lr"]
    sp = _records(runs["sp"] / "log.txt")
    assert len(sp) == 2 and sp[0]["n_steps"] == 1 and np.isfinite(sp[0]["train_loss"])
    assert sp[0]["train_lr"] == one
    assert sorted(os.listdir(runs["sp"] / "test")) == ["0.txt", "1.txt"]


def test_data_parallel_resume_equals_two_epochs_straight(runs):
    straight, resumed = runs["dp"], runs["dp_stop"]
    assert [s["epoch"] for s in _shards(runs["dp_resume"])[0]] == [1]
    a = torch.load(straight / "ckpt" / "checkpoint-1.pth", weights_only=True)
    b = torch.load(resumed / "ckpt" / "checkpoint-1.pth", weights_only=True)
    assert a["step"] == b["step"] == 2 and torch.equal(a["rng"], b["rng"])
    for part in ("model", "model_ema"):
        for k, v in a[part].items():
            assert torch.equal(v, b[part][k]), (part, k)
    assert _records(straight / "log.txt") == _records(resumed / "log.txt")
    for r in (0, 1):
        assert (straight / "test" / f"{r}.txt").read_text() == (resumed / "test" / f"{r}.txt").read_text()


def test_dist_eval_merges_and_knn_banks_equal_one_process(runs):
    from devias_tpu_torch.eval import merge_results, parse_result_file

    dp, one = runs["dp_eval"], runs["one_eval"]
    rows = [parse_result_file(str(dp / "test" / f"{r}.txt")) for r in (0, 1)]
    assert {(r[0], r[3], r[4]) for r in rows[0]}.isdisjoint({(r[0], r[3], r[4]) for r in rows[1]})
    assert len(rows[0]) + len(rows[1]) == len(parse_result_file(str(one / "test" / "0.txt"))) == 32
    assert merge_results(str(dp / "test"), 2) == merge_results(str(one / "test"), 1)
    banks = sorted(n for n in os.listdir(one) if n.endswith(".pth"))
    assert len(banks) == 3 * 8 and banks == sorted(n for n in os.listdir(dp) if n.endswith(".pth"))
    for name in banks:
        got, want = torch.load(dp / name), torch.load(one / name)
        assert got.shape == want.shape and got.dtype == want.dtype, name
        assert torch.equal(got, want), name


if __name__ == "__main__":
    _process_main(json.loads(sys.argv[1]))
