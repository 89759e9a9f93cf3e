"""The contract of the tests' rank launcher (`tests/_torch_parallel.py`),
with trivial rank programs on the CPU:

- every rank exits 0: each rank's output comes back, in rank order, and
  each rank saw its place in the group;
- one rank fails while another blocks: the group fails at once, naming
  the failed rank, not at the deadline;
- a rank never exits: the group fails at its deadline, naming the ranks
  still running, and no rank is left running;
- a rank runs on the thread budget of its group (`thread_budget`), and
  `run_ranks` returns each rank's `rank{r}.pt`;
- `run_ranks`'s own side fails after starting the ranks: they are killed
  at once, and the side's error is the one raised;
- under pytest-xdist a test of the port runs on its worker's budget."""

import os
import signal
import sys
import time
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from _torch_parallel import join, run_ranks, start_ranks, thread_budget  # noqa: E402

SAY = "import os; print(os.environ['DEVIAS_TPU_PROC_ID'], os.environ['DEVIAS_TPU_NUM_PROCS'])"
BLOCK = "import time; time.sleep(600)"
# `program RANK OUT`, as the parallel test files are their ranks' program
BUDGET = """import os, sys
from pathlib import Path

import torch

rank, out = int(sys.argv[1]), Path(sys.argv[2])
torch.save({"rank": rank, "threads": torch.get_num_threads()}, out / f"rank{rank}.pt")
"""


def test_every_rank_exits_zero_and_its_output_comes_back():
    assert join(start_ranks([["-c", SAY]] * 3, timeout=60)) == ["0 3\n", "1 3\n", "2 3\n"]


def test_a_failed_rank_fails_the_group_at_once():
    t0 = time.monotonic()
    ranks = start_ranks([["-c", BLOCK], ["-c", "import sys; print('rank 1 gives up'); sys.exit(1)"]], timeout=120)
    with pytest.raises(AssertionError, match=r"rank 1 of 2 exited 1:\n(.|\n)*rank 1 gives up"):
        join(ranks)
    assert time.monotonic() - t0 < 30
    assert [p.returncode for p in ranks.procs] == [-signal.SIGKILL, 1]


def test_a_rank_that_never_exits_fails_at_the_deadline_and_none_is_left():
    t0 = time.monotonic()
    ranks = start_ranks([["-c", SAY], ["-c", BLOCK]], timeout=3)
    with pytest.raises(AssertionError, match=r"ranks \[1\] of 2 still running at the deadline"):
        join(ranks)
    assert 3 <= time.monotonic() - t0 < 30
    assert [p.returncode for p in ranks.procs] == [0, -signal.SIGKILL]


def test_a_rank_runs_on_its_groups_thread_budget(tmp_path):
    program = tmp_path / "budget.py"
    program.write_text(BUDGET)
    side, results = run_ranks(program, tmp_path, lambda out, start: start(), world=2, timeout=120)
    assert side is None
    assert [r["rank"] for r in results] == [0, 1]
    assert [r["threads"] for r in results] == [thread_budget(2)] * 2


def test_a_failing_side_kills_its_ranks_at_once(tmp_path):
    program = tmp_path / "block.py"
    program.write_text("import os, sys, time\n"
                       "(__import__('pathlib').Path(sys.argv[2]) / f'pid{sys.argv[1]}').write_text(str(os.getpid()))\n"
                       "time.sleep(600)\n")
    pids = [tmp_path / f"pid{r}" for r in range(2)]

    def side(out, start):
        start()
        while not all(p.exists() and p.read_text() for p in pids):
            time.sleep(0.05)
        raise ValueError("the reference failed")

    t0 = time.monotonic()
    with pytest.raises(ValueError, match="the reference failed"):
        run_ranks(program, tmp_path, side, world=2, timeout=120)
    assert time.monotonic() - t0 < 30
    for p in pids:
        with pytest.raises(ProcessLookupError):
            os.kill(int(p.read_text()), 0)


def test_a_port_test_runs_on_its_workers_thread_budget():
    """Under pytest-xdist the repo root's `conftest.py` gives each test of
    the port its worker's share of the CPUs."""
    if "PYTEST_XDIST_WORKER_COUNT" in os.environ:
        assert torch.get_num_threads() == thread_budget()
