"""The port's profiling utilities (`devias_tpu_torch/utils/profiling.py`)
against the JAX package's, and its dry run (`devias_tpu_torch/dryrun.py`)
on the CPU:

- `StepTimer.summary` is the JAX class's text for the same step times;
- `profile_trace` writes a Chrome trace of a CPU block, and nothing with
  an empty directory;
- `python -m devias_tpu_torch.dryrun 2 --device cpu` (the tiny models over
  two gloo processes) exits 0 within 40 s and prints every mode line."""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
MODE_LINES = ("dp loss=", "dp zero1 loss=", "dp fsdp loss=", "dp x tp loss=", "dp x sp loss=",
              "dp x sp stochastic loss=", "dp x pp FULL slot step loss=", "tiny-geometry fsdp resident")


@pytest.mark.parametrize("times,batch", [([], None), ([0.25], None), ([0.1, 0.2, 0.35], 12)])
def test_step_timer_summary_is_jax_text(times, batch):
    from devias_tpu.utils.profiling import StepTimer as JaxStepTimer
    from devias_tpu_torch.utils import StepTimer

    ours, theirs = StepTimer(device="cpu"), JaxStepTimer()
    ours.times, theirs.times = list(times), list(times)
    assert ours.summary(batch) == theirs.summary(batch)
    assert ours.mean == theirs.mean


def test_step_timer_times_on_the_host_clock():
    from devias_tpu_torch.utils import StepTimer

    timer = StepTimer(device="cpu")
    timer.start()
    time.sleep(0.02)
    dt = timer.stop()
    assert timer.times == [dt] and 0.015 < dt < 1.0


def test_profile_trace_writes_a_trace(tmp_path):
    from devias_tpu_torch.utils import profile_trace

    with profile_trace(str(tmp_path / "trace"), device="cpu"):
        torch.ones(64, 64) @ torch.ones(64, 64)
    with open(tmp_path / "trace" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
    with profile_trace("", device="cpu"):
        pass
    assert os.listdir(tmp_path) == ["trace"]


def test_dryrun_prints_every_mode():
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "devias_tpu_torch.dryrun", "2", "--device", "cpu"], cwd=ROOT,
                          env=dict(os.environ, PYTHONPATH=str(ROOT)), capture_output=True, text=True, timeout=120)
    seconds = time.perf_counter() - t0
    assert proc.returncode == 0, (proc.stdout + proc.stderr)[-4000:]
    lines = proc.stdout.splitlines()
    assert lines[0].startswith("entry ok: [(1, 765), (1, 765)]")
    for mode in MODE_LINES:
        hits = [ln for ln in lines if ln.startswith(f"dryrun_multichip(2): {mode}")]
        assert len(hits) == 1 and hits[0].endswith(" ok"), (mode, proc.stdout)
    assert seconds < 40, seconds
