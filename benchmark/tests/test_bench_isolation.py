"""What a run may load, where it may read and write, and that it refuses
to run without a card."""

from __future__ import annotations

import os
import subprocess
import sys
import types

import pytest

import run
from harness.spec import BENCH_DIR, ROOT

# the benchmark's own files: the harness, the reference, the readers, the scripts
SOURCES = [os.path.join(d, f) for d, _, files in os.walk(BENCH_DIR) for f in files
           if f.endswith(".py") and os.sep + "tests" not in d and ".cache" not in d]


def _child(code: str, **env) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=600,
                          env={**os.environ, **env})


def test_forbidden_names_are_compared_whole(monkeypatch):
    before = set(run.forbidden_modules())
    # the port's name begins with the JAX package's and is not it
    for name in ("devias_tpu_torch.nn.fake", "jaxtyping_fake", "flaxen_fake"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert set(run.forbidden_modules()) == before
    for name in ("devias_tpu.nn.fake", "jaxlib.xla_client", "optax"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert {"devias_tpu", "jaxlib", "optax"} <= set(run.forbidden_modules())


def test_a_run_loads_no_jax(tmp_path):
    code = f"""
import sys
sys.path[:0] = [{ROOT!r}, {BENCH_DIR!r}, {os.path.join(BENCH_DIR, 'tests')!r}]
import run, control
from harness import spec
from _tiny import tiny_bench
bench = tiny_bench({str(tmp_path)!r})
for name in ("slot-k400-train", "slot-hvu-train", "slot-k400-eval"):
    cell = spec.load_cell(name, *bench)
    [spec.reader(m["name"]) for m in cell.per_layer]
    run.run_cell(cell, 5, 0.2, False, "cpu")
print("LOADED", run.forbidden_modules())
"""
    out = _child(code)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "LOADED []"


def test_the_command_refuses_to_run_without_a_card():
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "slot-k400-train", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""
    assert "CUDA device" in out.stderr


def test_a_run_writes_only_its_own_directories(tmp_path):
    """Caches at fixed paths inside the checkout; final_test's rows under
    TMPDIR and gone after the run; no fixed /tmp path, nothing in /dev/shm."""
    run.set_caches()
    for var in run.CACHE_DIRS:
        assert os.environ[var].startswith(os.path.join(BENCH_DIR, ".cache") + os.sep)
    for path in SOURCES:
        with open(path) as f:
            text = f.read()
        assert "/tmp" not in text and "/dev/shm" not in text, path
    tmpdir = tmp_path / "tmpdir"
    tmpdir.mkdir()
    code = f"""
import sys, tempfile
sys.path[:0] = [{ROOT!r}, {BENCH_DIR!r}, {os.path.join(BENCH_DIR, 'tests')!r}]
import run
from harness import spec
from _tiny import tiny_bench
bench = tiny_bench({str(tmp_path / 'bench')!r})
assert tempfile.gettempdir() == {str(tmpdir)!r}
result = run.run_cell(spec.load_cell("slot-k400-eval", *bench), 7, 0.3, False, "cpu")
print("CLIPS", result["attempted"])
"""
    (tmp_path / "bench").mkdir()
    out = _child(code, TMPDIR=str(tmpdir))
    assert out.returncode == 0, out.stderr[-2000:]
    assert int(out.stdout.split("CLIPS")[-1]) > 0
    assert os.listdir(tmpdir) == []


@pytest.mark.cuda
def test_a_cell_runs_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "slot-k400-eval", "--seed", "17",
                          "--seconds", "2", "--trace", "0"], cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-2000:]
    assert '"correct": true' in out.stdout.strip().splitlines()[-1]
