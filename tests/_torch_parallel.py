"""Helpers of the port's tests, not a test.

- `thread_budget`: the torch threads of a pytest-xdist worker while it
  runs a test of the port (the repo root's `conftest.py` sets them) and
  of the rank processes it starts.
- `start_ranks` / `join` / `run_ranks`: the one launcher of the tests'
  gloo rank groups, each group under one deadline. Its users:
  `test_torch_zero.py`, `test_torch_tensor_parallel.py`,
  `test_torch_pipeline.py`, `test_torch_data_parallel.py`,
  `test_torch_seq_parallel.py`, `test_torch_dp_batch_ops.py`,
  `test_torch_multi_task.py` (through `_mt_dp_rank.py`), the CLI files
  `test_torch_cli.py`, `test_torch_cli_dp.py` and `test_torch_cli_sp.py`,
  and `test_torch_parallel_launcher.py`, which holds its contract.
- The small models' JAX parameters and the port's twins of them
  (`jax_params`, `port_models`) and the DP trajectory check of
  `tests/test_torch_data_parallel.py` (`check_trajectory`), shared by the
  ZeRO, TP and PP files, each of which is also its ranks' program."""

import os
import socket
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
T, HW = 4, 32
TEACHER = dict(num_classes=4, use_mean_pooling=False, depth=2, embed_dim=64, num_heads=4)
# a bias every slot query shares cancels in the slot softmax: its true
# gradient is zero and both frameworks return rounding noise
ZERO_GRAD = ("agg_block.layers.0.0.norm.bias",)


def thread_budget(procs: int = 1) -> int:
    """Torch threads for each of `procs` processes that share one test
    worker's part of the CPUs: the CPUs this process may run on, split over
    pytest-xdist's workers (`PYTEST_XDIST_WORKER_COUNT`; one outside xdist)
    and the `procs`, at least one. Many small ops on more threads than
    cores wait on each other."""
    cpus = len(os.sched_getaffinity(0)) if hasattr(os, "sched_getaffinity") else os.cpu_count() or 1
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    return max(1, cpus // (workers * procs))


def jax_params(name: str, seed: int, **kw):
    """(unfused JAX model, numpy parameters) of registry model `name`, with
    a little noise on every leaf so the head is no tie."""
    import jax
    import jax.numpy as jnp

    from devias_tpu.nn import create_model

    model = create_model(name, **kw)
    p = jax.jit(model.init)({"params": jax.random.PRNGKey(seed)}, jnp.zeros((2, T, HW, HW, 3)))["params"]
    rng = np.random.default_rng(seed)
    return model, jax.tree.map(lambda a: np.asarray(a) + 0.05 * rng.normal(size=a.shape).astype(np.float32), p)


def port_models(student_sd: dict, teacher_sd: dict, slot_kw: dict):
    """The port's student and teacher on the CPU from reference-layout
    state dicts."""
    from devias_tpu_torch.nn import create_model

    model = create_model("slot_vit_base_patch16_224", device="cpu", img_size=HW, **slot_kw)
    model.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in student_sd.items()})
    teacher = create_model("vit_base_patch16_224", device="cpu", **TEACHER)
    teacher.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in teacher_sd.items()})
    return model, teacher


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@dataclass
class Ranks:
    """A started rank group: its processes in rank order, each one's output
    file and the monotonic time by which all must have exited."""

    procs: list
    logs: list
    deadline: float


def start_ranks(argvs: list, timeout: float) -> Ranks:
    """Start rank r as `python *argvs[r]` from the repo root, the ranks
    joined through DEVIAS_TPU_COORDINATOR / NUM_PROCS / PROC_ID on a free
    port, each on `thread_budget(len(argvs))` torch threads, with the repo
    and `tests/` on its path. The whole group must end within `timeout`
    seconds of this call (`join`)."""
    world = len(argvs)
    path = os.pathsep.join(filter(None, (str(ROOT), str(ROOT / "tests"), os.environ.get("PYTHONPATH"))))
    env = dict(os.environ, PYTHONPATH=path, OMP_NUM_THREADS=str(thread_budget(world)),
               DEVIAS_TPU_COORDINATOR=f"127.0.0.1:{_free_port()}", DEVIAS_TPU_NUM_PROCS=str(world))
    logs = [tempfile.TemporaryFile("w+") for _ in range(world)]
    procs = [subprocess.Popen([sys.executable, *argv], cwd=ROOT, env=dict(env, DEVIAS_TPU_PROC_ID=str(r)),
                              stdout=log, stderr=subprocess.STDOUT, text=True)
             for r, (argv, log) in enumerate(zip(argvs, logs))]
    return Ranks(procs, logs, time.monotonic() + timeout)


def _output(log) -> str:
    log.seek(0)
    text = log.read()
    log.close()
    return text


def _kill(*groups: Ranks) -> None:
    for p in (p for g in groups for p in g.procs):
        p.kill()
        p.wait()


def join(*groups: Ranks) -> list:
    """Wait for every rank of `groups`; returns each rank's output, group
    by group. Fails as soon as a rank exits non-zero, with its output's
    tail, and at a group's deadline, naming its ranks still running; either
    way it first kills every rank."""
    procs = [p for g in groups for p in g.procs]
    failed = late = None
    try:
        while not failed and not late and not all(p.poll() == 0 for p in procs):
            time.sleep(0.05)
            for i, g in enumerate(groups):
                codes = [p.poll() for p in g.procs]
                failed = failed or next(((i, r) for r, c in enumerate(codes) if c), None)
                if time.monotonic() > g.deadline and None in codes:
                    late = late or (i, [r for r, c in enumerate(codes) if c is None])
    finally:
        _kill(*groups)
    outputs = [[_output(log) for log in g.logs] for g in groups]
    if failed:
        i, r = failed
        raise AssertionError(f"rank {r} of {len(groups[i].procs)} exited {groups[i].procs[r].returncode}:\n"
                             + outputs[i][r][-4000:])
    if late:
        i, running = late
        raise AssertionError(f"ranks {running} of {len(groups[i].procs)} still running at the deadline:\n"
                             + outputs[i][running[0]][-4000:])
    return [text for group in outputs for text in group]


def run_ranks(program: str, out: Path, side, world: int = WORLD, *, timeout: float):
    """`program RANK OUT` in `world` ranks beside `side(out, start)` in
    this process: `side` writes what the ranks read to `out`, calls
    `start()` to start them (`start_ranks`) and goes on while they run.
    Then `join`; returns what `side` returned and each rank's
    `out/rank{r}.pt`. If `side` fails, its ranks are killed."""
    groups = []

    def start():
        groups.append(start_ranks([[str(program), str(r), str(out)] for r in range(world)], timeout))

    try:
        result = side(out, start)
    except BaseException:
        _kill(*groups)
        raise
    assert len(groups) == 1, f"the ranks were started {len(groups)} times"
    join(*groups)
    return result, [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(world)]


def check_trajectory(metrics, final, lr_sum, want_metrics, want_final, rtol=2e-4):
    """Metrics to `rtol`; final parameters within 1e-5 plus 3e-4 of each
    tensor's largest magnitude in 98 % of the elements, the rest within
    twice the summed lr (ZERO_GRAD's tensor is all such elements), as
    `tests/test_torch_data_parallel.py` holds the DP trajectory."""
    assert len(metrics) == len(want_metrics)
    for s, (m, w) in enumerate(zip(metrics, want_metrics)):
        for k in w:
            np.testing.assert_allclose(m[k], w[k], rtol=rtol, atol=1e-6, err_msg=f"step {s} {k}")
    assert final and set(final) <= set(want_final)
    for name, p in final.items():
        g, w = np.asarray(p), want_final[name]
        tol = 1e-5 + 3e-4 * np.abs(w).max()
        off = np.abs(g - w) > tol
        assert name in ZERO_GRAD or off.mean() <= 0.02, (name, off.mean())
        assert np.abs(g - w)[off].max(initial=0) <= 2 * lr_sum, name
