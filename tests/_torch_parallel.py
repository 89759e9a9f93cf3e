"""Helpers of the port's parallel-mode tests (`tests/test_torch_zero.py`,
`test_torch_tensor_parallel.py`, `test_torch_pipeline.py`), not a test: the
small models' JAX parameters, the four gloo ranks each file runs as its own
program, and the trajectory check of `tests/test_torch_data_parallel.py`."""

import os
import socket
import subprocess
import sys
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


def run_ranks(program: str, out: Path, world: int = WORLD, timeout: int = 300) -> list:
    """Run `program RANK OUT` in `world` processes joined through
    DEVIAS_TPU_COORDINATOR; all must exit 0. Returns each rank's
    `rank{r}.pt`."""
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1",
               DEVIAS_TPU_COORDINATOR=f"127.0.0.1:{_free_port()}", DEVIAS_TPU_NUM_PROCS=str(world))
    procs = [subprocess.Popen([sys.executable, program, str(r), str(out)], cwd=ROOT,
                              env=dict(env, DEVIAS_TPU_PROC_ID=str(r)), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)[-4000:]
    return [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(world)]


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
