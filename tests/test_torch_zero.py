"""ZeRO-1 and FSDP in the port (`core/dist.py::shard_train_state`) against
the JAX package's, in float32 at a small size (depth 2, width 64, 4 heads,
4x32x32 clips, no FAME, AdamW with the global-norm clip and the EMA):

(a) `zero1_axis` is `zero1_spec`'s rule on every leaf of the small slot
    model's tree, at 2, 4 and 8 data ranks;
(b) two DP + ZeRO-1 steps over four ranks against the JAX step with
    `shard_train_state(zero1=True)` on a 4-device data mesh, then the same
    with `fsdp=True`, at `tests/test_torch_data_parallel.py`'s tolerances;
(c) both bitwise equal to the port's own DP run of the same steps;
(d) between steps each rank holds a quarter of every cut moment (ZeRO-1)
    and of every cut parameter, moment and EMA entry (FSDP); the leaves
    with no axis to cut stay whole;
(e) a checkpoint saved under ZeRO-1 loads in one process and equals the DP
    run's checkpoint; an FSDP run saved after its first step and resumed
    into a placed state takes the second step bitwise as the run straight
    through.

The JAX side runs in the pytest process on a 4-device slice of the
conftest CPU mesh with the unfused attention; the port side runs in four
gloo processes, this file being their program (`python
tests/test_torch_zero.py RANK DIR`; it imports no JAX at module level)."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from _torch_parallel import TEACHER, WORLD, T, HW, check_trajectory, jax_params, port_models, run_ranks  # noqa: E402

SLOT = dict(num_classes=5, num_scene_classes=4, num_latents=2, agg_depth=2, depth=2, embed_dim=64, num_heads=4)
OPT = dict(lr=1e-3, min_lr=1e-5, warmup_lr=1e-4, total_steps=8, warmup_steps=1, layer_decay=0.75,
           agg_block_scale=0.1, weight_decay=0.05, weight_decay_end=0.1, num_layers=2, clip_grad=1.0)
B, STEPS = 2 * WORLD, 2
MODES = ("zero1", "fsdp")


# ------------------------------------------------------------------ the JAX side


def _jax_side(out: Path) -> dict:
    import jax
    import jax.numpy as jnp

    from devias_tpu.core.dist import make_mesh, shard_batch, shard_train_state
    from devias_tpu.losses import SlotLossConfig as JaxSlotLossConfig
    from devias_tpu.train import OptimConfig as JaxOptimConfig
    from devias_tpu.train import TrainState as JaxTrainState
    from devias_tpu.train import TrainStepConfig as JaxTrainStepConfig
    from devias_tpu.train import make_optimizer as jax_make_optimizer
    from devias_tpu.train import make_slot_train_step as jax_make_slot_train_step
    from devias_tpu_torch.ckpt.from_jax import state_dict_from_jax

    jm, params = jax_params("slot_vit_base_patch16_224", 3, **SLOT)
    jt, tparams = jax_params("vit_base_patch16_224", 4, **TEACHER)
    tx, lr_fn = jax_make_optimizer(params, JaxOptimConfig(**OPT))
    step = jax.jit(jax_make_slot_train_step(jm, jt, tx, JaxSlotLossConfig(5, 4), JaxTrainStepConfig(use_fame=False),
                                            lr_fn))
    mesh = make_mesh(devices=jax.devices()[:WORLD])
    data = np.random.default_rng(5)
    batches = [{"videos": data.normal(size=(B, T, HW, HW, 3)).astype(np.float32),
                "labels": data.integers(0, 5, size=B)} for _ in range(STEPS)]
    ref = {"student": state_dict_from_jax(params, "slot", SLOT["agg_depth"]),
           "teacher": state_dict_from_jax(tparams, "plain"), "batches": batches}
    teacher = jax.device_put(tparams, jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec()))
    for mode in MODES:
        state = shard_train_state(JaxTrainState.create(params, tx, use_ema=True), mesh, **{mode: True})
        metrics = []
        for s, batch in enumerate(batches):
            with mesh:
                state, m = step(state, teacher, shard_batch({k: jnp.asarray(v) for k, v in batch.items()}, mesh),
                                jax.random.PRNGKey(s))
            metrics.append({k: float(v) for k, v in m.items()})
        ref[mode] = {"metrics": metrics,
                     "final": state_dict_from_jax(jax.tree.map(np.asarray, state.params), "slot", SLOT["agg_depth"])}
    torch.save(ref, out / "ref.pt")
    return ref


# ------------------------------------------------------------------ the port


def _state(ref):
    from devias_tpu_torch.train import OptimConfig, TrainState, make_optimizer

    model, teacher = port_models(ref["student"], ref["teacher"], SLOT)
    opt, lr_fn = make_optimizer(model, OptimConfig(**OPT), device="cpu")
    return model, teacher, TrainState.create(model, opt, use_ema=True, device="cpu"), lr_fn


def _run(ref, rank, mode, out, resume_from=None):
    """Two steps on this rank's clips, placed as `mode` asks (None: DP).
    Returns metrics, the final full parameters and EMA, the summed lr and
    each step's resident bytes; writes a checkpoint after the first step
    (FSDP) or at the end. With `resume_from`, the state loads that
    checkpoint first and takes only the second step."""
    from devias_tpu_torch.ckpt import load_checkpoint, save_checkpoint
    from devias_tpu_torch.core.dist import make_mesh, resident_bytes, shard_train_state
    from devias_tpu_torch.losses import SlotLossConfig
    from devias_tpu_torch.train import TrainStepConfig, make_slot_train_step

    mesh = make_mesh()
    model, teacher, state, lr_fn = _state(ref)
    if mode is not None:
        shard_train_state(state, mesh, **{mode: True})
    step = make_slot_train_step(model, teacher, state.optimizer, SlotLossConfig(5, 4),
                                TrainStepConfig(use_fame=False), lr_fn, dp_mesh=mesh, device="cpu")
    first = 0
    if resume_from is not None:
        load_checkpoint(str(resume_from / "checkpoint-0.pth"), state)
        first = 1
    metrics, resident = [], []
    for s in range(first, STEPS):
        mine = {k: v[rank * 2:(rank + 1) * 2] for k, v in ref["batches"][s].items()}
        metrics.append(step(state, mine, host_metrics=True))
        if state.placement is not None:
            resident.append(resident_bytes(state))
        if mode == "fsdp" and s == 0 and resume_from is None:
            save_checkpoint(str(out / "fsdp_ckpt"), 0, state, write=rank == 0)
    if mode != "fsdp":
        save_checkpoint(str(out / f"{mode or 'dp'}_ckpt"), 0, state, write=rank == 0)
    if state.placement is not None:
        state.placement.gather_params()
        ema = state.placement.full_ema(state.ema_params)
    else:
        ema = state.ema_params
    final = {n: p.detach().clone() for n, p in model.named_parameters()}
    return {"metrics": metrics, "final": final, "ema": {k: v.clone() for k, v in ema.items()},
            "lr_sum": sum(lr_fn(s) for s in range(STEPS)), "resident": resident,
            "shapes": {n: tuple(p.shape) for n, p in model.named_parameters()}}


def _rank_main(rank: int, out: Path) -> None:
    import torch.distributed as dist

    from devias_tpu_torch.core.dist import maybe_init_distributed

    torch.set_num_threads(1)
    assert maybe_init_distributed("cpu") and dist.get_backend() == "gloo"
    ref = torch.load(out / "ref.pt", weights_only=False)
    res = {mode: _run(ref, rank, mode, out) for mode in (None, *MODES)}
    res["fsdp_resumed"] = _run(ref, rank, "fsdp", out, resume_from=out / "fsdp_ckpt")
    torch.save(res, out / f"rank{rank}.pt")
    dist.destroy_process_group()


# ------------------------------------------------------------------ the tests


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    out = tmp_path_factory.mktemp("zero")
    ref = _jax_side(out)
    return ref, run_ranks(__file__, out), out


@pytest.mark.parametrize("n", [2, 4, 8])
def test_zero1_axis_is_zero1_spec(n):
    import jax
    import jax.numpy as jnp

    from devias_tpu.core.dist import DATA_AXIS, zero1_spec
    from devias_tpu.nn import create_model as jax_create_model
    from devias_tpu_torch.core.dist import zero1_axis

    model = jax_create_model("slot_vit_base_patch16_224", **SLOT)
    tree = jax.eval_shape(lambda: model.init({"params": jax.random.PRNGKey(0)}, jnp.zeros((2, T, HW, HW, 3))))
    leaves = jax.tree_util.tree_leaves_with_path(tree["params"])
    assert len(leaves) > 40
    for path, leaf in leaves:
        spec = tuple(zero1_spec(leaf, n))
        want = spec.index(DATA_AXIS) if DATA_AXIS in spec else None
        got = zero1_axis(leaf.shape, n, bool(jnp.issubdtype(leaf.dtype, jnp.inexact)))
        assert got == want, (jax.tree_util.keystr(path), leaf.shape)


@pytest.mark.parametrize("mode", MODES)
def test_trajectory_matches_jax(run, mode):
    """(b) each rank's ZeRO-1 or FSDP trajectory against the JAX step with
    the same placement."""
    ref, ranks, _ = run
    for res in ranks:
        got = res[mode]
        check_trajectory(got["metrics"], {n: p.numpy() for n, p in got["final"].items()}, got["lr_sum"],
                         ref[mode]["metrics"], ref[mode]["final"])


@pytest.mark.parametrize("mode", MODES)
def test_bitwise_equal_to_the_data_parallel_run(run, mode):
    """(c) the same arithmetic as DP, element for element: metrics,
    parameters and EMA on every rank."""
    _, ranks, _ = run
    for res in ranks:
        dp, got = res[None], res[mode]
        assert got["metrics"] == dp["metrics"]
        for part in ("final", "ema"):
            for name, t in dp[part].items():
                assert torch.equal(got[part][name], t), (mode, part, name)


@pytest.mark.parametrize("mode", MODES)
def test_resident_at_a_quarter_between_steps(run, mode):
    """(d) this rank's bytes after each step: the cut leaves at 1/4."""
    from devias_tpu_torch.core.dist import zero1_axis

    _, ranks, _ = run
    shapes = ranks[0][None]["shapes"]
    full = {n: 4 * int(np.prod(s)) for n, s in shapes.items()}
    quarter = {n: b // WORLD if zero1_axis(shapes[n], WORLD) is not None else b for n, b in full.items()}
    assert sum(quarter.values()) < 0.3 * sum(full.values())
    want = {"moments": 2 * sum(quarter.values()),
            "params": sum((quarter if mode == "fsdp" else full).values()),
            "ema": sum((quarter if mode == "fsdp" else full).values())}
    for res in ranks:
        assert res[mode]["resident"] == [want] * 2


def test_zero1_checkpoint_loads_in_one_process_and_equals_dp(run):
    """(e) the ZeRO-1 run's file is the DP run's: loaded into one
    unplaced process, its parameters, EMA and moments equal the DP
    checkpoint's bitwise."""
    from devias_tpu_torch.ckpt import load_checkpoint

    ref, _, out = run
    dp = torch.load(out / "dp_ckpt" / "checkpoint-0.pth", weights_only=True)
    model, _, state, _ = _state(ref)
    load_checkpoint(str(out / "zero1_ckpt" / "checkpoint-0.pth"), state)
    for k, v in dp["model"].items():
        assert torch.equal(model.state_dict()[k], v), k
    for k, v in dp["model_ema"].items():
        assert torch.equal(state.ema_params[k], v), k
    got = state.optimizer.state_dict()
    assert got["count"] == dp["optimizer"]["count"] == STEPS
    for i, bufs in dp["optimizer"]["state"].items():
        for k, v in bufs.items():
            assert torch.equal(got["state"][i][k], v), (i, k)


def test_fsdp_resume_continues_exactly(run):
    """(e) an FSDP checkpoint after step 1, loaded into a placed state
    (each rank takes its slices), then step 2: bitwise the run straight
    through."""
    _, ranks, _ = run
    for res in ranks:
        straight, resumed = res["fsdp"], res["fsdp_resumed"]
        assert resumed["metrics"] == straight["metrics"][1:]
        for part in ("final", "ema"):
            for name, t in straight[part].items():
                assert torch.equal(resumed[part][name], t), (part, name)


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), Path(sys.argv[2]))
