"""Tensor parallelism in the port (`core/dist.py::shard_blocks_tp`,
`make_mesh(model_parallel=2)`) against the JAX package's, in float32 at a
small size (depth 2, width 64, 4 heads, 4x32x32 clips, no FAME):

(a) the cut parameters are the leaves `tp_param_spec` cuts, mapped to the
    port's names through `ckpt/from_jax.py`;
(b) a two-step trajectory over two data rows of two model ranks against
    the JAX step on `make_mesh(model_parallel=2)` with
    `shard_train_state(tp=True)`, also with LayerScale (`init_values`
    0.1: the gammas stay whole on every rank, as `tp_param_spec` leaves
    them): the loss at rel 2e-4, and the final
    parameters, gathered back to the reference layout, at rel 2e-4 / atol
    2e-5, as `tests/test_tp_full_step.py` holds JAX's own TP step (the one
    bias whose true gradient is zero, `ZERO_GRAD`, within the two steps'
    lr); every rank gathers the same state, bitwise;
(c) the TP eval forward (K1's plain version on 2 of the 4 heads per rank)
    against the one-process forward of the same weights, for (b)'s
    students and one without the q and v biases (the qkv rows still cut by
    heads);
(d) `tp` with `zero1` or `fsdp` raises.

The JAX side runs in the pytest process on a 4-device slice of the
conftest CPU mesh with the unfused attention; the port side runs in four
gloo processes, this file being their program (`python
tests/test_torch_tensor_parallel.py RANK DIR`)."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from _torch_parallel import TEACHER, WORLD, ZERO_GRAD, T, HW, jax_params, port_models, run_ranks  # noqa: E402

SLOT = dict(num_classes=5, num_scene_classes=4, num_latents=2, agg_depth=2, depth=2, embed_dim=64, num_heads=4)
OPT = dict(lr=1e-3, total_steps=20, warmup_steps=0, num_layers=2)
B, STEPS, TP = 8, 2, 2
LR_SUM = STEPS * OPT["lr"]  # no warmup: the lr of both steps is at most OPT's
# the student's options per trajectory
VARIANTS = {"plain": {}, "layerscale": dict(init_values=0.1)}
# and for the eval forward only (the plain student's weights without the biases)
EVAL_VARIANTS = dict(VARIANTS, no_qkv_bias=dict(qkv_bias=False))


def _jax_side(out: Path) -> dict:
    import jax
    import jax.numpy as jnp

    from devias_tpu.core.dist import make_mesh, shard_train_state
    from devias_tpu.losses import SlotLossConfig as JaxSlotLossConfig
    from devias_tpu.train import OptimConfig as JaxOptimConfig
    from devias_tpu.train import TrainState as JaxTrainState
    from devias_tpu.train import TrainStepConfig as JaxTrainStepConfig
    from devias_tpu.train import make_optimizer as jax_make_optimizer
    from devias_tpu.train import make_slot_train_step as jax_make_slot_train_step
    from devias_tpu_torch.ckpt.from_jax import state_dict_from_jax

    jt, tparams = jax_params("vit_base_patch16_224", 4, **TEACHER)
    mesh = make_mesh(model_parallel=TP, devices=jax.devices()[:WORLD])
    data = np.random.default_rng(5)
    batches = [{"videos": data.normal(size=(B, T, HW, HW, 3)).astype(np.float32) * 0.3,
                "labels": data.integers(0, 5, size=B)} for _ in range(STEPS)]
    ref = {"teacher": state_dict_from_jax(tparams, "plain"), "batches": batches}
    for variant, kw in VARIANTS.items():
        jm, params = jax_params("slot_vit_base_patch16_224", 3, **SLOT, **kw)
        tx, lr_fn = jax_make_optimizer(params, JaxOptimConfig(**OPT))
        step = jax.jit(jax_make_slot_train_step(jm, jt, tx, JaxSlotLossConfig(5, 4),
                                                JaxTrainStepConfig(use_fame=False), lr_fn))
        state = shard_train_state(JaxTrainState.create(params, tx), mesh, tp=True)
        metrics = []
        for batch in batches:
            with mesh:
                state, m = step(state, tparams, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(5))
            metrics.append({k: float(v) for k, v in m.items()})
        ref[variant] = {"student": state_dict_from_jax(params, "slot", SLOT["agg_depth"]), "metrics": metrics,
                        "final": state_dict_from_jax(jax.tree.map(np.asarray, state.params), "slot",
                                                     SLOT["agg_depth"])}
    torch.save(ref, out / "ref.pt")
    return ref


def _rank_main(rank: int, out: Path) -> None:
    import torch.distributed as dist

    from devias_tpu_torch.core.dist import make_mesh, maybe_init_distributed, shard_train_state
    from devias_tpu_torch.losses import SlotLossConfig
    from devias_tpu_torch.train import OptimConfig, TrainState, TrainStepConfig, make_optimizer, make_slot_train_step

    torch.set_num_threads(1)
    assert maybe_init_distributed("cpu") and dist.get_backend() == "gloo"
    ref = torch.load(out / "ref.pt", weights_only=False)
    mesh = make_mesh(model_parallel=TP)
    local = B // mesh.data_size
    rows = slice(mesh.data_rank * local, (mesh.data_rank + 1) * local)
    clips = torch.from_numpy(ref["batches"][0]["videos"][rows])
    res = {"layout": (mesh.data_rank, mesh.data_size, mesh.model_rank, mesh.model_size)}
    for variant, kw in EVAL_VARIANTS.items():
        student = ref[variant if variant in VARIANTS else "plain"]["student"]
        if not kw.get("qkv_bias", True):
            student = {k: v for k, v in student.items() if not k.endswith(("q_bias", "v_bias"))}
        model, teacher = port_models(student, ref["teacher"], dict(SLOT, **kw))
        plain, _ = port_models(student, ref["teacher"], dict(SLOT, **kw))
        opt, lr_fn = make_optimizer(model, OptimConfig(**OPT), device="cpu")
        state = shard_train_state(TrainState.create(model, opt, device="cpu"), mesh, tp=True)
        with torch.no_grad():
            got = {"eval": model.eval()(clips)["action_logit"], "eval_one_process": plain.eval()(clips)["action_logit"],
                   "qkv_shape": tuple(model.blocks[0].attn.qkv.weight.shape)}
        if variant not in VARIANTS:
            res[variant] = got
            continue
        step = make_slot_train_step(model, teacher, opt, SlotLossConfig(5, 4), TrainStepConfig(use_fame=False),
                                    lr_fn, dp_mesh=mesh, device="cpu")
        got["metrics"] = [step(state, {k: v[rows] for k, v in b.items()}, host_metrics=True) for b in ref["batches"]]
        names = dict(model.named_parameters())  # a tied agg round's other keys name the same tensors
        got["final"] = {k: v for k, v in state.placement.full_model_state().items() if k in names}
        got["gamma_shape"] = None if model.blocks[0].gamma_1 is None else tuple(model.blocks[0].gamma_1.shape)
        res[variant] = got
    torch.save(res, out / f"rank{rank}.pt")
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    out = tmp_path_factory.mktemp("tp")
    ref = _jax_side(out)
    return ref, run_ranks(__file__, out)


def test_cut_parameters_are_tp_param_spec_leaves():
    """(a) both sets, by the port's names."""
    import jax
    import jax.numpy as jnp

    from devias_tpu.core.dist import tp_param_spec
    from devias_tpu.nn import create_model as jax_create_model
    from devias_tpu_torch.ckpt.from_jax import state_dict_from_jax
    from devias_tpu_torch.core.dist import SPMesh, shard_blocks_tp
    from devias_tpu_torch.nn import create_model

    jm = jax_create_model("slot_vit_base_patch16_224", **SLOT)
    tree = jax.eval_shape(lambda: jm.init({"params": jax.random.PRNGKey(0)}, jnp.zeros((2, T, HW, HW, 3))))["params"]
    marked = jax.tree_util.tree_map_with_path(
        lambda path, leaf: np.full(leaf.shape, float(tuple(tp_param_spec(path, leaf)) != ()), np.float32), tree)
    sd = state_dict_from_jax(marked, "slot", SLOT["agg_depth"])
    want = {k for k, v in sd.items() if v.size and np.all(v == 1.0)}
    assert all(np.all(v == 0.0) for k, v in sd.items() if k not in want), "a port tensor mixes cut and whole leaves"
    model = create_model("slot_vit_base_patch16_224", device="cpu", img_size=HW, **SLOT)
    mesh = SPMesh(seq_group=None, seq_rank=0, seq_size=1, model_rank=1, model_size=TP)
    got = set(shard_blocks_tp(model, mesh))
    assert got == want
    assert got == {f"blocks.{i}.{n}" for i in range(SLOT["depth"]) for n in (
        "attn.qkv.weight", "attn.proj.weight", "mlp.fc1.weight", "mlp.fc1.bias", "mlp.fc2.weight")}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_trajectory_matches_jax_and_ranks_agree(run, variant):
    """(b) loss per step, and the gathered final parameters."""
    ref, ranks = run
    want = ref[variant]
    assert [r["layout"] for r in ranks] == [(r // TP, WORLD // TP, r % TP, TP) for r in range(WORLD)]
    for res in (r[variant] for r in ranks):
        assert res["qkv_shape"] == (3 * 64 // TP, 64)
        assert res["gamma_shape"] == ((64,) if variant == "layerscale" else None)
        for m, w in zip(res["metrics"], want["metrics"]):
            assert m["loss"] == pytest.approx(w["loss"], rel=2e-4)
        assert set(res["final"]) == {k for k in want["final"] if not k.startswith("agg_block.layers.1.")}
        for name, v in res["final"].items():
            if name in ZERO_GRAD:  # Adam's step on rounding noise: within the two steps' lr
                assert np.abs(v.numpy() - want["final"][name]).max() <= 2 * LR_SUM, name
            else:
                np.testing.assert_allclose(v.numpy(), want["final"][name], rtol=2e-4, atol=2e-5, err_msg=name)
    for res in ranks[1:]:
        for name, v in res[variant]["final"].items():
            assert torch.equal(v, ranks[0][variant]["final"][name]), name


@pytest.mark.parametrize("variant", sorted(EVAL_VARIANTS))
def test_tp_eval_forward_matches_the_one_process_forward(run, variant):
    """(c) the TP forward in eval mode, each rank's own row of clips."""
    _, ranks = run
    for res in ranks:
        assert res[variant]["qkv_shape"] == (3 * 64 // TP, 64)
        torch.testing.assert_close(res[variant]["eval"], res[variant]["eval_one_process"], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("other", ["zero1", "fsdp"])
def test_tp_with_zero1_or_fsdp_raises(other):
    """(d) as `devias_tpu/core/dist.py::shard_train_state` refuses it."""
    from devias_tpu_torch.core.dist import shard_train_state

    with pytest.raises(ValueError, match="not supported"):
        shard_train_state(None, None, tp=True, **{other: True})


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), Path(sys.argv[2]))
