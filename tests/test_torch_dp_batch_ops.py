"""Data-parallel HVU and classification training in the port against the
JAX package's one-process steps on the whole batch, in float32 at a small
size (depth 2, width 64, 4 heads, 4x32x32 clips). Under jit on a data mesh
the JAX steps compute exactly that: FAME-HVU's donor permutation and
mixup's flipped-batch partner range over the global micro-batch, and XLA
moves the donors across shards. The port's ranks hold their own rows, so
both batch ops go through `core/dist.py::over_data_group`.

(a) `make_hvu_train_step(dp_mesh=make_mesh())` with FAME-HVU (prob_aug
    0.8) and update_freq 2 over two gloo ranks, each holding half of every
    micro-batch, against the JAX HVU step on the whole batch, its FAME
    draws rebuilt from its key chain (`tests/_jax_draws.py`);
(b) `make_classification_train_step` with mixup / CutMix (batch mode) and
    soft-target cross-entropy the same way;
both as two-step trajectories: metrics to 2e-4 relative, final parameters
as `tests/test_torch_train.py` holds them, the two ranks bitwise equal;
(c) without explicit draws, the ranks draw the same mix from one
    generator state (`mix_generators`' unfolded stream): each rank's rows
    equal its rows of the op applied to the global batch in one process,
    and their model streams differ.

The JAX side runs in the pytest process; the port side runs in two
processes joined by gloo (this file is their program, `python
tests/test_torch_dp_batch_ops.py RANK DIR`, and imports no JAX at module
level).
The ranks start first, on the weights and batches the pytest process
writes to `ref.pt`; the JAX results are computed while they run."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from _torch_parallel import run_ranks  # noqa: E402

WORLD = 2
SMALL = dict(depth=2, embed_dim=64, num_heads=4)
HVU = dict(num_classes=5, num_scene_classes=4, num_latents=4, agg_depth=2, agg_weights_tie=False, **SMALL)
PLAIN = dict(num_classes=5, **SMALL)
MIXUP = dict(mixup_alpha=0.8, cutmix_alpha=1.0, label_smoothing=0.1, num_classes=5)
OPT = dict(lr=1e-3, min_lr=1e-5, warmup_lr=1e-4, total_steps=8, warmup_steps=1, layer_decay=0.75,
           agg_block_scale=0.8, weight_decay=0.05, weight_decay_end=0.1, num_layers=2)
PROB_AUG = 0.8
U, B, STEPS = 2, 8, 2  # global batch 8 = update_freq 2 x micro-batch 4 = 2 ranks of 2
RANKS_TIMEOUT = 200  # s: over three times the file's slowest test under -n 6, 55.83 s


def _zero_grad(name):
    """A norm bias every slot query shares cancels in the slot softmax: its
    true gradient is zero and both frameworks return rounding noise."""
    return name.startswith("agg_block.layers.") and name.endswith(".0.norm.bias")


# ------------------------------------------------------------------ the JAX side


def _jax_side(out: Path, start) -> dict:
    """Each kind's weights, batches and draws, saved to `out/ref.pt` for
    the ranks, which `start()` then starts; meanwhile the JAX one-process
    trajectory of each kind."""
    import jax
    import jax.numpy as jnp

    from _jax_draws import fame_draws_from_key, mixup_draws_from_key, step_key
    from devias_tpu.aug.fame import FAMEConfig as JaxFAMEConfig
    from devias_tpu.aug.mixup import MixupConfig as JaxMixupConfig
    from devias_tpu.losses import SlotLossConfig as JaxSlotLossConfig
    from devias_tpu.losses import soft_target_cross_entropy
    from devias_tpu.nn import create_model as jax_create_model
    from devias_tpu.train import OptimConfig as JaxOptimConfig
    from devias_tpu.train import TrainState as JaxTrainState
    from devias_tpu.train import TrainStepConfig as JaxTrainStepConfig
    from devias_tpu.train import make_classification_train_step, make_hvu_train_step
    from devias_tpu.train import make_optimizer as jax_make_optimizer
    from devias_tpu_torch.ckpt.from_jax import state_dict_from_jax

    def params_of(name, seed, **kw):
        model = jax_create_model(name, **kw)
        p = model.init({"params": jax.random.PRNGKey(seed)}, jnp.zeros((2, 4, 32, 32, 3)))["params"]
        rng = np.random.default_rng(seed)
        # a non-zero head, so the slot selection is not a tie
        return model, jax.tree.map(lambda a: np.asarray(a) + 0.05 * rng.normal(size=a.shape).astype(np.float32), p)

    data = np.random.default_rng(5)
    key = jax.random.PRNGKey(7)
    ref, steps = {}, {}

    def inputs(kind, model, params, make_step, draws_of):
        batches = []
        for _ in range(STEPS):
            batch = {"videos": data.normal(size=(B, 4, 32, 32, 3)).astype(np.float32),
                     "labels": data.integers(0, 5, size=B), "scene_labels": data.integers(0, 4, size=B)}
            if kind == "class":
                batch.pop("scene_labels")
            batches.append(batch)
        agg = HVU["agg_depth"] if kind == "hvu" else 0
        ref[kind] = {"init": state_dict_from_jax(params, "slot" if kind == "hvu" else "plain", agg),
                     "batches": batches,
                     "draws": [[draws_of(step_key(key, s, U, u)) for u in range(U)] for s in range(STEPS)]}
        steps[kind] = (model, params, make_step)

    jm, params = params_of("slot_vit_base_patch16_224", 3, **HVU)
    inputs("hvu", jm, params,
           lambda m, tx, lr_fn: make_hvu_train_step(m, tx, JaxSlotLossConfig(5, 4), JaxTrainStepConfig(
               update_freq=U, use_fame=True, fame=JaxFAMEConfig(prob_aug=PROB_AUG)), lr_fn),
           lambda k: fame_draws_from_key(jax.random.split(k, 3)[0], B // U, PROB_AUG))
    jmix = JaxMixupConfig(**MIXUP)
    jm, params = params_of("vit_base_patch16_224", 4, **PLAIN)
    inputs("class", jm, params,
           lambda m, tx, lr_fn: make_classification_train_step(m, tx, soft_target_cross_entropy, U, lr_fn,
                                                               mixup_cfg=jmix),
           lambda k: mixup_draws_from_key(jax.random.split(k, 3)[2], jmix, B // U, 32, 32))
    torch.save(ref, out / "ref.pt")
    start()
    for kind, (model, params, make_step) in steps.items():
        tx, lr_fn = jax_make_optimizer(params, JaxOptimConfig(**OPT))
        jstep = jax.jit(make_step(model, tx, lr_fn))
        state = JaxTrainState.create(params, tx)
        metrics = []
        for batch in ref[kind]["batches"]:
            state, m = jstep(state, {k: jnp.asarray(v) for k, v in batch.items()}, key)
            metrics.append({k: float(v) for k, v in m.items()})
        agg = HVU["agg_depth"] if kind == "hvu" else 0
        ref[kind].update(metrics=metrics, final=state_dict_from_jax(jax.tree.map(np.asarray, state.params),
                                                                    "slot" if kind == "hvu" else "plain", agg))
    return ref


# ------------------------------------------------------------------ the port


def _model(kind, sd):
    from devias_tpu_torch.nn import create_model

    if kind == "hvu":
        model = create_model("slot_vit_base_patch16_224", device="cpu", img_size=32, **HVU)
    else:
        model = create_model("vit_base_patch16_224", device="cpu", **PLAIN)
    model.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()})
    return model


def _trajectory(kind, run, rows, mesh):
    """The port's DP step over `run`'s batches, this rank's `rows` of each.
    Returns (metrics per step, final parameters, summed lr)."""
    from devias_tpu_torch.aug import FAMEConfig, MixupConfig
    from devias_tpu_torch.losses import SlotLossConfig, soft_target_cross_entropy
    from devias_tpu_torch.train import (
        OptimConfig,
        TrainState,
        TrainStepConfig,
        make_classification_train_step,
        make_hvu_train_step,
        make_optimizer,
    )

    model = _model(kind, run["init"])
    opt, lr_fn = make_optimizer(model, OptimConfig(**OPT), device="cpu")
    state = TrainState.create(model, opt, device="cpu")
    if kind == "hvu":
        step = make_hvu_train_step(model, opt, SlotLossConfig(5, 4), TrainStepConfig(
            update_freq=U, use_fame=True, fame=FAMEConfig(prob_aug=PROB_AUG)), lr_fn, dp_mesh=mesh, device="cpu")
    else:
        step = make_classification_train_step(model, opt, soft_target_cross_entropy, U, lr_fn,
                                              mixup_cfg=MixupConfig(**MIXUP), dp_mesh=mesh, device="cpu")
    metrics = [step(state, {k: v[rows] for k, v in batch.items()}, generator=torch.Generator().manual_seed(1),
                    draws=draws, host_metrics=True)
               for batch, draws in zip(run["batches"], run["draws"])]
    final = {n: p.detach().clone() for n, p in model.named_parameters()}
    return metrics, final, sum(lr_fn(s) for s in range(STEPS))


def _rank_main(rank: int, out: Path) -> None:
    """One rank of the port's DP runs; writes `rank{rank}.pt`."""
    import torch.distributed as dist

    from devias_tpu_torch.aug import FAMEConfig, MixupConfig, fame_augment_hvu, mixup_cutmix
    from devias_tpu_torch.core.dist import make_mesh, maybe_init_distributed, mix_generators, over_data_group

    assert maybe_init_distributed("cpu") and dist.get_backend() == "gloo"
    ref = torch.load(out / "ref.pt", weights_only=False)
    mesh = make_mesh()
    # rank r holds rows r of each micro-batch's halves
    mb, local = B // U, B // U // WORLD
    rows = np.concatenate([np.arange(u * mb + rank * local, u * mb + (rank + 1) * local) for u in range(U)])
    res = {kind: _trajectory(kind, ref[kind], rows, mesh) for kind in ("hvu", "class")}

    # (c) the mixes from one generator state, no explicit draws
    batch = ref["hvu"]["batches"][0]
    videos, labels = torch.from_numpy(batch["videos"][:mb]), torch.from_numpy(batch["labels"][:mb])
    scene = torch.from_numpy(batch["scene_labels"][:mb])
    mine = slice(rank * local, (rank + 1) * local)
    mix_gen, model_gen = mix_generators(torch.Generator().manual_seed(11), mesh, "cpu")
    fame = FAMEConfig(prob_aug=PROB_AUG)
    res["fame"] = over_data_group(lambda v, a, s: fame_augment_hvu(v, a, s, fame, mix_gen)[:3],
                                  (videos[mine], labels[mine], scene[mine]), mesh)
    mixup = MixupConfig(**MIXUP)
    res["mixup"] = over_data_group(lambda v, lb: mixup_cutmix(v, lb, mixup, mix_gen), (videos[mine], labels[mine]),
                                   mesh)
    res["model_draw"] = torch.rand(8, generator=model_gen)
    # the same ops in one process on the global micro-batch, from the
    # stream every rank drew
    one_gen = mix_generators(torch.Generator().manual_seed(11), mesh, "cpu")[0]
    res["fame_whole"] = fame_augment_hvu(videos, labels, scene, fame, one_gen)[:3]
    res["mixup_whole"] = mixup_cutmix(videos, labels, mixup, one_gen)
    res["rows"] = mine
    torch.save(res, out / f"rank{rank}.pt")
    dist.destroy_process_group()


# ------------------------------------------------------------------ the tests


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    out = tmp_path_factory.mktemp("dp_ops")
    return run_ranks(__file__, out, _jax_side, WORLD, timeout=RANKS_TIMEOUT)


@pytest.mark.parametrize("kind", ["hvu", "class"])
def test_data_parallel_trajectory_matches_jax_whole_batch_and_ranks_agree(run, kind):
    ref, ranks = run
    want = ref[kind]
    for res in ranks:
        metrics, final, lr_sum = res[kind]
        for s, (m, w) in enumerate(zip(metrics, want["metrics"])):
            assert set(m) == set(w)
            for k in w:
                np.testing.assert_allclose(m[k], w[k], rtol=2e-4, atol=1e-6, err_msg=f"{kind} step {s} {k}")
        for name, p in final.items():
            g, w = p.numpy(), want["final"][name]
            tol = 1e-5 + 3e-4 * np.abs(w).max()
            off = np.abs(g - w) > tol
            assert _zero_grad(name) or off.mean() <= 0.02, (name, off.mean())
            assert np.abs(g - w)[off].max(initial=0) <= 2 * lr_sum, name
    assert ranks[1][kind][0] == ranks[0][kind][0]
    for name, p in ranks[1][kind][1].items():
        torch.testing.assert_close(p, ranks[0][kind][1][name], rtol=0, atol=0)


def test_ranks_draw_one_mix_from_one_generator_state(run):
    _, ranks = run
    for res in ranks:
        rows = res["rows"]
        for got, want in zip(res["fame"], res["fame_whole"]):
            torch.testing.assert_close(got, want[rows], rtol=0, atol=0)
        for got, want in zip(res["mixup"], res["mixup_whole"]):
            torch.testing.assert_close(got, want[rows], rtol=0, atol=0)
    assert not torch.equal(ranks[0]["model_draw"], ranks[1]["model_draw"])


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), Path(sys.argv[2]))
