"""Data-parallel slot training in the port against the JAX package's, in
float32 at a small size (depth 2, width 64, 4 heads, 16x32x32 clips):

(a) the port's one-process step with `num_data_shards=4` (FAME on four
    blocks of each micro-batch) against the JAX step with the same;
(b) pure data parallelism over four ranks (`make_mesh()`, each rank its
    own local batch) against the JAX step on a 4-device data mesh with
    `num_data_shards=4`: a two-step trajectory with FAME and update_freq 2,
    metrics, final parameters, and parameters equal on every rank;
(c) two data rows of two seq ranks (`make_sp_mesh(2)` over four ranks)
    against the JAX step on `make_sp_mesh(2)` with `num_data_shards=2`;
(d) FAME's streams differ across the data rows and agree within a seq
    group.

The JAX side runs in the pytest process on a 4-device slice of the
conftest CPU mesh, with K1 and K2 in interpret mode; its FAME draws are
rebuilt from its key chain. The port side runs in four processes joined
by gloo (this file is their program, `python tests/test_torch_data_parallel.py
RANK DIR`, and imports no JAX at module level). The JAX step splits each
micro-batch of the global batch into contiguous FAME shards; a rank of the
port's run holds its own shard of every micro-batch, so rank r's local
batch is shard r of each micro-batch in turn.
The ranks start first, on the weights and batches the pytest process
writes to `ref.pt`; the JAX results are computed while they run."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from _torch_parallel import run_ranks  # noqa: E402

WORLD = 4
SMALL = dict(depth=2, embed_dim=64, num_heads=4)
SLOT = dict(num_classes=5, num_scene_classes=4, num_latents=2, agg_depth=2, **SMALL)
TEACHER = dict(num_classes=4, use_mean_pooling=False, **SMALL)
OPT = dict(lr=1e-3, min_lr=1e-5, warmup_lr=1e-4, total_steps=8, warmup_steps=1, layer_decay=0.75,
           agg_block_scale=0.1, weight_decay=0.05, weight_decay_end=0.1, num_layers=2)
T, HW = 16, 32
PROB_AUG = 0.8
# (b): global batch 16 = update_freq 2 x micro-batch 8 = 4 shards of 2
DP_U, DP_B, DP_STEPS = 2, 16, 2
# (c): global batch 4 = 2 data rows of 2 clips, each row over 2 seq ranks
SP_SEQ, SP_B, SP_STEPS = 2, 4, 1
RANKS_TIMEOUT = 210  # s: over three times the file's slowest test under -n 6, 59.43 s
# a bias every slot query shares cancels in the slot softmax: its true
# gradient is zero and both frameworks return rounding noise
ZERO_GRAD = ("agg_block.layers.0.0.norm.bias",)


# ------------------------------------------------------------------ the JAX side


def _fame_draws(jax, key, step, U, mb, n_shards):
    """The JAX slot step's FAME draws at `step`, [micro-batch][shard]:
    split(fold_in(key, step), U)[u] -> split(., 3)[0] -> split(., n_shards)[k]
    -> split -> permutation, uniform < prob_aug (`_shard_local_fame`)."""
    local = mb // n_shards
    out = []
    for k in jax.random.split(jax.random.fold_in(key, step), U):
        shards = []
        for sk in jax.random.split(jax.random.split(k, 3)[0], n_shards):
            perm_key, keep_key = jax.random.split(sk)
            shards.append({"perm": np.asarray(jax.random.permutation(perm_key, local)),
                           "keep": np.asarray(jax.random.uniform(keep_key, (local,))) < PROB_AUG})
        out.append(shards)
    return out


def _jax_side(out: Path, start) -> dict:
    """Weights, batches and draws, saved to `out/ref.pt` for the ranks,
    which `start()` then starts; meanwhile the JAX package's DP and DPxSP
    results."""
    import jax
    import jax.numpy as jnp

    from devias_tpu.aug.fame import FAMEConfig as JaxFAMEConfig
    from devias_tpu.core.dist import make_mesh, make_sp_mesh
    from devias_tpu.losses import SlotLossConfig as JaxSlotLossConfig
    from devias_tpu.nn import create_model as jax_create_model
    from devias_tpu.train import OptimConfig as JaxOptimConfig
    from devias_tpu.train import TrainState as JaxTrainState
    from devias_tpu.train import TrainStepConfig as JaxTrainStepConfig
    from devias_tpu.train import make_optimizer as jax_make_optimizer
    from devias_tpu.train import make_slot_train_step as jax_make_slot_train_step
    from devias_tpu.train import place_data_parallel
    from devias_tpu_torch.ckpt.from_jax import state_dict_from_jax

    def params_of(name, seed, **kw):
        # the unfused twin initialises the same parameters without the
        # interpreted kernels
        p = jax.jit(jax_create_model(name, **kw).init)({"params": jax.random.PRNGKey(seed)},
                                                       jnp.zeros((2, T, HW, HW, 3)))
        model = jax_create_model(name, fused_attention=True, fused_interpret=True, **kw)
        rng = np.random.default_rng(seed)
        # a non-zero head, so the slot selection is not a tie
        return model, jax.tree.map(lambda a: np.asarray(a) + 0.05 * rng.normal(size=a.shape).astype(np.float32),
                                   p["params"])

    jm, params = params_of("slot_vit_base_patch16_224", 3, **SLOT)
    jt, tparams = params_of("vit_base_patch16_224", 4, **TEACHER)
    data = np.random.default_rng(5)
    key = jax.random.PRNGKey(7)

    def inputs(U, B, steps, n_shards):
        batches = [{"videos": data.normal(size=(B, T, HW, HW, 3)).astype(np.float32),
                    "labels": data.integers(0, 5, size=B)} for _ in range(steps)]
        return {"batches": batches, "draws": [_fame_draws(jax, key, s, U, B // U, n_shards) for s in range(steps)]}

    ref = {"student": state_dict_from_jax(params, "slot", SLOT["agg_depth"]),
           "teacher": state_dict_from_jax(tparams, "plain"),
           "dp": inputs(DP_U, DP_B, DP_STEPS, WORLD), "sp": inputs(1, SP_B, SP_STEPS, WORLD // SP_SEQ)}
    torch.save(ref, out / "ref.pt")
    start()
    tx, _ = jax_make_optimizer(params, JaxOptimConfig(**OPT))
    fame = JaxFAMEConfig(beta=0.5, prob_aug=PROB_AUG)

    def trajectory(run, mesh, step_cfg, **step_kw):
        jstep = jax.jit(jax_make_slot_train_step(jm, jt, tx, JaxSlotLossConfig(5, 4), step_cfg, **step_kw))
        repl = jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec())
        state = jax.device_put(JaxTrainState.create(params, tx), repl)
        teacher = jax.device_put(tparams, repl)
        run["metrics"] = []
        for batch in run["batches"]:
            state, placed = place_data_parallel(mesh, state, {k: jnp.asarray(v) for k, v in batch.items()})
            with mesh:
                state, m = jstep(state, teacher, placed, key)
            run["metrics"].append({k: float(v) for k, v in m.items()})
        run["final"] = state_dict_from_jax(jax.tree.map(np.asarray, state.params), "slot", SLOT["agg_depth"])

    trajectory(ref["dp"], make_mesh(devices=jax.devices()[:WORLD]),
               JaxTrainStepConfig(update_freq=DP_U, use_fame=True, fame=fame, num_data_shards=WORLD))
    sp_mesh = make_sp_mesh(SP_SEQ, devices=jax.devices()[:WORLD])
    trajectory(ref["sp"], sp_mesh, JaxTrainStepConfig(use_fame=True, fame=fame, num_data_shards=WORLD // SP_SEQ),
               sp_mesh=sp_mesh)
    return ref


# ------------------------------------------------------------------ the port


def _port_models(ref):
    from devias_tpu_torch.nn import create_model

    model = create_model("slot_vit_base_patch16_224", device="cpu", img_size=HW, fused_attention=True, **SLOT)
    model.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in ref["student"].items()})
    teacher = create_model("vit_base_patch16_224", device="cpu", fused_attention=True, **TEACHER)
    teacher.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in ref["teacher"].items()})
    return model, teacher


def _tensors(d):
    return {k: torch.from_numpy(np.array(v)) for k, v in d.items()}


def _trajectory(ref, run, U, n_shards, rows, shard_draws, **step_kw):
    """The port's step over `run`'s batches: each step's batch is
    `rows(batch)` (this rank's clips) and its draws `shard_draws(draws)`.
    Returns (metrics per step, final parameters, summed lr)."""
    from devias_tpu_torch.aug import FAMEConfig
    from devias_tpu_torch.losses import SlotLossConfig
    from devias_tpu_torch.train import OptimConfig, TrainState, TrainStepConfig, make_optimizer, make_slot_train_step

    model, teacher = _port_models(ref)
    opt, lr_fn = make_optimizer(model, OptimConfig(**OPT), device="cpu")
    state = TrainState.create(model, opt, device="cpu")
    step_cfg = TrainStepConfig(update_freq=U, use_fame=True, fame=FAMEConfig(beta=0.5, prob_aug=PROB_AUG),
                               num_data_shards=n_shards)
    step = make_slot_train_step(model, teacher, opt, SlotLossConfig(5, 4), step_cfg, device="cpu", **step_kw)
    metrics = [step(state, {k: v[rows] for k, v in batch.items()}, draws=shard_draws(draws), host_metrics=True)
               for batch, draws in zip(run["batches"], run["draws"])]
    final = {n: p.detach().clone() for n, p in model.named_parameters()}
    return metrics, final, sum(lr_fn(s) for s in range(len(run["batches"])))


def _rank_main(rank: int, out: Path) -> None:
    """One rank of the port's DP and DPxSP runs; writes `rank{rank}.pt`."""
    import torch.distributed as dist

    from devias_tpu_torch.aug import FAMEConfig
    from devias_tpu_torch.core.dist import make_mesh, make_sp_mesh, maybe_init_distributed, rank_generators
    from devias_tpu_torch.train import TrainStepConfig
    from devias_tpu_torch.train.step import mix_clips

    assert maybe_init_distributed("cpu") and dist.get_backend() == "gloo"
    ref = torch.load(out / "ref.pt", weights_only=False)
    res = {}

    # (b) pure DP: rank r holds shard r of each micro-batch of the global batch
    dp = make_mesh()
    mb, local = DP_B // DP_U, DP_B // DP_U // WORLD
    rows = np.concatenate([np.arange(u * mb + rank * local, u * mb + (rank + 1) * local) for u in range(DP_U)])
    res["dp"] = _trajectory(ref, ref["dp"], DP_U, 1, rows,
                            lambda d: [_tensors(d[u][rank]) for u in range(DP_U)], dp_mesh=dp)
    res["dp_layout"] = (dp.data_rank, dp.data_size, dp.seq_rank, dp.seq_size)

    # (c) two data rows of two seq ranks: row d holds FAME shard d
    mesh = make_sp_mesh(SP_SEQ)
    row = mesh.data_rank
    local = SP_B // mesh.data_size
    res["sp"] = _trajectory(ref, ref["sp"], 1, 1, np.arange(row * local, (row + 1) * local),
                            lambda d: _tensors(d[0][row]), sp_mesh=mesh)
    res["sp_layout"] = (mesh.data_rank, mesh.data_size, mesh.seq_rank, mesh.seq_size, mesh.seq_root)

    # (d) FAME's streams: one generator state everywhere, folded per data row
    videos = torch.from_numpy(ref["sp"]["batches"][0]["videos"])
    fame_gen, _, head_gen = rank_generators(torch.Generator().manual_seed(11), mesh, "cpu")
    step_cfg = TrainStepConfig(use_fame=True, fame=FAMEConfig(beta=0.5, prob_aug=1.0))
    res["fame"] = mix_clips(videos, torch.arange(SP_B), step_cfg, fame_gen, None, mesh)[0]
    res["head_draw"] = torch.rand(16, generator=head_gen)
    torch.save(res, out / f"rank{rank}.pt")
    dist.destroy_process_group()


# ------------------------------------------------------------------ the tests


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    out = tmp_path_factory.mktemp("dp")
    return run_ranks(__file__, out, _jax_side, timeout=RANKS_TIMEOUT)


def _check_trajectory(got, want):
    """Metrics to 2e-4 relative; final parameters within 1e-5 plus 3e-4 of
    each tensor's largest magnitude in 98 % of the elements, the rest within
    twice the summed lr (ZERO_GRAD's tensor is all such elements), as
    `tests/test_torch_seq_parallel.py` holds the SP trajectory."""
    metrics, final, lr_sum = got
    assert len(metrics) == len(want["metrics"])
    for s, (m, w) in enumerate(zip(metrics, want["metrics"])):
        assert set(m) == set(w)
        for k in w:
            np.testing.assert_allclose(m[k], w[k], rtol=2e-4, atol=1e-6, err_msg=f"step {s} {k}")
    for name, p in final.items():
        g, w = p.numpy(), want["final"][name]
        tol = 1e-5 + 3e-4 * np.abs(w).max()
        off = np.abs(g - w) > tol
        assert name in ZERO_GRAD or off.mean() <= 0.02, (name, off.mean())
        assert np.abs(g - w)[off].max(initial=0) <= 2 * lr_sum, name


def test_one_process_shard_local_fame_matches_jax(run):
    """(a) the whole global batch in one process, FAME on four blocks of
    each micro-batch with the JAX step's per-shard draws."""
    ref, _ = run
    dp = ref["dp"]
    got = _trajectory(ref, dp, DP_U, WORLD, slice(None),
                      lambda d: [[_tensors(s) for s in shards] for shards in d])
    _check_trajectory(got, dp)


def test_data_parallel_trajectory_matches_jax_and_ranks_agree(run):
    """(b) four ranks, each a quarter of every micro-batch."""
    ref, ranks = run
    assert [r["dp_layout"] for r in ranks] == [(r, WORLD, 0, 1) for r in range(WORLD)]
    for res in ranks:
        _check_trajectory(res["dp"], ref["dp"])
    for res in ranks[1:]:
        assert res["dp"][0] == ranks[0]["dp"][0]
        for name, p in res["dp"][1].items():
            torch.testing.assert_close(p, ranks[0]["dp"][1][name], rtol=0, atol=0)


def test_data_and_seq_parallel_trajectory_matches_jax(run):
    """(c) two data rows of two seq ranks: rank r is seq rank r mod 2 of
    row r // 2, and every rank ends on the same parameters."""
    ref, ranks = run
    assert [r["sp_layout"] for r in ranks] == [(r // 2, 2, r % 2, 2, 2 * (r // 2)) for r in range(WORLD)]
    for res in ranks:
        _check_trajectory(res["sp"], ref["sp"])
    for res in ranks[1:]:
        for name, p in res["sp"][1].items():
            torch.testing.assert_close(p, ranks[0]["sp"][1][name], rtol=0, atol=0)


def test_fame_streams_differ_across_rows_and_agree_within_a_seq_group(run):
    """(d) every rank mixes the same clips from one generator state: the two
    seq ranks of a row hold one mix (and one head-dropout stream), the two
    rows mix differently."""
    _, ranks = run
    for a, b in ((0, 1), (2, 3)):
        torch.testing.assert_close(ranks[a]["fame"], ranks[b]["fame"], rtol=0, atol=0)
        torch.testing.assert_close(ranks[a]["head_draw"], ranks[b]["head_draw"], rtol=0, atol=0)
    assert not torch.equal(ranks[0]["fame"], ranks[2]["fame"])
    assert not torch.equal(ranks[0]["head_draw"], ranks[2]["head_draw"])


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), Path(sys.argv[2]))
