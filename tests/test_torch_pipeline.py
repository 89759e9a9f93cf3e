"""Pipeline parallelism in the port (`core/pipeline.py`) against the JAX
package's, in float32 at a small size (width 64, 4 heads, 4x32x32 clips,
depth 4), over four gloo ranks:

(a) `pipeline_tokens` against the unsharded backbone at (data, pipe,
    n_micro) = (2, 2, 2) and (1, 4, 4);
(b) the backbone's gradients of a token loss at (1, 4, 4), the stages'
    summed over the pipe group, against `jax.grad` of JAX's
    `pipeline_tokens` on a 4-stage mesh;
(c) the full slot step over two data rows of two stages, two steps,
    against JAX's step on `make_pp_mesh(2)` (loss at rel 2e-4, parameters
    at rel 2e-4 / atol 2e-5, as `tests/test_pp_full_step.py` holds it), the
    ranks bitwise equal; also with LayerScale (`init_values` 0.1: each
    block's gammas go with its stage), where an element that fails the
    tolerance must be one whose step Adam took on a rounding-noise
    gradient, as for ZERO_GRAD: within the two steps' lr, at most
    `NOISE_SHARE` of a tensor;
(d) a stochastic step (drop-path 0.2, dropout 0.1, FAME) that is finite and
    moves the parameters, and stochastic tokens bitwise equal to the same
    blocks run in one process with the draws of `block_seed`, whose
    arguments name no stage;
(e) the validation errors of `tests/test_pipeline_parallel.py:77`.

The JAX side runs in the pytest process on a 4-device slice of the
conftest CPU mesh with the unfused attention; the port side runs in four
gloo processes, this file being their program (`python
tests/test_torch_pipeline.py RANK DIR`).
The ranks start first, on the weights and batches the pytest process
writes to `ref.pt`; the JAX results are computed while they run."""

import inspect
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from _torch_parallel import TEACHER, WORLD, ZERO_GRAD, T, HW, jax_params, port_models, run_ranks  # noqa: E402

SLOT = dict(num_classes=5, num_scene_classes=4, num_latents=2, agg_depth=2, depth=4, embed_dim=64, num_heads=4)
OPT = dict(lr=1e-3, total_steps=20, warmup_steps=0, num_layers=4)
B, STEPS = 8, 2
LR_SUM = STEPS * OPT["lr"]
LAYOUTS = ((2, 2, 2), (1, 4, 4))
# the student's options per full-step trajectory of (c)
FULL_STEP = {"full": {}, "layerscale": dict(init_values=0.1)}
NOISE_SHARE = 1e-4
RANKS_TIMEOUT = 300  # s: over three times the file's slowest test under -n 6, 87.54 s


def _videos():
    return np.random.default_rng(0).normal(size=(B, T, HW, HW, 3)).astype(np.float32)


def _weight():
    return np.random.default_rng(2).normal(size=(1, 1, SLOT["embed_dim"])).astype(np.float32)


def _jax_side(out: Path, start) -> dict:
    """Weights and batches, saved to `out/ref.pt` for the ranks, which
    `start()` then starts; meanwhile (b)'s gradients and (c)'s
    trajectories of the JAX package."""
    import jax
    import jax.numpy as jnp

    from devias_tpu.core.pipeline import make_pp_mesh, pipeline_tokens
    from devias_tpu.losses import SlotLossConfig as JaxSlotLossConfig
    from devias_tpu.nn.vit import VideoViT
    from devias_tpu.train import OptimConfig as JaxOptimConfig
    from devias_tpu.train import TrainState as JaxTrainState
    from devias_tpu.train import TrainStepConfig as JaxTrainStepConfig
    from devias_tpu.train import make_optimizer as jax_make_optimizer
    from devias_tpu.train import make_slot_train_step as jax_make_slot_train_step
    from devias_tpu_torch.ckpt.from_jax import backbone_from_jax, state_dict_from_jax

    jm, params = jax_params("slot_vit_base_patch16_224", 3, **SLOT)
    jt, tparams = jax_params("vit_base_patch16_224", 4, **TEACHER)
    data = np.random.default_rng(5)
    batches = [{"videos": data.normal(size=(B, T, HW, HW, 3)).astype(np.float32) * 0.3,
                "labels": data.integers(0, 5, size=B)} for _ in range(STEPS)]
    ref = {"student": state_dict_from_jax(params, "slot", SLOT["agg_depth"]),
           "teacher": state_dict_from_jax(tparams, "plain"), "batches": batches}
    # the variant without options is the student itself
    students = {variant: jax_params("slot_vit_base_patch16_224", 3, **SLOT, **kw) if kw else (jm, params)
                for variant, kw in FULL_STEP.items()}
    for variant, (_, student) in students.items():
        ref[variant] = {"student": state_dict_from_jax(student, "slot", SLOT["agg_depth"])}
    torch.save(ref, out / "ref.pt")
    start()
    devices = jax.devices()[:WORLD]

    # (b) the backbone's gradients through the 4-stage pipeline
    backbone = VideoViT(**jm.backbone_kwargs())
    w = jnp.asarray(_weight())
    mesh4 = make_pp_mesh(4, devices=devices)
    grads = jax.jit(jax.grad(lambda bp: (pipeline_tokens(backbone, bp, jnp.asarray(_videos()), mesh4, n_micro=4)
                                         * w).mean()))(params["backbone"])
    ref["backbone_grads"] = {}
    backbone_from_jax(ref["backbone_grads"], jax.tree.map(np.asarray, grads))

    # (c) the full step on (2 data, 2 pipe), without and with LayerScale
    mesh2 = make_pp_mesh(2, devices=devices)
    # replicated over the mesh from the start, so the second step reuses the first's compilation
    replicated = jax.sharding.NamedSharding(mesh2, jax.sharding.PartitionSpec())
    tparams = jax.device_put(tparams, replicated)
    for variant, (jm, params) in students.items():
        tx, lr_fn = jax_make_optimizer(params, JaxOptimConfig(**OPT))
        step = jax.jit(jax_make_slot_train_step(jm, jt, tx, JaxSlotLossConfig(5, 4),
                                                JaxTrainStepConfig(use_fame=False, pp_microbatches=2), lr_fn,
                                                pp_mesh=mesh2))
        state = jax.device_put(JaxTrainState.create(params, tx), replicated)
        metrics = []
        for batch in batches:
            with mesh2:
                state, m = step(state, tparams, {k: jnp.asarray(v) for k, v in batch.items()},
                                jax.random.PRNGKey(5))
            metrics.append({k: float(v) for k, v in m.items()})
        ref[variant].update(metrics=metrics, final=state_dict_from_jax(jax.tree.map(np.asarray, state.params), "slot",
                                                                       SLOT["agg_depth"]))
    return ref


# ------------------------------------------------------------------ the port


def _emulate(model, videos, generator, n_micro, row):
    """The stochastic pipeline's tokens in one process: the embed and each
    micro-batch's blocks in turn, with the draws `pipeline_tokens` seeds
    (`block_seed` takes no stage)."""
    from devias_tpu_torch.core.dist import _draw_seeds, _fold
    from devias_tpu_torch.core.pipeline import block_seed

    embed_seed, drop_seed, path_seed = _draw_seeds(generator, 3)
    x = model.embed(videos, torch.Generator().manual_seed(_fold(embed_seed, row)))
    outs = []
    for j, h in enumerate(x.split(x.shape[0] // n_micro)):
        for i, blk in enumerate(model.blocks):
            h = blk(h, torch.Generator().manual_seed(block_seed(drop_seed, row, i, j)),
                    torch.Generator().manual_seed(block_seed(path_seed, row, i, j)))
        outs.append(h)
    return model.norm(torch.cat(outs))


def _rank_main(rank: int, out: Path) -> None:
    import torch.distributed as dist

    from devias_tpu_torch.core.dist import maybe_init_distributed, reduce_stage_grads
    from devias_tpu_torch.core.pipeline import make_pp_mesh, pipeline_tokens
    from devias_tpu_torch.losses import SlotLossConfig
    from devias_tpu_torch.train import OptimConfig, TrainState, TrainStepConfig, make_optimizer, make_slot_train_step

    assert maybe_init_distributed("cpu") and dist.get_backend() == "gloo"
    ref = torch.load(out / "ref.pt", weights_only=False)
    videos = torch.from_numpy(_videos())
    res = {}
    for data, pipe, n_micro in LAYOUTS:
        mesh = make_pp_mesh(pipe)
        model, _ = port_models(ref["student"], ref["teacher"], SLOT)
        b = B // data
        mine = videos[mesh.data_rank * b:(mesh.data_rank + 1) * b]
        tokens = pipeline_tokens(model, mine, mesh, n_micro)
        with torch.no_grad():
            want = model.eval().forward_features(mine)
        res[(data, pipe)] = {"layout": (mesh.data_rank, mesh.data_size, mesh.pipe_rank, mesh.pipe_size),
                             "tokens": tokens.detach(), "unsharded": want}
        if pipe == 4:  # (b) the backbone's gradients
            (tokens * torch.from_numpy(_weight())).mean().backward()
            reduce_stage_grads(model, mesh)
            res["grads"] = {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None}
        # (d) stochastic tokens against the one-process emulation
        sto, _ = port_models(ref["student"], ref["teacher"], dict(SLOT, drop_path_rate=0.2, drop_rate=0.1))
        sto.train()
        got = pipeline_tokens(sto, mine, mesh, n_micro, deterministic=False, generator=torch.Generator().manual_seed(9))
        with torch.no_grad():
            emulated = _emulate(sto, mine, torch.Generator().manual_seed(9), n_micro, mesh.data_rank)
        res[(data, pipe)]["stochastic"] = (got.detach(), emulated)

    # (c) the full step on (2 data, 2 pipe), and (d) a stochastic one
    mesh = make_pp_mesh(2)
    rows = slice(mesh.data_rank * B // 2, (mesh.data_rank + 1) * B // 2)
    full = TrainStepConfig(use_fame=False, pp_microbatches=2)
    for name, kw, cfg in (*((v, kw, full) for v, kw in FULL_STEP.items()),
                          ("stochastic", dict(drop_path_rate=0.2, drop_rate=0.1),
                           TrainStepConfig(use_fame=True, pp_microbatches=2))):
        student = ref[name]["student"] if name in FULL_STEP else ref["student"]
        model, teacher = port_models(student, ref["teacher"], dict(SLOT, **kw))
        opt, lr_fn = make_optimizer(model, OptimConfig(**OPT), device="cpu")
        state = TrainState.create(model, opt, device="cpu")
        step = make_slot_train_step(model, teacher, opt, SlotLossConfig(5, 4), cfg, lr_fn, pp_mesh=mesh, device="cpu")
        batches = ref["batches"] if name in FULL_STEP else ref["batches"][:1]
        metrics = [step(state, {k: v[rows] for k, v in b.items()}, generator=torch.Generator().manual_seed(3),
                        host_metrics=True) for b in batches]
        res[name] = {"metrics": metrics, "final": {n: p.detach().clone() for n, p in model.named_parameters()}}
    torch.save(res, out / f"rank{rank}.pt")
    dist.destroy_process_group()


# ------------------------------------------------------------------ the tests


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    out = tmp_path_factory.mktemp("pp")
    return run_ranks(__file__, out, _jax_side, timeout=RANKS_TIMEOUT)


@pytest.mark.parametrize("data,pipe", [(2, 2), (1, 4)])
def test_pipeline_tokens_match_the_unsharded_backbone(run, data, pipe):
    """(a) every pipe rank holds its row's finished tokens."""
    _, ranks = run
    assert [r[(data, pipe)]["layout"] for r in ranks] == [(r // pipe, data, r % pipe, pipe) for r in range(WORLD)]
    for res in ranks:
        torch.testing.assert_close(res[(data, pipe)]["tokens"], res[(data, pipe)]["unsharded"], rtol=2e-5, atol=2e-5)


def test_backbone_grads_match_jax_pipeline_grads(run):
    """(b) the stages' gradients summed over the pipe group: the patch
    embed's from stage 0, each block's from its stage, the final norm's
    from every rank alike."""
    ref, ranks = run
    want = ref["backbone_grads"]
    for res in ranks:
        assert set(res["grads"]) == set(want)
        for name, g in res["grads"].items():
            np.testing.assert_allclose(g.numpy(), want[name], rtol=5e-5, atol=5e-5, err_msg=name)


@pytest.mark.parametrize("variant", sorted(FULL_STEP))
def test_full_slot_step_matches_jax_and_ranks_agree(run, variant):
    """(c) two steps on (2 data, 2 pipe)."""
    ref, ranks = run
    want = ref[variant]
    for res in ranks:
        if variant == "layerscale":
            assert {f"blocks.{i}.gamma_{j}" for i in range(4) for j in (1, 2)} <= set(res[variant]["final"])
        for m, w in zip(res[variant]["metrics"], want["metrics"]):
            assert m["loss"] == pytest.approx(w["loss"], rel=2e-4)
        for name, p in res[variant]["final"].items():
            got, ref_p = p.numpy(), want["final"][name]
            if name in ZERO_GRAD:  # Adam's step on rounding noise: within the two steps' lr
                assert np.abs(got - ref_p).max() <= 2 * LR_SUM, name
            elif variant == "full":
                np.testing.assert_allclose(got, ref_p, rtol=2e-4, atol=2e-5, err_msg=name)
            else:
                off = np.abs(got - ref_p) > 2e-5 + 2e-4 * np.abs(ref_p)
                assert off.mean() <= NOISE_SHARE and np.abs(got - ref_p)[off].max(initial=0.0) <= 2 * LR_SUM, name
    for res in ranks[1:]:
        for name, p in res[variant]["final"].items():
            assert torch.equal(p, ranks[0][variant]["final"][name]), name


def test_stochastic_step_is_finite_and_moves_the_parameters(run):
    """(d) drop-path 0.2, dropout 0.1 and FAME under the pipe."""
    ref, ranks = run
    for res in ranks:
        m = res["stochastic"]["metrics"][0]
        assert np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"])
        moved = max((p - torch.from_numpy(ref["student"][n])).abs().max().item()
                    for n, p in res["stochastic"]["final"].items())
        assert moved > 0.0


@pytest.mark.parametrize("data,pipe", [(2, 2), (1, 4)])
def test_draws_do_not_depend_on_the_stage(run, data, pipe):
    """(d) the stochastic pipeline equals its blocks run in one process with
    `block_seed`'s draws, bitwise, whatever the stage count; the seed's
    arguments are the data row, the global block and the micro-batch."""
    from devias_tpu_torch.core.pipeline import block_seed

    assert list(inspect.signature(block_seed).parameters) == ["seed", "data_row", "block", "micro"]
    _, ranks = run
    for res in ranks:
        got, emulated = res[(data, pipe)]["stochastic"]
        assert torch.equal(got, emulated)
        assert not torch.equal(got, res[(data, pipe)]["unsharded"])


def test_validation_errors():
    """(e) depth not divisible by the stages, a stochastic run without a
    generator, a CLS token."""
    from devias_tpu_torch.core.dist import SPMesh
    from devias_tpu_torch.core.pipeline import pipeline_tokens
    from devias_tpu_torch.nn import create_model

    mesh = SPMesh(seq_group=None, seq_rank=0, seq_size=1, pipe_size=4)
    videos = torch.from_numpy(_videos())
    six = create_model("slot_vit_base_patch16_224", device="cpu", img_size=HW, **dict(SLOT, depth=6))
    with pytest.raises(ValueError, match="not divisible by pipe"):
        pipeline_tokens(six, videos, mesh, n_micro=4)
    four = create_model("slot_vit_base_patch16_224", device="cpu", img_size=HW, **SLOT)
    with pytest.raises(ValueError, match="requires a generator"):
        pipeline_tokens(four, videos, mesh, n_micro=4, deterministic=False)
    with pytest.raises(ValueError, match="not divisible by n_micro"):
        pipeline_tokens(four, videos, mesh, n_micro=3)
    cls = create_model("vit_base_patch16_224", device="cpu", **dict(TEACHER, depth=4))
    with pytest.raises(NotImplementedError, match="cls/suffix"):
        pipeline_tokens(cls, videos, mesh, n_micro=4)


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), Path(sys.argv[2]))
