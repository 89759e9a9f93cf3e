"""Sequence-parallel slot training in the port against the JAX package's,
mirroring `tests/test_seq_parallel.py` and `tests/test_sp_full_step.py`,
in float32 at a small size (depth 2, width 64, 4 heads, 16x32x32 clips).

The JAX side runs `seq_parallel_tokens`, gradients through it and the SP
train step on a 4-device slice of the conftest CPU mesh, with K2 in
interpret mode. The port side runs in four processes joined by gloo (this
file is their program, `python tests/test_torch_seq_parallel.py RANK DIR`,
and imports no JAX at module level), on weights imported through
`ckpt/from_jax.py`; each rank writes what it saw and the tests compare.
The whole file runs in well under a minute."""

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

SEQ = 4
SMALL = dict(depth=2, embed_dim=64, num_heads=4)
SLOT = dict(num_classes=5, num_scene_classes=4, num_latents=2, agg_depth=2, **SMALL)
TEACHER = dict(num_classes=4, use_mean_pooling=False, **SMALL)
OPT = dict(lr=1e-3, min_lr=1e-5, warmup_lr=1e-4, total_steps=8, warmup_steps=1, layer_decay=0.75,
           agg_block_scale=0.1, weight_decay=0.05, weight_decay_end=0.1, num_layers=2)
B, T, HW = 4, 16, 32
PROB_AUG = 0.8
STEPS = 2
ROOT = Path(__file__).resolve().parents[1]
# a bias every slot query shares cancels in the slot softmax: its true
# gradient is zero and both frameworks return rounding noise
ZERO_GRAD = ("agg_block.layers.0.0.norm.bias",)


# ------------------------------------------------------------------ the JAX side


def _jax_side(out: Path) -> dict:
    """Weights, inputs and the JAX package's SP results, saved for the ranks."""
    import jax
    import jax.numpy as jnp

    from devias_tpu.aug.fame import FAMEConfig as JaxFAMEConfig
    from devias_tpu.core.dist import SEQ_AXIS, make_sp_mesh
    from devias_tpu.core.dist import seq_parallel_tokens as jax_seq_parallel_tokens
    from devias_tpu.losses import SlotLossConfig as JaxSlotLossConfig
    from devias_tpu.nn import create_model as jax_create_model
    from devias_tpu.nn.vit import VideoViT as JaxVideoViT
    from devias_tpu.train import OptimConfig as JaxOptimConfig
    from devias_tpu.train import TrainState as JaxTrainState
    from devias_tpu.train import TrainStepConfig as JaxTrainStepConfig
    from devias_tpu.train import make_optimizer as jax_make_optimizer
    from devias_tpu.train import make_slot_train_step as jax_make_slot_train_step
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
    mesh = make_sp_mesh(SEQ, devices=jax.devices()[:SEQ])
    sp_backbone = JaxVideoViT(**jm.backbone_kwargs(), seq_axis=SEQ_AXIS, seq_shards=SEQ)
    data = np.random.default_rng(5)
    videos = data.normal(size=(B, T, HW, HW, 3)).astype(np.float32)

    tokens = np.asarray(jax.jit(lambda p, v: jax_seq_parallel_tokens(sp_backbone, p, v, mesh))(
        params["backbone"], jnp.asarray(videos)))

    def slots_loss(p):
        tok = jax_seq_parallel_tokens(sp_backbone, p["backbone"], jnp.asarray(videos), mesh)
        slots = jm.apply({"params": p}, jnp.asarray(videos), tokens=tok)["slots"]
        return (slots.astype(jnp.float32) ** 2).sum()

    grads = jax.jit(jax.grad(slots_loss))(params)

    cfg = JaxOptimConfig(**OPT)
    tx, _ = jax_make_optimizer(params, cfg)
    # replicated over the mesh from the start, so the second step reuses the first's compilation
    replicated = jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec())
    state = jax.device_put(JaxTrainState.create(params, tx), replicated)
    tparams = jax.device_put(tparams, replicated)
    step_cfg = JaxTrainStepConfig(use_fame=True, fame=JaxFAMEConfig(beta=0.5, prob_aug=PROB_AUG))
    jstep = jax.jit(jax_make_slot_train_step(jm, jt, tx, JaxSlotLossConfig(5, 4), step_cfg, sp_mesh=mesh))
    key = jax.random.PRNGKey(7)
    batches, metrics, draws = [], [], []
    for s in range(STEPS):
        batch = {"videos": data.normal(size=(B, T, HW, HW, 3)).astype(np.float32),
                 "labels": data.integers(0, 5, size=B)}
        with mesh:
            state, m = jstep(state, tparams, {k: jnp.asarray(v) for k, v in batch.items()}, key)
        batches.append(batch)
        metrics.append({k: float(v) for k, v in m.items()})
        # FAME's draws in the JAX step: split(fold_in(key, step), 1)[0] -> split(., 3)[0] -> split
        perm_key, keep_key = jax.random.split(jax.random.split(jax.random.split(jax.random.fold_in(key, s), 1)[0], 3)[0])
        draws.append({"perm": np.asarray(jax.random.permutation(perm_key, B)),
                      "keep": np.asarray(jax.random.uniform(keep_key, (B,))) < PROB_AUG})

    ref = {
        "student": state_dict_from_jax(params, "slot", SLOT["agg_depth"]),
        "teacher": state_dict_from_jax(tparams, "plain"),
        "videos": videos, "tokens": tokens,
        "grads": state_dict_from_jax(jax.tree.map(np.asarray, grads), "slot", SLOT["agg_depth"]),
        "batches": batches, "metrics": metrics, "draws": draws,
        "final": state_dict_from_jax(jax.tree.map(np.asarray, state.params), "slot", SLOT["agg_depth"]),
    }
    torch.save(ref, out / "ref.pt")
    return ref


# ------------------------------------------------------------------ the port's ranks


def _rank_main(rank: int, out: Path) -> None:
    """One rank of the port's SP run; writes `rank{rank}.pt`."""
    import torch.distributed as dist

    from devias_tpu_torch.aug import FAMEConfig
    from devias_tpu_torch.core.dist import (
        make_sp_mesh,
        maybe_init_distributed,
        reduce_backbone_grads,
        seq_parallel_tokens,
        sp_generators,
    )
    from devias_tpu_torch.losses import SlotLossConfig
    from devias_tpu_torch.nn import create_model
    from devias_tpu_torch.train import OptimConfig, TrainState, TrainStepConfig, make_optimizer, make_slot_train_step
    from devias_tpu_torch.train.step import mix_clips

    torch.set_num_threads(1)
    initialised = maybe_init_distributed("cpu")
    assert initialised and dist.get_backend() == "gloo"
    ref = torch.load(out / "ref.pt", weights_only=False)
    mesh = make_sp_mesh(SEQ)
    res = {}

    def student(**kw):
        m = create_model("slot_vit_base_patch16_224", device="cpu", img_size=HW, fused_attention=True,
                         **{**SLOT, **kw})
        m.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in ref["student"].items()})
        return m

    videos = torch.from_numpy(ref["videos"])
    model = student()
    res["tokens"] = seq_parallel_tokens(model, videos, mesh).detach()
    model.eval()
    with torch.no_grad():
        res["tokens_unsharded"] = model.forward_features(videos)

    # gradients of a sum-of-squares loss on the slots, through the gathers
    model.train()
    slots = model(videos, tokens=seq_parallel_tokens(model, videos, mesh))["slots"]
    (slots.float() ** 2).sum().backward()
    reduce_backbone_grads(model, mesh)
    res["grads"] = {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None}

    # drop-path decisions agree across the token shards of a sample
    dp = student(drop_path_rate=0.7).train()
    tok = seq_parallel_tokens(dp, videos, mesh, deterministic=False, generator=torch.Generator().manual_seed(5))
    _, path_gen = sp_generators(torch.Generator().manual_seed(5), mesh, "cpu")
    with torch.no_grad():
        res["drop_path_tokens"] = tok.detach()
        res["drop_path_unsharded"] = dp.forward_features(videos, path_generator=path_gen)
    # token dropout draws differ between shards, drop-path draws do not
    token_gen, path_gen = sp_generators(torch.Generator().manual_seed(9), mesh, "cpu")
    draws = torch.stack([torch.rand(64, generator=token_gen), torch.rand(64, generator=path_gen)])[None]
    gathered = [torch.empty_like(draws) for _ in range(SEQ)]
    dist.all_gather(gathered, draws)
    res["stream_draws"] = torch.cat(gathered)
    res["dropout_tokens"] = seq_parallel_tokens(student(drop_rate=0.5).train(), videos, mesh, deterministic=False,
                                                generator=torch.Generator().manual_seed(1)).detach()

    # FAME once per seq group: each rank's own generator differs, the result must not
    step_cfg = TrainStepConfig(use_fame=True, fame=FAMEConfig(beta=0.5, prob_aug=PROB_AUG))
    mixed = mix_clips(videos, torch.arange(B), step_cfg, torch.Generator().manual_seed(100 + rank), None, mesh)
    res["fame"] = [t.clone() for t in mixed]

    # a two-step trajectory of the SP step with the JAX step's FAME draws
    model = student()
    teacher = create_model("vit_base_patch16_224", device="cpu", fused_attention=True, **TEACHER)
    teacher.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in ref["teacher"].items()})
    opt, lr_fn = make_optimizer(model, OptimConfig(**OPT), device="cpu")
    state = TrainState.create(model, opt, device="cpu")
    step = make_slot_train_step(model, teacher, opt, SlotLossConfig(5, 4), step_cfg, sp_mesh=mesh, device="cpu")
    res["metrics"] = []
    for batch, d in zip(ref["batches"], ref["draws"]):
        draws = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in d.items()}
        res["metrics"].append(step(state, batch, draws=draws, host_metrics=True))
    res["final"] = {n: p.detach().clone() for n, p in model.named_parameters()}
    res["lr_sum"] = sum(lr_fn(s) for s in range(STEPS))

    # the rejections
    def raises(exc, fn):
        try:
            fn()
        except exc:
            return True
        return False

    plain = create_model("vit_base_patch16_224", device="cpu", **TEACHER)  # CLS token
    res["rejects"] = {
        "cls_token": raises(NotImplementedError, lambda: seq_parallel_tokens(plain, videos, mesh)),
        "frames": raises(ValueError, lambda: seq_parallel_tokens(model, videos[:, :12], mesh)),
        "data_axis": raises(NotImplementedError, lambda: make_sp_mesh(2)),
        "not_divisible": raises(ValueError, lambda: make_sp_mesh(3)),
        "no_generator": raises(ValueError, lambda: seq_parallel_tokens(model, videos, mesh, deterministic=False)),
    }
    torch.save(res, out / f"rank{rank}.pt")
    dist.destroy_process_group()


# ------------------------------------------------------------------ the tests


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    out = tmp_path_factory.mktemp("sp")
    ref = _jax_side(out)
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1",
               DEVIAS_TPU_COORDINATOR=f"127.0.0.1:{_free_port()}", DEVIAS_TPU_NUM_PROCS=str(SEQ))
    procs = [subprocess.Popen([sys.executable, __file__, str(r), str(out)], cwd=ROOT,
                              env=dict(env, DEVIAS_TPU_PROC_ID=str(r)), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(SEQ)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)[-4000:]
    return ref, [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(SEQ)]


def test_tokens_match_jax_sp_and_unsharded(run):
    ref, ranks = run
    for res in ranks:
        np.testing.assert_allclose(res["tokens"].numpy(), ref["tokens"], rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(res["tokens"].numpy(), res["tokens_unsharded"].numpy(), rtol=2e-5, atol=2e-5)


def test_backbone_and_agg_grads_match_jax(run):
    """Each gradient within 1e-4 of its largest magnitude, on every rank;
    the head and mask decoder take no gradient from the slots' loss."""
    ref, ranks = run
    names = [n for n in ranks[0]["grads"] if n.split(".")[0] in ("patch_embed", "blocks", "norm", "agg_block")
             and n not in ZERO_GRAD]
    assert any(n.startswith("blocks.") for n in names) and any(n.startswith("agg_block.") for n in names)
    for res in ranks:
        for n in names:
            want = ref["grads"][n]
            tol = 1e-4 * np.abs(want).max()
            np.testing.assert_allclose(res["grads"][n].numpy(), want, rtol=0, atol=tol, err_msg=n)


def test_train_trajectory_matches_jax_sp_step(run):
    """Two SP steps with FAME (prob_aug 0.8) and dropout 0. Metrics to 2e-4
    relative; final parameters as in `test_torch_train.py`'s trajectory
    (1e-5 plus 3e-4 of each tensor's largest magnitude in 98 % of the
    elements, the rest within twice the summed lr; ZERO_GRAD's tensor is
    all such elements). The ranks end on the same parameters."""
    ref, ranks = run
    for res in ranks:
        for s, (got, want) in enumerate(zip(res["metrics"], ref["metrics"])):
            assert set(got) == set(want)
            for k in want:
                np.testing.assert_allclose(got[k], want[k], rtol=2e-4, atol=1e-6, err_msg=f"step {s} {k}")
        for name, p in res["final"].items():
            got, want = p.numpy(), ref["final"][name]
            tol = 1e-5 + 3e-4 * np.abs(want).max()
            off = np.abs(got - want) > tol
            assert name in ZERO_GRAD or off.mean() <= 0.02, (name, off.mean())
            assert np.abs(got - want)[off].max(initial=0) <= 2 * res["lr_sum"], name
    for res in ranks[1:]:
        for name, p in res["final"].items():
            torch.testing.assert_close(p, ranks[0]["final"][name], rtol=0, atol=0)


def test_drop_path_agrees_across_token_shards_and_token_dropout_does_not(run):
    _, ranks = run
    for res in ranks:
        np.testing.assert_allclose(res["drop_path_tokens"].numpy(), res["drop_path_unsharded"].numpy(),
                                   rtol=2e-5, atol=2e-5)
        assert not torch.allclose(res["drop_path_tokens"], ranks[0]["tokens"], atol=1e-3)
        assert torch.isfinite(res["dropout_tokens"]).all()
    draws = ranks[0]["stream_draws"]  # [rank, (token, path), 64]
    for r in range(1, SEQ):
        assert not torch.allclose(draws[r, 0], draws[0, 0])
        torch.testing.assert_close(draws[r, 1], draws[0, 1], rtol=0, atol=0)


def test_seq_group_holds_one_fame_output(run):
    _, ranks = run
    assert ranks[0]["fame"][0].shape == (B, T, HW, HW, 3)
    for res in ranks[1:]:
        for got, want in zip(res["fame"], ranks[0]["fame"]):
            torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_rejections(run):
    _, ranks = run
    for res in ranks:
        assert res["rejects"] == {k: True for k in res["rejects"]}, res["rejects"]


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), Path(sys.argv[2]))
