"""The port's training path against the JAX package's, in float32 at a
small size (depth 2, width 64, 4 heads, 8 tied agg rounds, 4x32x32 clips):
the cosine schedules, the per-parameter lr scales and decay flags (through
`param_name_map`), one optimizer step against `FusedAdamW.fused_apply` and
the clipped optax chain, and a three-step trajectory of
`make_slot_train_step` with FAME and gradient accumulation against the
JAX step on the same imported weights, with FAME's draws taken from the
JAX step's own key chain. Also: the entry points raise without CUDA unless
the caller passes `device="cpu"`."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from devias_tpu.aug.fame import FAMEConfig as JaxFAMEConfig
from devias_tpu.core.schedules import cosine_schedule as jax_cosine_schedule
from devias_tpu.losses import SlotLossConfig as JaxSlotLossConfig
from devias_tpu.nn import create_model as jax_create_model
from devias_tpu.train import OptimConfig as JaxOptimConfig
from devias_tpu.train import TrainState as JaxTrainState
from devias_tpu.train import TrainStepConfig as JaxTrainStepConfig
from devias_tpu.train import make_optimizer as jax_make_optimizer
from devias_tpu.train import make_slot_train_step as jax_make_slot_train_step
from devias_tpu.train.optim import build_lr_scale_tree, build_wd_mask_tree
from devias_tpu_torch.aug import FAMEConfig
from devias_tpu_torch.ckpt.from_jax import load_jax_params, param_name_map, state_dict_from_jax
from devias_tpu_torch.core import cosine_schedule
from devias_tpu_torch.losses import SlotLossConfig
from devias_tpu_torch.nn import create_model
from devias_tpu_torch.train import OptimConfig, TrainState, TrainStepConfig, make_optimizer, make_slot_train_step

SMALL = dict(depth=2, embed_dim=64, num_heads=4)
SLOT = dict(num_classes=5, num_scene_classes=4, num_latents=2, agg_depth=8, **SMALL)
TEACHER = dict(num_classes=4, use_mean_pooling=False, **SMALL)
OPT = dict(lr=1e-3, min_lr=1e-5, warmup_lr=1e-4, total_steps=8, warmup_steps=2, layer_decay=0.75,
           agg_block_scale=0.1, weight_decay=0.05, weight_decay_end=0.1, num_layers=2)
# a bias every slot query shares cancels in the slot softmax: its true
# gradient is zero and both frameworks return rounding noise
ZERO_GRAD = ("agg_block.layers.0.0.norm.bias",)


def _flat(tree):
    return {tuple(getattr(k, "key", str(k)) for k in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _jax_params(name, seed, **kw):
    x = jnp.zeros((2, 4, 32, 32, 3), jnp.float32)
    model = jax_create_model(name, fused_attention=True, fused_interpret=True, **kw)
    params = model.init({"params": jax.random.PRNGKey(seed)}, x)["params"]
    rng = np.random.default_rng(seed)
    # a non-zero head, so the slot selection is not a tie
    return model, jax.tree.map(lambda a: np.asarray(a) + 0.05 * rng.normal(size=a.shape).astype(np.float32), params)


def _port(name, kind, params, **kw):
    m = create_model(name, device="cpu", fused_attention=True, **({"img_size": 32} if kind == "slot" else {}), **kw)
    return load_jax_params(m, params, kind)


@pytest.mark.parametrize("warmup", [0, 1, 3])
def test_cosine_schedule_matches(warmup):
    ours = cosine_schedule(1e-3, 1e-5, 10, warmup, 1e-4)
    theirs = jax_cosine_schedule(1e-3, 1e-5, 10, warmup, 1e-4)
    for s in range(14):
        np.testing.assert_allclose(ours(s), float(theirs(s)), rtol=1e-6, err_msg=str(s))


def test_lr_scales_and_decay_flags_match_jax_trees():
    _, params = _jax_params("slot_vit_base_patch16_224", 0, **SLOT)
    model = _port("slot_vit_base_patch16_224", "slot", params, **SLOT)
    opt, _ = make_optimizer(model, OptimConfig(**OPT), device="cpu")
    jcfg = JaxOptimConfig(**OPT)
    scales, masks = _flat(build_lr_scale_tree(params, jcfg)), _flat(build_wd_mask_tree(params))
    paths = param_name_map("slot", 8, opt.names)
    assert sorted(paths.values()) == sorted(scales)
    for name, s, d in zip(opt.names, opt.scales, opt.decay):
        assert s == pytest.approx(scales[paths[name]]), name
        assert d == masks[paths[name]], name
    assert {round(s, 6) for s in opt.scales} == {round(0.75 ** k, 6) for k in (0, 1, 2, 3)} | {0.1}


@pytest.mark.parametrize("clip_grad", [None, 0.5])
def test_optimizer_step_matches(clip_grad):
    """Two steps from the same params and gradients; the JAX side is
    `fused_apply` without clipping and the optax chain with it."""
    _, params = _jax_params("slot_vit_base_patch16_224", 1, **SLOT)
    cfg = dict(OPT, clip_grad=clip_grad)
    tx, _ = jax_make_optimizer(params, JaxOptimConfig(**cfg))
    opt_state = tx.init(params)
    model = _port("slot_vit_base_patch16_224", "slot", params, **SLOT)
    opt, _ = make_optimizer(model, OptimConfig(**cfg), device="cpu")
    paths = param_name_map("slot", 8, opt.names)
    rng = np.random.default_rng(2)
    p_j = params
    for _ in range(2):
        grads = jax.tree.map(lambda a: rng.normal(size=a.shape).astype(np.float32) * 0.01, params)
        flat = _flat(grads)
        if clip_grad is None:
            p_j, opt_state, gsq = tx.fused_apply(p_j, grads, opt_state)
            want_norm = float(np.sqrt(gsq))
        else:
            import optax

            want_norm = float(optax.global_norm(grads))
            upd, opt_state = tx.update(grads, opt_state, p_j)
            p_j = optax.apply_updates(p_j, upd)
        sd_g = state_dict_from_jax(grads, "slot", 8)
        for name, p in model.named_parameters():
            p.grad = torch.from_numpy(np.ascontiguousarray(sd_g[name]))
        assert set(paths.values()) == set(flat)
        norm = opt.step()
        np.testing.assert_allclose(norm.item(), want_norm, rtol=1e-5)
    want = state_dict_from_jax(jax.tree.map(np.asarray, p_j), "slot", 8)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name], rtol=1e-5, atol=1e-7, err_msg=name)


def _fame_draws(rng_key, step, U, mb, prob_aug):
    """The FAME draws of the JAX slot step at `step`: split(fold_in(rng,
    step), U) -> split(., 3)[0] -> split -> permutation, uniform < prob_aug."""
    draws = []
    for k in jax.random.split(jax.random.fold_in(rng_key, step), U):
        perm_key, keep_key = jax.random.split(jax.random.split(k, 3)[0])
        perm = np.asarray(jax.random.permutation(perm_key, mb))
        keep = np.asarray(jax.random.uniform(keep_key, (mb,))) < prob_aug
        draws.append({"perm": torch.from_numpy(perm), "keep": torch.from_numpy(keep)})
    return draws


def test_train_trajectory_matches_jax_step():
    """Three steps, update_freq 2 (two micro-batches of 2), FAME on with
    prob_aug 0.8, layer decay, agg scale, warmup and weight decay. Per-step
    metrics hold to 2e-4 relative (float32 through two blocks, eight agg
    rounds, the loss and FAME in another summation order). The final
    parameters hold to 1e-5 absolute plus 3e-4 of each tensor's largest
    magnitude in at least 98 % of their elements; Adam divides a gradient by
    its own size, so an element whose gradient is at rounding level in
    either framework may move by up to the lr of the steps, the bound for
    the rest. ZERO_GRAD's tensor is all such elements."""
    U, B, prob_aug = 2, 4, 0.8
    jm, params = _jax_params("slot_vit_base_patch16_224", 3, **SLOT)
    jt, tparams = _jax_params("vit_base_patch16_224", 4, **TEACHER)
    cfg = JaxOptimConfig(**OPT)
    tx, lr_fn = jax_make_optimizer(params, cfg)
    state = JaxTrainState.create(params, tx)
    step_cfg = JaxTrainStepConfig(update_freq=U, use_fame=True, fame=JaxFAMEConfig(beta=0.5, prob_aug=prob_aug))
    jstep = jax.jit(jax_make_slot_train_step(jm, jt, tx, JaxSlotLossConfig(5, 4), step_cfg, lr_fn))

    model = _port("slot_vit_base_patch16_224", "slot", params, **SLOT)
    teacher = _port("vit_base_patch16_224", "plain", tparams, **TEACHER)
    opt, t_lr_fn = make_optimizer(model, OptimConfig(**OPT), device="cpu")
    t_state = TrainState.create(model, opt, device="cpu")
    tstep = make_slot_train_step(
        model, teacher, opt, SlotLossConfig(5, 4),
        TrainStepConfig(update_freq=U, use_fame=True, fame=FAMEConfig(beta=0.5, prob_aug=prob_aug)),
        t_lr_fn, device="cpu")

    data = np.random.default_rng(5)
    key = jax.random.PRNGKey(7)
    for s in range(3):
        batch = {"videos": data.normal(size=(B, 4, 32, 32, 3)).astype(np.float32),
                 "labels": data.integers(0, 5, size=B)}
        state, want = jstep(state, tparams, {k: jnp.asarray(v) for k, v in batch.items()}, key)
        got = tstep(t_state, batch, draws=_fame_draws(key, s, U, B // U, prob_aug), host_metrics=True)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k], float(want[k]), rtol=2e-4, atol=1e-6, err_msg=f"step {s} {k}")
    assert t_state.step == 3 and int(state.step) == 3

    final = state_dict_from_jax(jax.tree.map(np.asarray, state.params), "slot", 8)
    lr_sum = sum(t_lr_fn(s) for s in range(3))
    for name, p in model.named_parameters():
        got, want = p.detach().numpy(), final[name]
        tol = 1e-5 + 3e-4 * np.abs(want).max()
        off = np.abs(got - want) > tol
        assert name in ZERO_GRAD or off.mean() <= 0.02, (name, off.mean())
        assert np.abs(got - want)[off].max(initial=0) <= 2 * lr_sum, name


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = create_model("slot_vit_base_patch16_224", device="cpu", img_size=32, **SLOT)
    teacher = create_model("vit_base_patch16_224", device="cpu", **TEACHER)
    for call in (lambda: make_optimizer(model, OptimConfig()),
                 lambda: TrainState.create(model, None),
                 lambda: make_slot_train_step(model, teacher, None, SlotLossConfig(5, 4))):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    opt, _ = make_optimizer(model, OptimConfig(), device="cpu")
    TrainState.create(model, opt, device="cpu")
    make_slot_train_step(model, teacher, opt, SlotLossConfig(5, 4), device="cpu")
    with pytest.raises(ValueError, match="not supported"):
        make_optimizer(model, OptimConfig(opt="lamb"), device="cpu")
    with pytest.raises(ValueError, match="mutually exclusive"):
        make_slot_train_step(model, teacher, opt, SlotLossConfig(5, 4), pp_mesh=object(), sp_mesh=object(),
                             device="cpu")
    with pytest.raises(ValueError, match="exclusive"):
        make_slot_train_step(model, teacher, opt, SlotLossConfig(5, 4), sp_mesh=object(), dp_mesh=object(),
                             device="cpu")
