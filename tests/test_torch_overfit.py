"""The port's counterpart of `tests/test_overfit.py:50-74`: the whole slot
training loop (`make_slot_train_step`, FAME off so the target is fixed)
must memorise a tiny fixed synthetic set. The sizes, the learning rate and
the assertions are the JAX test's: depth 2, width 64, 4 heads, 8 clips of
4x32x32, a flat lr of 3e-3; `hard_select` memorises the batch in 100 steps
(accuracy 1.0, action loss below 0.2), `matching` cuts the loss below 0.2
of its first value in 60 steps with scene and cosine losses below 1.0.
Both models start from the JAX test's initial weights, crossed through
`load_jax_params`.

The JAX file's third test, `test_remat_matches_no_remat`, has its port
counterpart in `tests/test_torch_model_options.py`
(`test_remat_grads_match_jax_remat` and the two draw tests after it)."""

import jax
import jax.numpy as jnp
import numpy as np

from devias_tpu.nn import create_model as jax_create_model
from devias_tpu_torch.ckpt.from_jax import load_jax_params
from devias_tpu_torch.losses import SlotLossConfig
from devias_tpu_torch.nn import create_model
from devias_tpu_torch.train import OptimConfig, TrainState, TrainStepConfig, make_optimizer, make_slot_train_step

TINY = dict(depth=2, embed_dim=64, num_heads=4)


def _setup(matching: str):
    slot_kw = dict(num_classes=4, num_scene_classes=3, num_latents=2, agg_depth=2, agg_weights_tie=True,
                   slot_matching_method=matching, **TINY)
    rng = np.random.default_rng(0)
    B = 8
    videos = (rng.normal(size=(B, 4, 32, 32, 3)) * 0.5).astype(np.float32)
    labels = np.arange(B) % 4
    jm = jax_create_model("slot_vit_base_patch16_224", **slot_kw)
    jt = jax_create_model("vit_base_patch16_224", num_classes=3, **TINY)
    params = jax.jit(jm.init)({"params": jax.random.PRNGKey(0)}, jnp.asarray(videos))["params"]
    tparams = jax.jit(jt.init)({"params": jax.random.PRNGKey(1)}, jnp.asarray(videos))["params"]

    model = load_jax_params(create_model("slot_vit_base_patch16_224", device="cpu", img_size=32, **slot_kw),
                            params, "slot")
    teacher = load_jax_params(create_model("vit_base_patch16_224", device="cpu", num_classes=3, **TINY), tparams,
                              "plain")
    opt, lr_fn = make_optimizer(model, OptimConfig(lr=3e-3, min_lr=3e-3, warmup_lr=3e-3, total_steps=200,
                                                   layer_decay=1.0), device="cpu")
    state = TrainState.create(model, opt, device="cpu")
    loss_cfg = SlotLossConfig(num_action_classes=4, num_scene_classes=3, slot_matching_method=matching)
    # FAME off so the memorization target is fixed
    step = make_slot_train_step(model, teacher, opt, loss_cfg, TrainStepConfig(use_fame=False), lr_fn, device="cpu")
    return state, step, {"videos": videos, "labels": labels}


def test_hard_select_training_memorizes_fixed_batch():
    state, step, batch = _setup("hard_select")
    for _ in range(100):
        m = step(state, batch)
    mm = {k: float(v) for k, v in m.items()}
    assert float(mm["class_acc"]) == 1.0, mm
    assert float(mm["action_loss"]) < 0.2, mm


def test_matching_training_reduces_loss():
    """With Hungarian matching on a from-scratch toy model the slot
    assignment keeps flipping (the paper trains from a pretrained backbone),
    so assert strong total-loss reduction + scene-distillation convergence
    rather than memorization."""
    state, step, batch = _setup("matching")
    first = None
    for _ in range(60):
        m = step(state, batch)
        if first is None:
            first = float(m["loss"])
    mm = {k: float(v) for k, v in m.items()}
    assert float(mm["loss"]) < first * 0.2, (first, mm)
    assert float(mm["scene_loss"]) < 1.0, mm
    assert float(mm["cosine_loss"]) < 1.0, mm
