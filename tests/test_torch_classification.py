"""The port's plain classification training against the JAX package's, in
float32 at a small size (depth 2, width 64, 4 heads, 4x32x32 clips):

(a) the classification criteria (`soft_target_cross_entropy`,
    `label_smoothing_cross_entropy`) and their gradients, to 1e-5;
(b) the CLS plain ViT (`use_mean_pooling=False`: `cls_token`, the final
    `norm`, no `fc_norm`) and the mean-pooled one through
    `state_dict_from_jax` with `strict=True`, outputs to 1e-4;
(c) three-step trajectories of `make_classification_train_step` against
    the JAX step with update_freq 2, drop-path off, under cross-entropy,
    label smoothing, and mixup / CutMix with soft targets (its draws
    rebuilt from the JAX step's key chain, `tests/_jax_draws.py`), each
    mean-pooled and with the CLS token: metrics to 2e-4 relative, the
    final parameters as `tests/test_torch_train.py` holds them."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _jax_draws import mixup_draws_from_key, step_key
from devias_tpu.aug.mixup import MixupConfig as JaxMixupConfig
from devias_tpu.losses import cross_entropy as jax_ce
from devias_tpu.losses import label_smoothing_cross_entropy as jax_ls_ce
from devias_tpu.losses import soft_target_cross_entropy as jax_soft_ce
from devias_tpu.nn import create_model as jax_create_model
from devias_tpu.train import OptimConfig as JaxOptimConfig
from devias_tpu.train import TrainState as JaxTrainState
from devias_tpu.train import make_classification_train_step as jax_make_classification_train_step
from devias_tpu.train import make_optimizer as jax_make_optimizer
from devias_tpu_torch.aug import MixupConfig
from devias_tpu_torch.ckpt.from_jax import load_jax_params, state_dict_from_jax
from devias_tpu_torch.losses import cross_entropy, label_smoothing_cross_entropy, soft_target_cross_entropy
from devias_tpu_torch.nn import create_model
from devias_tpu_torch.train import OptimConfig, TrainState, make_classification_train_step, make_optimizer

SMALL = dict(depth=2, embed_dim=64, num_heads=4)
K = 5
OPT = dict(lr=1e-3, min_lr=1e-5, warmup_lr=1e-4, total_steps=8, warmup_steps=2, layer_decay=0.75,
           weight_decay=0.05, weight_decay_end=0.1, num_layers=2)
MIXUP = dict(mixup_alpha=0.8, cutmix_alpha=1.0, label_smoothing=0.1, num_classes=K)


def test_criteria_and_grads_match():
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(6, K)).astype(np.float32) * 3
    labels = rng.integers(0, K, size=6)
    soft = rng.dirichlet(np.ones(K), size=6).astype(np.float32)
    cases = ((soft_target_cross_entropy, jax_soft_ce, soft),
             (lambda lg, lb: label_smoothing_cross_entropy(lg, lb, 0.2), lambda lg, lb: jax_ls_ce(lg, lb, 0.2), labels),
             (cross_entropy, jax_ce, labels))
    for ours, theirs, target in cases:
        want, want_grad = jax.value_and_grad(lambda x: theirs(x, jnp.asarray(target)).sum())(jnp.asarray(logits))
        x = torch.from_numpy(logits).requires_grad_(True)
        per = ours(x, torch.from_numpy(target))
        assert per.shape == (6,)
        per.sum().backward()
        np.testing.assert_allclose(per.sum().item(), float(want), rtol=1e-5)
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_grad), rtol=1e-5, atol=1e-7)


def _jax_params(seed, **kw):
    x = jnp.zeros((2, 4, 32, 32, 3), jnp.float32)
    model = jax_create_model("vit_base_patch16_224", **kw)
    params = model.init({"params": jax.random.PRNGKey(seed)}, x)["params"]
    rng = np.random.default_rng(seed)
    # a head of real size (the init scale makes it ~1e-5)
    return model, jax.tree.map(lambda a: np.asarray(a) + 0.05 * rng.normal(size=a.shape).astype(np.float32), params)


@pytest.mark.parametrize("cls", [False, True])
def test_plain_vit_weights_load_strict_and_match(cls):
    kw = dict(num_classes=365 if cls else K, use_mean_pooling=not cls, **SMALL)
    jm, params = _jax_params(1, **kw)
    sd = state_dict_from_jax(params, "plain")
    assert ("cls_token" in sd, "norm.weight" in sd, "fc_norm.weight" in sd) == (cls, cls, not cls)
    model = load_jax_params(create_model("vit_base_patch16_224", device="cpu", **kw), params, "plain")
    x = np.random.default_rng(2).normal(size=(2, 4, 32, 32, 3)).astype(np.float32)
    want = jm.apply({"params": params}, jnp.asarray(x), deterministic=True)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert got["logits"].shape == (2, kw["num_classes"])
    np.testing.assert_allclose(got["logits"].numpy(), np.asarray(want["logits"]), rtol=1e-4, atol=1e-5)


CRITERIA = {"ce": (cross_entropy, jax_ce), "smoothing": (lambda lg, lb: label_smoothing_cross_entropy(lg, lb, 0.1),
                                                         lambda lg, lb: jax_ls_ce(lg, lb, 0.1)),
            "mixup": (soft_target_cross_entropy, jax_soft_ce)}


@pytest.mark.parametrize("cls", [False, True])
@pytest.mark.parametrize("criterion", list(CRITERIA))
def test_classification_trajectory_matches_jax_step(criterion, cls):
    U, B = 2, 4
    kw = dict(num_classes=K, use_mean_pooling=not cls, **SMALL)
    jm, params = _jax_params(3, **kw)
    tx, lr_fn = jax_make_optimizer(params, JaxOptimConfig(**OPT))
    state = JaxTrainState.create(params, tx)
    ours, theirs = CRITERIA[criterion]
    mix = criterion == "mixup"
    jmix = JaxMixupConfig(**MIXUP) if mix else None
    jstep = jax.jit(jax_make_classification_train_step(jm, tx, theirs, U, lr_fn, mixup_cfg=jmix))

    model = load_jax_params(create_model("vit_base_patch16_224", device="cpu", **kw), params, "plain")
    opt, t_lr_fn = make_optimizer(model, OptimConfig(**OPT), device="cpu")
    t_state = TrainState.create(model, opt, device="cpu")
    tstep = make_classification_train_step(model, opt, ours, U, t_lr_fn, mixup_cfg=MixupConfig(**MIXUP) if mix else None,
                                           device="cpu")
    data = np.random.default_rng(5)
    key = jax.random.PRNGKey(7)
    for s in range(3):
        batch = {"videos": data.normal(size=(B, 4, 32, 32, 3)).astype(np.float32), "labels": data.integers(0, K, size=B)}
        state, want = jstep(state, {k: jnp.asarray(v) for k, v in batch.items()}, key)
        draws = [mixup_draws_from_key(jax.random.split(step_key(key, s, U, u), 3)[2], jmix, B // U, 32, 32)
                 for u in range(U)] if mix else None
        got = tstep(t_state, batch, draws=draws, host_metrics=True)
        assert set(got) == set(want) == {"loss", "class_acc", "grad_norm", "lr"}
        for k in want:
            np.testing.assert_allclose(got[k], float(want[k]), rtol=2e-4, atol=1e-6, err_msg=f"step {s} {k}")
    final = state_dict_from_jax(jax.tree.map(np.asarray, state.params), "plain")
    lr_sum = sum(t_lr_fn(s) for s in range(3))
    for name, p in model.named_parameters():
        got, want = p.detach().numpy(), final[name]
        tol = 1e-5 + 3e-4 * np.abs(want).max()
        off = np.abs(got - want) > tol
        assert off.mean() <= 0.02, (name, off.mean())
        assert np.abs(got - want)[off].max(initial=0) <= 2 * lr_sum, name
