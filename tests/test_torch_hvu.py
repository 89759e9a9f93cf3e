"""The port's HVU slot training against the JAX package's, in float32 at a
small size (depth 2, width 64, 4 heads, 4 latents, untied agg of depth 2,
4x32x32 clips):

(a) `hvu_slot_loss`: every term and the gradients of the total with
    respect to the student's outputs, under both scene criteria (which the
    reference reduces to one cross-entropy), to 1e-5 relative;
(b) `fame_augment_hvu` with the JAX call's own draws (its key split into a
    permutation and a keep), including the `prob_aug >= 1` quirk that
    mixes every clip but keeps the scene labels: labels exact, clips exact
    wherever the two frameworks' masks agree (FAME's thresholds are
    bisections, `tests/test_torch_fame.py`);
(c) the HVU model's weights through `state_dict_from_jax` with
    `strict=True`: untied agg layers and the full 739 + 248 head, outputs
    to 1e-4;
(d) a three-step `make_hvu_train_step` trajectory with FAME-HVU and
    update_freq 2 against the JAX step, drop-path off, its FAME draws
    rebuilt from the JAX step's key chain: metrics to 2e-4 relative, the
    final parameters as `tests/test_torch_train.py` holds them.
The JAX model is the plain-attention one the JAX HVU CLI builds; on the
CPU the port's K1 wrapper runs its plain version."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _jax_draws import fame_draws_from_key, step_key
from devias_tpu.aug import fame as jfame
from devias_tpu.losses import SlotLossConfig as JaxSlotLossConfig
from devias_tpu.losses import hvu_slot_loss as jax_hvu_slot_loss
from devias_tpu.nn import create_model as jax_create_model
from devias_tpu.train import OptimConfig as JaxOptimConfig
from devias_tpu.train import TrainState as JaxTrainState
from devias_tpu.train import TrainStepConfig as JaxTrainStepConfig
from devias_tpu.train import make_hvu_train_step as jax_make_hvu_train_step
from devias_tpu.train import make_optimizer as jax_make_optimizer
from devias_tpu_torch.aug import FAMEConfig, fame_augment_hvu
from devias_tpu_torch.aug.fame import IMAGENET_MEAN, IMAGENET_STD, compute_fame_masks
from devias_tpu_torch.ckpt.from_jax import load_jax_params, state_dict_from_jax
from devias_tpu_torch.losses import SlotLossConfig, hvu_slot_loss
from devias_tpu_torch.nn import create_model
from devias_tpu_torch.train import OptimConfig, TrainState, TrainStepConfig, make_hvu_train_step, make_optimizer

TOL = dict(rtol=1e-5, atol=1e-6)
SMALL = dict(depth=2, embed_dim=64, num_heads=4)
HVU = dict(num_classes=5, num_scene_classes=4, num_latents=4, agg_depth=2, agg_weights_tie=False, **SMALL)
OPT = dict(lr=1e-3, min_lr=1e-5, warmup_lr=1e-4, total_steps=8, warmup_steps=2, layer_decay=0.75,
           agg_block_scale=0.8, weight_decay=0.05, weight_decay_end=0.1, num_layers=2)
MEAN, STD = np.array(IMAGENET_MEAN, np.float32), np.array(IMAGENET_STD, np.float32)


def _zero_grad(name):
    """A norm bias every slot query shares cancels in the slot softmax: its
    true gradient is zero and both frameworks return rounding noise."""
    return name.startswith("agg_block.layers.") and name.endswith(".0.norm.bias")


def _student(rng, B=4, S=4, A=5, Sc=4, D=16, heads=4, N=32, n_sp=16):
    return {
        "slots_head": rng.normal(size=(B, S, A + Sc)).astype(np.float32) * 2,
        "slots": rng.normal(size=(B, S, D)).astype(np.float32),
        "mask_predictions": rng.uniform(size=(B, S, n_sp)).astype(np.float32),
        "attn": rng.uniform(size=(B, heads, S, N)).astype(np.float32),
    }


@pytest.mark.parametrize("criterion", ["KL", "CE"])
def test_hvu_slot_loss_and_grads_match(criterion):
    rng = np.random.default_rng(0)
    s = _student(rng)
    action = rng.integers(0, 5, size=4)
    scene = rng.integers(0, 4, size=4)
    fg = rng.uniform(size=(4, 16)).astype(np.float32)
    pf = rng.uniform(size=(4, 32)).astype(np.float32)
    kw = dict(scene_criterion=criterion, mask_prediction_loss_weight=3.0, mask_distill_loss_weight=2.0)
    jcfg, tcfg = JaxSlotLossConfig(5, 4, **kw), SlotLossConfig(5, 4, **kw)

    def jax_total(st):
        return jax_hvu_slot_loss(st, jnp.asarray(action), jnp.asarray(scene), jnp.asarray(fg), jnp.asarray(pf), jcfg)

    (j_total, (j_logits, j_parts)), j_grads = jax.value_and_grad(
        lambda st: (lambda r: (r[0], (r[1], r[2])))(jax_total(st)), has_aux=True)(
        {k: jnp.asarray(v) for k, v in s.items()})
    ts = {k: torch.from_numpy(v).requires_grad_(True) for k, v in s.items()}
    total, logits, parts = hvu_slot_loss(ts, torch.from_numpy(action), torch.from_numpy(scene),
                                         torch.from_numpy(fg), torch.from_numpy(pf), tcfg)
    total.backward()
    np.testing.assert_allclose(total.item(), float(j_total), **TOL)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(j_logits), **TOL)
    assert set(parts) == set(j_parts)
    for k in parts:
        np.testing.assert_allclose(parts[k].item(), float(j_parts[k]), err_msg=k, **TOL)
    for k, t in ts.items():
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j_grads[k]), err_msg=k, rtol=1e-5, atol=1e-7)


def _clips(seed, B=4, T=4, S=32):
    """A static textured background and a moving square per clip, in the
    normalised space."""
    rng = np.random.default_rng(seed)
    x = np.repeat(rng.uniform(size=(B, 1, S, S, 3)).astype(np.float32) * 0.5, T, axis=1)
    for b in range(B):
        color = rng.uniform(0.4, 1.0, size=3)
        for t in range(T):
            r, c = 4 + 2 * t + b, 5 + 2 * t
            x[b, t, r:r + 10, c:c + 10] = color * (0.8 + 0.2 * rng.uniform(size=(10, 10, 1)))
    x = np.clip(x + 0.02 * rng.normal(size=x.shape), 0, 1).astype(np.float32)
    return ((x - MEAN) / STD).astype(np.float32)


@pytest.mark.parametrize("seed,prob_aug", [(2, 0.6), (5, 1.0)])
def test_fame_augment_hvu_with_the_jax_draws_matches(seed, prob_aug):
    B = 4
    x = _clips(seed, B)
    action = np.arange(B)
    scene = np.array([10, 11, 12, 13])
    key = jax.random.PRNGKey(seed)
    draws = fame_draws_from_key(key, B, prob_aug)
    v_j, a_j, s_j, (fg_j, pf_j) = jfame.fame_augment_hvu(key, jnp.asarray(x), jnp.asarray(action),
                                                         jnp.asarray(scene), jfame.FAMEConfig(prob_aug=prob_aug))
    cfg = FAMEConfig(prob_aug=prob_aug)
    v_t, a_t, s_t, (fg_t, pf_t) = fame_augment_hvu(torch.from_numpy(x), torch.from_numpy(action),
                                                   torch.from_numpy(scene), cfg, draws=draws)
    np.testing.assert_array_equal(a_t.numpy(), np.asarray(a_j))
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
    perm, keep = draws["perm"].numpy(), draws["keep"].numpy()
    if prob_aug < 1:
        np.testing.assert_array_equal(s_t.numpy(), np.where(keep, scene[perm], scene))
        assert (s_t.numpy() != scene).any()  # the draws swap at least one label
    else:
        np.testing.assert_array_equal(s_t.numpy(), scene)  # the quirk: mixed, not relabelled
        assert keep.all() and (perm != np.arange(B)).any()
    for got, want in ((fg_t, fg_j), (pf_t, pf_j)):
        d = np.abs(got.numpy() - np.asarray(want))
        assert d.max() <= 1 / 64 and d.mean() <= 1e-3, (d.max(), d.mean())
    denorm = x * STD + MEAN
    mask_t = compute_fame_masks(torch.from_numpy(denorm), cfg)[0].numpy()
    mask_j = np.asarray(jfame.compute_fame_masks(jnp.asarray(denorm), jfame.FAMEConfig(prob_aug=prob_aug))[0])
    agree = np.broadcast_to((mask_t == mask_j)[:, None, :, :, None], x.shape)
    assert agree.mean() >= 0.99
    np.testing.assert_array_equal(v_t.numpy()[agree], np.asarray(v_j)[agree])


def _jax_params(seed, **kw):
    x = jnp.zeros((2, 4, 32, 32, 3), jnp.float32)
    model = jax_create_model("slot_vit_base_patch16_224", **kw)
    params = model.init({"params": jax.random.PRNGKey(seed)}, x)["params"]
    rng = np.random.default_rng(seed)
    # a non-zero head, so the slot selection is not a tie
    return model, jax.tree.map(lambda a: np.asarray(a) + 0.05 * rng.normal(size=a.shape).astype(np.float32), params)


def test_hvu_model_weights_load_strict_and_match():
    """The HVU CLI's model shape: untied agg layers (`agg_block.layers.{0..3}`)
    and a 739 + 248 head, loaded with strict=True."""
    kw = dict(HVU, num_classes=739, num_scene_classes=248, agg_depth=4)
    jm, params = _jax_params(1, **kw)
    assert sorted(k for k in params["agg_block"] if k.startswith("layers_")) == [f"layers_{i}" for i in range(4)]
    model = load_jax_params(create_model("slot_vit_base_patch16_224", device="cpu", img_size=32, **kw), params,
                            "slot")
    sd = state_dict_from_jax(params, "slot", 4)
    assert sd["head.weight"].shape == (987, 64) and "agg_block.layers.3.0.fn.to_q.weight" in sd
    assert not np.array_equal(sd["agg_block.layers.0.0.fn.to_q.weight"], sd["agg_block.layers.3.0.fn.to_q.weight"])
    x = np.random.default_rng(2).normal(size=(2, 4, 32, 32, 3)).astype(np.float32)
    want = jm.apply({"params": params}, jnp.asarray(x), deterministic=True)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    for k in ("slots_head", "action_logit", "scene_logit", "mask_predictions"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-4, atol=1e-5, err_msg=k)


def _step_draws(key, step, U, mb, prob_aug):
    """The JAX HVU step's FAME draws at `step`: split(fold_in(key, step), U)
    -> split(., 3)[0] -> `_fame_core`'s permutation and keep."""
    return [fame_draws_from_key(jax.random.split(step_key(key, step, U, u), 3)[0], mb, prob_aug) for u in range(U)]


def test_hvu_train_trajectory_matches_jax_step():
    U, B, prob_aug = 2, 4, 0.8
    jm, params = _jax_params(3, **HVU)
    tx, lr_fn = jax_make_optimizer(params, JaxOptimConfig(**OPT))
    state = JaxTrainState.create(params, tx)
    jcfg = JaxSlotLossConfig(5, 4)
    jstep = jax.jit(jax_make_hvu_train_step(jm, tx, jcfg, JaxTrainStepConfig(
        update_freq=U, use_fame=True, fame=jfame.FAMEConfig(prob_aug=prob_aug)), lr_fn))

    model = load_jax_params(create_model("slot_vit_base_patch16_224", device="cpu", img_size=32, **HVU), params,
                            "slot")
    opt, t_lr_fn = make_optimizer(model, OptimConfig(**OPT), device="cpu")
    t_state = TrainState.create(model, opt, device="cpu")
    tstep = make_hvu_train_step(model, opt, SlotLossConfig(5, 4), TrainStepConfig(
        update_freq=U, use_fame=True, fame=FAMEConfig(prob_aug=prob_aug)), t_lr_fn, device="cpu")

    data = np.random.default_rng(5)
    key = jax.random.PRNGKey(7)
    for s in range(3):
        batch = {"videos": data.normal(size=(B, 4, 32, 32, 3)).astype(np.float32),
                 "labels": data.integers(0, 5, size=B), "scene_labels": data.integers(0, 4, size=B)}
        state, want = jstep(state, {k: jnp.asarray(v) for k, v in batch.items()}, key)
        got = tstep(t_state, batch, draws=_step_draws(key, s, U, B // U, prob_aug), host_metrics=True)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k], float(want[k]), rtol=2e-4, atol=1e-6, err_msg=f"step {s} {k}")
    assert t_state.step == 3 and int(state.step) == 3

    final = state_dict_from_jax(jax.tree.map(np.asarray, state.params), "slot", HVU["agg_depth"])
    lr_sum = sum(t_lr_fn(s) for s in range(3))
    for name, p in model.named_parameters():
        got, want = p.detach().numpy(), final[name]
        tol = 1e-5 + 3e-4 * np.abs(want).max()
        off = np.abs(got - want) > tol
        assert _zero_grad(name) or off.mean() <= 0.02, (name, off.mean())
        assert np.abs(got - want)[off].max(initial=0) <= 2 * lr_sum, name


def test_hvu_step_without_fame_and_its_checks():
    """--mask_model '' (the HVU CLI's default): zero masks, no draws; the
    step refuses a sequence-parallel layout."""
    model = create_model("slot_vit_base_patch16_224", device="cpu", img_size=32, **HVU)
    opt, _ = make_optimizer(model, OptimConfig(**OPT), device="cpu")
    state = TrainState.create(model, opt, device="cpu")
    step = make_hvu_train_step(model, opt, SlotLossConfig(5, 4), TrainStepConfig(use_fame=False), device="cpu")
    rng = np.random.default_rng(0)
    m = step(state, {"videos": rng.normal(size=(2, 4, 32, 32, 3)).astype(np.float32),
                     "action_labels": np.array([0, 1]), "scene_labels": np.array([2, 3])}, host_metrics=True)
    assert np.isfinite(list(m.values())).all() and state.step == 1
    # zero masks: the BCE of a sigmoid against 0 and the MSE against 0 stay positive
    assert m["mask_prediction_loss"] > 0 and m["mask_distill_loss"] > 0

    class Layout:
        seq_size = 2

    with pytest.raises(ValueError, match="sequence-parallel"):
        make_hvu_train_step(model, opt, SlotLossConfig(5, 4), dp_mesh=Layout(), device="cpu")
