"""The port's downstream slot-fusion model against the JAX package's, in
float32 at a small size (depth 2, width 64, 4 heads, 4x32x32 clips, 2
slots):

(a) `SlotFusionViT` through `load_jax_params` with `strict=True` against
    the flax model (its attention in Pallas interpret mode): `concat` with
    the MLP fusion head (with and without `use_input_ln`, tied and untied
    agg blocks) and the linear one, and `gap`; logits and features to 1e-4
    relative;
(b) a JAX model exported to `.pth` (`devias_tpu/ckpt/torch_export.py`),
    loaded through the port's `slot_fusion` import and through the JAX
    import over the same starting weights: every tensor of the model loaded
    (a linear fusion head of another width than the unified head dropped,
    as the JAX import drops it), nothing unused, the two models' logits to
    1e-4 relative;
(c) a three-step trajectory of the classification step on the fusion
    model's logits (label smoothing 0.1, update_freq 2, layer decay 0.75,
    agg lr scale 0.8, no dropout or drop-path) against the JAX step:
    metrics to 2e-4 relative, final parameters as `tests/test_torch_train.py`
    holds them. This covers the selection `head` and the dead
    `fc_scene_*` weights, which get no gradient and decay as optax decays
    them."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from devias_tpu.ckpt import import_torch_state_dict as jax_import_torch_state_dict
from devias_tpu.ckpt import load_torch_checkpoint_file as jax_load_torch_checkpoint_file
from devias_tpu.ckpt.torch_export import save_torch_checkpoint
from devias_tpu.ckpt.torch_import import merge_params as jax_merge_params
from devias_tpu.losses import label_smoothing_cross_entropy as jax_ls_ce
from devias_tpu.nn import create_model as jax_create_model
from devias_tpu.train import OptimConfig as JaxOptimConfig
from devias_tpu.train import TrainState as JaxTrainState
from devias_tpu.train import make_classification_train_step as jax_make_classification_train_step
from devias_tpu.train import make_optimizer as jax_make_optimizer
from devias_tpu_torch.ckpt import load_reference_checkpoint
from devias_tpu_torch.ckpt.from_jax import load_jax_params, param_name_map, state_dict_from_jax
from devias_tpu_torch.losses import label_smoothing_cross_entropy
from devias_tpu_torch.nn import create_model
from devias_tpu_torch.train import OptimConfig, TrainState, make_classification_train_step, make_optimizer

SMALL = dict(depth=2, embed_dim=64, num_heads=4)
A, S, K = 5, 4, 6  # pretrain action and scene classes, downstream classes
FUSION = dict(num_classes=A, num_scene_classes=S, downstream_nb_classes=K, num_latents=2, agg_depth=3, **SMALL)
OPT = dict(lr=1e-3, min_lr=1e-5, warmup_lr=1e-4, total_steps=8, warmup_steps=2, layer_decay=0.75,
           agg_block_scale=0.8, weight_decay=0.05, weight_decay_end=0.1, num_layers=2)
NAME = "slot_fusion_vit_base_patch16_224"
# a bias every slot query shares cancels in the slot softmax: its true
# gradient is zero and both frameworks return rounding noise
ZERO_GRAD = ("agg_block.layers.0.0.norm.bias",)
# (method, head_type, use_input_ln, tied)
CONFIGS = {"concat_mlp_tied": ("concat", "mlp", False, True),
           "concat_mlp_input_ln_untied": ("concat", "mlp", True, False),
           "concat_linear_tied": ("concat", "linear", False, True),
           "concat_linear_untied": ("concat", "linear", False, False), "gap": ("gap", "linear", False, True)}


def _kw(config):
    method, head, ln, tied = CONFIGS[config]
    return dict(FUSION, slot_fusion_method=method, head_type=head, use_input_ln=ln, agg_weights_tie=tied)


def _jax_params(seed, **kw):
    x = jnp.zeros((2, 4, 32, 32, 3), jnp.float32)
    model = jax_create_model(NAME, fused_attention=True, fused_interpret=True, **kw)
    params = model.init({"params": jax.random.PRNGKey(seed)}, x)["params"]
    rng = np.random.default_rng(seed)
    # a selection head far from a tie, and norms and heads off their init
    return model, jax.tree.map(lambda a: np.asarray(a) + 0.3 * rng.normal(size=a.shape).astype(np.float32), params)


def _clips(seed, n=2):
    return np.random.default_rng(seed).normal(size=(n, 4, 32, 32, 3)).astype(np.float32)


@pytest.mark.parametrize("config", list(CONFIGS))
def test_slot_fusion_vit_matches_flax(config):
    kw = _kw(config)
    jm, params = _jax_params(1, **kw)
    sd = state_dict_from_jax(params, "slot_fusion", kw["agg_depth"])
    gap = kw["slot_fusion_method"] == "gap"
    assert ("agg_block.latents" in sd, "head.weight" in sd, "scene_norm.weight" in sd) == (not gap,) * 3
    model = load_jax_params(create_model(NAME, device="cpu", **kw), params, "slot_fusion")
    x = _clips(2)
    want = jm.apply({"params": params}, jnp.asarray(x), deterministic=True)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert set(got) == set(want) and got["logits"].shape == (2, K)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-4, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("config", ["concat_mlp_tied", "concat_linear_untied"])
def test_exported_checkpoint_loads_strict_and_matches_jax_import(config, tmp_path):
    kw = _kw(config)
    jm, params = _jax_params(3, **kw)
    _, other = _jax_params(4, **kw)  # the checkpoint's weights
    pth = str(tmp_path / "fusion.pth")
    save_torch_checkpoint(pth, other, "slot_fusion", agg_depth=kw["agg_depth"])
    unique = 1 if kw["agg_weights_tie"] else kw["agg_depth"]
    model = load_jax_params(create_model(NAME, device="cpu", **kw), params, "slot_fusion")
    _, report = load_reference_checkpoint(model, pth, "slot_fusion", agg_depth=kw["agg_depth"],
                                          agg_unique_layers=unique, expected_head_out=A + S)
    linear = kw["head_type"] == "linear"
    dropped = {"fusion_head.weight", "fusion_head.bias"} if linear else set()
    assert set(report["loaded"]) == set(model.state_dict()) - dropped and report["unused_in_ckpt"] == []
    imported = jax_import_torch_state_dict(jax_load_torch_checkpoint_file(pth), "slot_fusion", depth=2,
                                           agg_unique_layers=unique, expected_head_out=A + S)
    assert ("fusion_head" in imported) == (not linear)
    merged, _ = jax_merge_params(params, imported)
    x = _clips(5)
    want = jm.apply({"params": merged}, jnp.asarray(x), deterministic=True)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-4, atol=1e-5, err_msg=k)


def test_downstream_trajectory_matches_jax_classification_step():
    U, B = 2, 4
    kw = _kw("concat_mlp_tied")
    jm, params = _jax_params(6, **kw)
    tx, lr_fn = jax_make_optimizer(params, JaxOptimConfig(**OPT))
    state = JaxTrainState.create(params, tx)
    jstep = jax.jit(jax_make_classification_train_step(jm, tx, lambda lg, lb: jax_ls_ce(lg, lb, 0.1), U, lr_fn))

    model = load_jax_params(create_model(NAME, device="cpu", **kw), params, "slot_fusion")
    opt, t_lr_fn = make_optimizer(model, OptimConfig(**OPT), device="cpu")
    paths = param_name_map("slot_fusion", kw["agg_depth"], opt.names)
    assert {n for n, s in zip(opt.names, opt.scales) if s == pytest.approx(0.8)} == {
        n for n in opt.names if n.startswith("agg_block.")}
    t_state = TrainState.create(model, opt, device="cpu")
    tstep = make_classification_train_step(model, opt, lambda lg, lb: label_smoothing_cross_entropy(lg, lb, 0.1), U,
                                           t_lr_fn, device="cpu")
    data = np.random.default_rng(7)
    for s in range(3):
        batch = {"videos": data.normal(size=(B, 4, 32, 32, 3)).astype(np.float32),
                 "labels": data.integers(0, K, size=B)}
        state, want = jstep(state, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(8))
        got = tstep(t_state, batch, host_metrics=True)
        assert set(got) == set(want) == {"loss", "class_acc", "grad_norm", "lr"}
        for k in want:
            np.testing.assert_allclose(got[k], float(want[k]), rtol=2e-4, atol=1e-6, err_msg=f"step {s} {k}")
    final = state_dict_from_jax(jax.tree.map(np.asarray, state.params), "slot_fusion", kw["agg_depth"])
    init = state_dict_from_jax(params, "slot_fusion", kw["agg_depth"])
    lr_sum = sum(t_lr_fn(s) for s in range(3))
    for name, p in model.named_parameters():
        got, want = p.detach().numpy(), final[name]
        tol = 1e-5 + 3e-4 * np.abs(want).max()
        off = np.abs(got - want) > tol
        assert name in ZERO_GRAD or off.mean() <= 0.02, (name, off.mean())
        assert np.abs(got - want)[off].max(initial=0) <= 2 * lr_sum, name
    # the dead scene branch: no gradient, yet its kernel decays (its bias
    # and norm are not decayed and stay where they were)
    for name in ("fusion_head.fc_scene_down.weight", "fusion_head.fc_scene_ln.weight"):
        assert model.get_parameter(name).grad is None and paths[name][:2] == ("fusion_head", name.split(".")[1])
    shrink = final["fusion_head.fc_scene_down.weight"] / init["fusion_head.fc_scene_down.weight"]
    assert np.all(shrink < 1.0)
    np.testing.assert_array_equal(model.get_parameter("fusion_head.fc_scene_ln.weight").detach().numpy(),
                                  init["fusion_head.fc_scene_ln.weight"])
