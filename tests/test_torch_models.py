"""Whole models of the port against the JAX package, after
`load_jax_params`, and the weight bridge against the JAX package's own
exporter. Small size (depth 2, width 64, 4 heads, 2x4x32x32 clips), inputs
from a numpy seed, float32. Outputs hold to 1e-4: two blocks and eight agg
rounds of float32 rounding in another summation order."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from devias_tpu.ckpt.torch_export import export_torch_state_dict
from devias_tpu.nn import create_model as jax_create_model
from devias_tpu_torch.ckpt.from_jax import load_jax_params, state_dict_from_jax
from devias_tpu_torch.nn import create_model

SMALL = dict(depth=2, embed_dim=64, num_heads=4)
SLOT = dict(num_classes=5, num_scene_classes=4, num_latents=2, agg_depth=8, **SMALL)
TOL = dict(rtol=1e-4, atol=1e-4)


def _clips(seed):
    return np.random.default_rng(seed).normal(size=(2, 4, 32, 32, 3)).astype(np.float32)


def _jax_model(name, seed, x, **kw):
    model = jax_create_model(name, fused_attention=True, fused_interpret=True, **kw)
    params = model.init({"params": jax.random.PRNGKey(seed)}, jnp.asarray(x))["params"]
    # a non-zero head: JAX initialises it near zero (init_scale), which
    # would make the slot selection a tie
    params = dict(params, head=jax.tree.map(
        lambda a: np.random.default_rng(seed).normal(size=a.shape).astype(np.float32) * 0.1, params["head"]))
    return model, params


@pytest.mark.parametrize("slot_matching_method,head_type", [
    ("matching", "linear"), ("hard_select", "linear"), ("matching", "mlp")])
def test_slot_vit_matches(slot_matching_method, head_type):
    x = _clips(0)
    kw = dict(slot_matching_method=slot_matching_method, head_type=head_type, **SLOT)
    jm, params = _jax_model("slot_vit_base_patch16_224", 0, x, **kw)
    want = jm.apply({"params": params}, jnp.asarray(x))
    tm = create_model("slot_vit_base_patch16_224", device="cpu", img_size=32, fused_attention=True, **kw)
    load_jax_params(tm, params, "slot")
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert set(got) == set(want)
    for key in want:
        g, w = got[key].numpy(), np.asarray(want[key])
        assert g.shape == w.shape, key
        if key.endswith("_idx"):
            np.testing.assert_array_equal(g, w, err_msg=key)
        else:
            np.testing.assert_allclose(g, w, err_msg=key, **TOL)


@pytest.mark.parametrize("use_mean_pooling", [False, True])
def test_plain_vit_matches(use_mean_pooling):
    x = _clips(1)
    kw = dict(num_classes=7, use_mean_pooling=use_mean_pooling, **SMALL)
    jm, params = _jax_model("vit_base_patch16_224", 1, x, **kw)
    want = jm.apply({"params": params}, jnp.asarray(x))
    tm = create_model("vit_base_patch16_224", device="cpu", fused_attention=True, **kw)
    load_jax_params(tm, params, "plain")
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    for key in ("token", "logits"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), err_msg=key, **TOL)


@pytest.mark.parametrize("name,kind,kw", [
    ("slot_vit_base_patch16_224", "slot", SLOT),
    ("vit_base_patch16_224", "plain", dict(num_classes=7, use_mean_pooling=False, **SMALL)),
    ("vit_base_patch16_224", "plain", dict(num_classes=7, **SMALL)),
])
def test_state_dict_matches_jax_exporter(name, kind, kw):
    x = _clips(2)
    _, params = _jax_model(name, 2, x, **kw)
    depth = kw.get("agg_depth", 8)
    ours = state_dict_from_jax(params, kind, depth)
    theirs = export_torch_state_dict(params, kind, depth)
    assert ours.keys() == theirs.keys()
    for k in ours:
        np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)
    tm = create_model(name, device="cpu", **({"img_size": 32} if kind == "slot" else {}), **kw)
    assert tm.state_dict().keys() == ours.keys()
    load_jax_params(tm, params, kind)  # strict


def test_state_dict_from_jax_rejects_wrong_kind():
    x = _clips(3)
    _, params = _jax_model("vit_base_patch16_224", 3, x, num_classes=7, **SMALL)
    with pytest.raises(ValueError, match="lack"):
        state_dict_from_jax(params, "slot")
    with pytest.raises(ValueError, match="unknown model_kind"):
        state_dict_from_jax(params, "segformer")


def test_create_model_lists_registry_on_unknown_name():
    with pytest.raises(ValueError, match="slot_vit_base_patch16_224"):
        create_model("vit_large_patch16_224", device="cpu")
