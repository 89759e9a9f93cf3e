"""Gradients of the port's modules against `jax.grad` of the JAX package's,
after loading the same weights, in float32 at a small size (width 64, 4
heads, depth 2, 2x4x32x32 clips). The loss is a fixed random weighting of
the outputs. Each gradient is held to TOL of its largest magnitude, or of
1e-3 of the module's largest gradient where that is larger (the slot
queries' LayerNorm bias has an exactly-zero gradient, since the slot
softmax cancels it, and both sides return rounding noise): float32
rounding of the same math in another order; the JAX side's hand-written
VJPs (FastLayerNorm, the tied agg stack with its K/V projections, K1 in
interpret mode) against autograd of the port's forward.

Also drop-path and dropout in training mode."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from devias_tpu.nn import create_model as jax_create_model
from devias_tpu.nn import vit as jvit
from devias_tpu.nn.agg import AggregationBlock as JaxAggregationBlock
from devias_tpu_torch.ckpt.from_jax import agg_from_jax, backbone_from_jax, load_jax_params, state_dict_from_jax
from devias_tpu_torch.nn import create_model
from devias_tpu_torch.nn import vit as tvit
from devias_tpu_torch.nn.agg import AggregationBlock

TOL = 1e-4


def _t(x):
    return torch.from_numpy(np.asarray(x, dtype=np.float32).copy())


def _close(got, want, name, tol=TOL, floor=0.0):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, name
    err = np.abs(got - want).max()
    scale = max(np.abs(want).max(), floor)
    assert err <= tol * scale, (name, err, scale)


def _check_grads(module, sd_grads, tol=TOL):
    named = list(module.named_parameters())
    floor = 1e-3 * max(np.abs(np.asarray(sd_grads[n])).max() for n, _ in named)
    for name, p in named:
        assert p.grad is not None, name
        _close(p.grad.numpy(), sd_grads[name], name, tol, floor)


def _weights(rng, shape):
    return rng.normal(size=shape).astype(np.float32)


def _block_sd(p, tree):
    """A block's flax tree (params or grads) in the port's layout."""
    sd = {}
    backbone_from_jax(sd, {"patch_embed": {"kernel": np.zeros((2 * 16 * 16 * 3, 64), np.float32),
                                           "bias": np.zeros(64, np.float32)}, "blocks_0": tree})
    return {k[len("blocks.0."):]: v for k, v in sd.items() if k.startswith("blocks.0.")}


def test_fast_layer_norm_grads_match():
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(2, 5, 64)) * 3 + 1).astype(np.float32)
    w = _weights(rng, x.shape)
    p = {"scale": _weights(rng, 64), "bias": _weights(rng, 64)}
    jm = jvit.FastLayerNorm(epsilon=1e-6)
    gp, gx = jax.grad(lambda p, x: (jm.apply({"params": p}, x) * w).sum(), argnums=(0, 1))(p, jnp.asarray(x))
    tm = tvit.FastLayerNorm(64)
    tm.load_state_dict({"weight": _t(p["scale"]), "bias": _t(p["bias"])})
    xt = _t(x).requires_grad_()
    (tm(xt) * _t(w)).sum().backward()
    _close(xt.grad.numpy(), gx, "x")
    _check_grads(tm, {"weight": gp["scale"], "bias": gp["bias"]})


def test_block_grads_match():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 9, 64)).astype(np.float32)
    w = _weights(rng, x.shape)
    jm = jvit.Block(num_heads=4, fused_attention=True, fused_interpret=True)
    p = jm.init({"params": jax.random.PRNGKey(1)}, jnp.asarray(x))["params"]
    p = jax.tree.map(lambda a: np.asarray(a) + 0.05 * _weights(rng, a.shape), p)
    gp, gx = jax.grad(lambda p, x: (jm.apply({"params": p}, x) * w).sum(), argnums=(0, 1))(p, jnp.asarray(x))
    tm = tvit.Block(64, 4, fused_attention=True)
    tm.load_state_dict({k: _t(v) for k, v in _block_sd(p, p).items()}, strict=True)
    xt = _t(x).requires_grad_()
    (tm(xt) * _t(w)).sum().backward()
    _close(xt.grad.numpy(), gx, "x")
    _check_grads(tm, _block_sd(p, gp))


@pytest.mark.parametrize("weight_tie,depth", [(True, 8), (False, 3)])
def test_aggregation_block_grads_match(weight_tie, depth):
    rng = np.random.default_rng(depth)
    B, N, D = 2, 9, 64
    ctx = rng.normal(size=(B, N, D)).astype(np.float32)
    w_slots, w_P = _weights(rng, (B, 2, D)), _weights(rng, (B, 4, 2, N))
    jm = JaxAggregationBlock(num_latents=2, latent_dim=D, depth=depth, weight_tie=weight_tie)
    p = jm.init({"params": jax.random.PRNGKey(depth)}, jnp.asarray(ctx))["params"]
    p = jax.tree.map(lambda a: np.asarray(a) + 0.1 * _weights(rng, a.shape), p)

    def loss(p, c):
        slots, P = jm.apply({"params": p}, c)
        return (slots * w_slots).sum() + (P * w_P).sum()

    gp, gc = jax.grad(loss, argnums=(0, 1))(p, jnp.asarray(ctx))
    tm = AggregationBlock(num_latents=2, latent_dim=D, depth=depth, weight_tie=weight_tie)
    sd, gsd = {}, {}
    agg_from_jax(sd, p, depth, prefix="")
    agg_from_jax(gsd, jax.tree.map(np.asarray, gp), depth, prefix="")
    tm.load_state_dict({k: _t(v) for k, v in sd.items()}, strict=True)
    ct = _t(ctx).requires_grad_()
    slots, P = tm(ct)
    ((slots * _t(w_slots)).sum() + (P * _t(w_P)).sum()).backward()
    _close(ct.grad.numpy(), gc, "context")
    _check_grads(tm, gsd)


def test_slot_vit_grads_match():
    """The whole student, fused attention on both sides, gradients of a
    weighted sum of slots, slots_head, mask_predictions and attn."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 4, 32, 32, 3)).astype(np.float32)
    kw = dict(num_classes=5, num_scene_classes=4, num_latents=2, agg_depth=8, depth=2, embed_dim=64, num_heads=4)
    jm = jax_create_model("slot_vit_base_patch16_224", fused_attention=True, fused_interpret=True, **kw)
    p = jm.init({"params": jax.random.PRNGKey(3)}, jnp.asarray(x))["params"]
    p = jax.tree.map(lambda a: np.asarray(a) + 0.02 * _weights(rng, a.shape), p)
    keys = ("slots", "slots_head", "mask_predictions", "attn")
    out0 = jm.apply({"params": p}, jnp.asarray(x))
    ws = {k: _weights(rng, out0[k].shape) for k in keys}

    def loss(p):
        out = jm.apply({"params": p}, jnp.asarray(x))
        return sum((out[k] * ws[k]).sum() for k in keys)

    gp = jax.tree.map(np.asarray, jax.grad(loss)(p))
    tm = create_model("slot_vit_base_patch16_224", device="cpu", img_size=32, fused_attention=True, **kw)
    load_jax_params(tm, p, "slot")
    out = tm(_t(x))
    sum((out[k].float() * _t(ws[k])).sum() for k in keys).backward()
    _check_grads(tm, state_dict_from_jax(gp, "slot", 8), tol=1e-3)


def test_drop_path_and_dropout_in_training():
    g = torch.Generator().manual_seed(0)
    x = torch.ones(4000, 3, 5)
    y = tvit.drop_path(x, 0.25, True, g)
    per_sample = y.reshape(4000, -1)
    assert torch.all((per_sample == 0).all(1) | (per_sample == 1 / 0.75).all(1))
    assert abs((per_sample[:, 0] == 0).float().mean().item() - 0.25) < 0.03
    z = tvit.dropout(x, 0.25, True, g)
    assert set(z.unique().tolist()) == {0.0, torch.tensor(1 / 0.75).item()}
    assert abs((z == 0).float().mean().item() - 0.25) < 0.01
    for fn in (tvit.drop_path, tvit.dropout):
        assert fn(x, 0.25, False, g) is x and fn(x, 0.0, True, g) is x
    with pytest.raises(ValueError, match="Generator"):
        tvit.dropout(x, 0.25, True, None)


def test_model_train_mode_draws_from_the_generator():
    """With drop-path, dropout and fc dropout on, train() output depends on
    the generator's draws alone; eval() output does not draw."""
    kw = dict(num_classes=5, num_scene_classes=4, num_latents=2, agg_depth=2, depth=2, embed_dim=64, num_heads=4,
              drop_rate=0.1, drop_path_rate=0.2, fc_drop_rate=0.3)
    tm = create_model("slot_vit_base_patch16_224", device="cpu", img_size=32, **kw)
    x = torch.from_numpy(np.random.default_rng(4).normal(size=(2, 4, 32, 32, 3)).astype(np.float32))
    with torch.no_grad():
        ev = tm(x)["slots_head"]
        tm.train()
        a = tm(x, generator=torch.Generator().manual_seed(1))["slots_head"]
        b = tm(x, generator=torch.Generator().manual_seed(1))["slots_head"]
        c = tm(x, generator=torch.Generator().manual_seed(2))["slots_head"]
        tm.eval()
        ev2 = tm(x)["slots_head"]
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    torch.testing.assert_close(ev, ev2, rtol=0, atol=0)
    assert not torch.equal(a, c) and not torch.equal(a, ev)
