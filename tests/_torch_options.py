"""Helpers of `tests/test_torch_backbone_options.py` and
`tests/test_torch_backbone_options_downstream.py`, not a test: the tiny
models of the four registry kinds, and one option's check of the port's
model against the JAX package's (outputs within 1e-5 and every gradient
within 1e-4 of the largest magnitude, as `tests/test_torch_grads.py`
holds them)."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from devias_tpu.nn import create_model as jax_create_model
from devias_tpu_torch.ckpt.from_jax import load_jax_params, state_dict_from_jax
from devias_tpu_torch.nn import create_model

TINY = dict(depth=2, embed_dim=64, num_heads=4)
CLIPS = (2, 4, 32, 32, 3)
OUT_TOL, GRAD_TOL = 1e-5, 1e-4
MODELS = {
    "slot": ("slot_vit_base_patch16_224", dict(num_classes=5, num_scene_classes=3, num_latents=2, agg_depth=2)),
    "plain": ("vit_base_patch16_224", dict(num_classes=5)),
    "multi_task": ("disentangle_vit_base_patch16_224", dict(num_classes=5, num_scene_classes=3)),
    "slot_fusion": ("slot_fusion_vit_base_patch16_224",
                    dict(num_classes=5, num_scene_classes=3, downstream_nb_classes=4, num_latents=2, agg_depth=2)),
}
OPTIONS = {
    "init_values": dict(init_values=0.1),
    "patch8": dict(patch_size=8),
    "patch32": dict(patch_size=32),
    "mlp_ratio": dict(mlp_ratio=2.0),
    "no_qkv_bias": dict(qkv_bias=False),
    "learnable_pos": dict(use_learnable_pos_emb=True),
}


def t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def close(got, want, name, tol, floor=0.0):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= tol * max(np.abs(want).max(), floor), (name, err)


def check_grads(module, grads_sd):
    named = list(module.named_parameters())
    assert set(grads_sd) >= {n for n, _ in named}
    floor = 1e-3 * max(np.abs(np.asarray(grads_sd[n])).max() for n, _ in named)
    for name, p in named:
        if p.grad is None:  # the fusion model's selection head feeds only an argmax
            assert not np.any(grads_sd[name]), name
            continue
        close(p.grad.numpy(), grads_sd[name], name, GRAD_TOL, floor)


def jitter(params, seed, scale=0.05):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: np.asarray(a) + scale * rng.normal(size=a.shape).astype(np.float32), params)


def _float_outputs(out):
    return {k: v for k, v in out.items() if jnp.issubdtype(jnp.asarray(v).dtype, jnp.floating)}


def _loss(out, weights, lib):
    return sum((out[k] * (w if lib is jnp else t(w))).sum() for k, w in weights.items())


def check_option(kind: str, option: str) -> None:
    """The model of `kind` built with `OPTIONS[option]` in both packages,
    the port's loaded from JAX's weights: outputs and gradients."""
    name, head_kw = MODELS[kind]
    kw = dict(TINY, **head_kw, **OPTIONS[option])
    seed = sorted(MODELS).index(kind) * 10 + sorted(OPTIONS).index(option)
    x = np.random.default_rng(seed).normal(size=CLIPS).astype(np.float32)
    jm = jax_create_model(name, **kw)
    params = jitter(jax.jit(jm.init)({"params": jax.random.PRNGKey(seed)}, jnp.asarray(x))["params"], seed)
    tm = create_model(name, device="cpu", img_size=32, num_frames=4, **kw)
    load_jax_params(tm, params, kind)

    shapes = jax.eval_shape(lambda: _float_outputs(jm.apply({"params": params}, jnp.asarray(x))))
    rng = np.random.default_rng(seed + 100)
    weights = {k: rng.normal(size=v.shape).astype(np.float32) for k, v in sorted(shapes.items())}

    def loss(p):
        out = _float_outputs(jm.apply({"params": p}, jnp.asarray(x)))
        return _loss(out, weights, jnp), out

    (_, want), gp = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    got = tm(t(x))
    for k, v in want.items():
        close(got[k].detach().numpy(), v, k, OUT_TOL)
    _loss(got, weights, torch).backward()
    agg_depth = head_kw.get("agg_depth", 0)
    check_grads(tm, state_dict_from_jax(jax.tree.map(np.asarray, gp), kind, agg_depth, kw.get("patch_size", 16)))
    if option == "init_values":
        assert tm.blocks[1].gamma_2.shape == (64,)
    if option == "no_qkv_bias":
        assert tm.blocks[0].attn.q_bias is None
