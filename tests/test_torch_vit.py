"""The port's ViT modules against their flax counterparts on the same
weights and inputs (numpy, from a seed), at a small size. float32
comparisons hold to 1e-5 per module and 1e-4 through a two-block backbone
(float32 rounding, sums in another order); the bf16 GELU case holds to
bf16 resolution."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from devias_tpu.nn import vit as jvit
from devias_tpu_torch.ckpt.from_jax import backbone_from_jax
from devias_tpu_torch.nn import vit as tvit

F32 = dict(rtol=1e-5, atol=1e-5)


def _t(x):
    return torch.from_numpy(np.asarray(x, dtype=np.float32).copy())


def _init(module, x, seed=0):
    return module.init({"params": jax.random.PRNGKey(seed)}, jnp.asarray(x))["params"]


def test_sinusoid_table_matches():
    np.testing.assert_array_equal(tvit.sinusoid_position_table(17, 24), jvit.sinusoid_position_table(17, 24))


def test_fast_layer_norm_matches():
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(2, 5, 64)) * 3 + 1).astype(np.float32)
    jm = jvit.FastLayerNorm(epsilon=1e-6)
    p = {"scale": rng.normal(size=64).astype(np.float32), "bias": rng.normal(size=64).astype(np.float32)}
    want = np.asarray(jm.apply({"params": p}, jnp.asarray(x)))
    tm = tvit.FastLayerNorm(64)
    tm.load_state_dict({"weight": _t(p["scale"]), "bias": _t(p["bias"])})
    got = tm(_t(x))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), want, **F32)


def test_fast_layer_norm_bf16_matches():
    """bf16 compute: the input is rounded to bf16, statistics, scale and
    bias stay float32, and the output is rounded to bf16 once, as in flax;
    held to one bf16 rounding of outputs up to ~10."""
    rng = np.random.default_rng(5)
    x = (rng.normal(size=(2, 5, 64)) * 3 + 1).astype(np.float32)
    jm = jvit.FastLayerNorm(dtype=jnp.bfloat16)
    p = {"scale": rng.normal(size=64).astype(np.float32), "bias": rng.normal(size=64).astype(np.float32)}
    want = jm.apply({"params": p}, jnp.asarray(x))
    assert want.dtype == jnp.bfloat16
    tm = tvit.FastLayerNorm(64, torch.bfloat16)
    tm.load_state_dict({"weight": _t(p["scale"]), "bias": _t(p["bias"])})
    got = tm(_t(x))
    assert got.dtype == torch.bfloat16 and tm.weight.dtype == torch.float32
    np.testing.assert_allclose(got.float().detach().numpy(), np.asarray(want.astype(jnp.float32)),
                               rtol=8e-3, atol=8e-3)


@pytest.mark.parametrize("dtype,tol", [("float32", F32), ("bfloat16", dict(rtol=2e-2, atol=2e-2))])
def test_mlp_matches(dtype, tol):
    """erf GELU in float32; the tanh form in bf16, held to bf16 resolution
    (both frameworks round the products to bf16 in their own order)."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 5, 64)).astype(np.float32)
    jm = jvit.Mlp(hidden_dim=256, out_dim=64, dtype=getattr(jnp, dtype))
    p = _init(jm, x)
    want = np.asarray(jm.apply({"params": p}, jnp.asarray(x)).astype(jnp.float32))
    tm = tvit.Mlp(64, 256, dtype=getattr(torch, dtype))
    assert tm.approx == (dtype == "bfloat16")
    tm.load_state_dict({
        "fc1.weight": _t(p["fc1"]["kernel"]).T, "fc1.bias": _t(p["fc1"]["bias"]),
        "fc2.weight": _t(p["fc2"]["kernel"]).T, "fc2.bias": _t(p["fc2"]["bias"]),
    })
    got = tm(_t(x)).float().detach().numpy()
    np.testing.assert_allclose(got, want, **tol)


@pytest.mark.parametrize("fused", [True, False])
def test_attention_matches(fused):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 9, 64)).astype(np.float32)
    jm = jvit.Attention(num_heads=4, fused=True, fused_interpret=True)
    p = _init(jm, x)
    p = dict(p, q_bias=rng.normal(size=64).astype(np.float32), v_bias=rng.normal(size=64).astype(np.float32))
    want = np.asarray(jm.apply({"params": p}, jnp.asarray(x)))
    tm = tvit.Attention(64, 4, fused=fused)
    tm.load_state_dict({
        "qkv.weight": _t(p["qkv_kernel"]).T, "q_bias": _t(p["q_bias"]), "v_bias": _t(p["v_bias"]),
        "proj.weight": _t(p["proj"]["kernel"]).T, "proj.bias": _t(p["proj"]["bias"]),
    })
    np.testing.assert_allclose(tm(_t(x)).detach().numpy(), want, **F32)


@pytest.mark.parametrize("use_cls_token,input_norm", [(False, False), (True, True)])
def test_video_vit_matches(use_cls_token, input_norm):
    rng = np.random.default_rng(3)
    x = rng.uniform(size=(2, 4, 32, 32, 3)).astype(np.float32)
    kw = dict(embed_dim=64, depth=2, num_heads=4, use_cls_token=use_cls_token, input_norm=input_norm)
    jm = jvit.VideoViT(fused_attention=True, fused_interpret=True, **kw)
    p = _init(jm, x)
    want = np.asarray(jm.apply({"params": p}, jnp.asarray(x)))
    tm = tvit.VideoViT(fused_attention=True, **kw)
    sd = {}
    backbone_from_jax(sd, p)
    tm.load_state_dict({k: _t(v) for k, v in sd.items()}, strict=True)
    with torch.no_grad():
        got = tm(_t(x)).numpy()
    assert got.shape == want.shape == (2, 8 + use_cls_token, 64)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_patch_embed_modes_are_one_map():
    rng = np.random.default_rng(4)
    x = _t(rng.normal(size=(1, 2, 32, 32, 3)))
    g = torch.Generator().manual_seed(0)
    outs = []
    for mode in (None, "conv", "patchify", "dot"):
        m = tvit.PatchEmbed3D(embed_dim=16, mode=mode)
        tvit.init_weights(m, g.manual_seed(0))
        outs.append(m(x))
    for o in outs[1:]:
        torch.testing.assert_close(o, outs[0], rtol=0, atol=0)
    with pytest.raises(ValueError, match="unknown patch-embed mode"):
        tvit.PatchEmbed3D(mode="conv2")
