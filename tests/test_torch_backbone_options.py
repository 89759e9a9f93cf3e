"""The backbone options of the port against the JAX package's, in float32
at a small size (width 64, 4 heads, depth 2, 2 x 4 x 32 x 32 clips):

- the slot and plain ViTs, one case per option they take: LayerScale
  (`init_values`), `patch_size` 8 and 32, `mlp_ratio`, `qkv_bias=False`
  and the learnable position embedding: the model's outputs and every
  parameter's gradient of a fixed random weighting of them, after
  `ckpt/from_jax.py` carried JAX's weights (`strict=True`;
  `tests/_torch_options.py::check_option`); the multi-task and
  slot-fusion models in `tests/test_torch_backbone_options_downstream.py`;
- `qk_scale` and `norm_eps` on `VideoViT`, whose fields they are in JAX,
  the port's blocks with K1 requested (its plain version here, through the
  q prescale a scale that is not a power of two takes).

Tolerances: outputs within 1e-5 and gradients within 1e-4 of the largest
magnitude, as `tests/test_torch_grads.py` holds them."""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from devias_tpu.nn import vit as jvit
from devias_tpu_torch.ckpt.from_jax import backbone_from_jax
from devias_tpu_torch.nn import vit as tvit

sys.path.insert(0, str(Path(__file__).resolve().parent))
from _torch_options import CLIPS, OPTIONS, OUT_TOL, TINY, check_grads, check_option, close, jitter, t  # noqa: E402


@pytest.mark.parametrize("option", sorted(OPTIONS))
@pytest.mark.parametrize("kind", ["slot", "plain"])
def test_option_forward_and_grads_match_jax(kind, option):
    check_option(kind, option)


@pytest.mark.parametrize("kw", [dict(qk_scale=0.1), dict(norm_eps=1e-5), dict(qk_scale=0.1, norm_eps=1e-3)],
                         ids=["qk_scale", "norm_eps", "both"])
def test_video_vit_scale_and_eps_match_jax(kw):
    """On `VideoViT`, whose fields these are in JAX; the port's blocks with
    K1 requested."""
    x = np.random.default_rng(7).normal(size=CLIPS).astype(np.float32)
    jm = jvit.VideoViT(**TINY, **kw)
    params = jitter(jax.jit(jm.init)({"params": jax.random.PRNGKey(7)}, jnp.asarray(x))["params"], 7)
    tm = tvit.VideoViT(**TINY, img_size=32, num_frames=4, fused_attention=True, **kw)
    sd = {}
    backbone_from_jax(sd, params)
    tm.load_state_dict({k: t(v) for k, v in sd.items()}, strict=True)
    w = np.random.default_rng(8).normal(size=(2, 8, 64)).astype(np.float32)
    want = jm.apply({"params": params}, jnp.asarray(x))
    got = tm(t(x))
    close(got.detach().numpy(), want, "tokens", OUT_TOL)
    gp = jax.grad(lambda p: (jm.apply({"params": p}, jnp.asarray(x)) * w).sum())(params)
    (got * t(w)).sum().backward()
    gsd = {}
    backbone_from_jax(gsd, jax.tree.map(np.asarray, gp))
    check_grads(tm, gsd)


def test_kernel_scale_prescales_q_only_off_powers_of_two():
    qkv = torch.randn(2, 5, 48)
    same, scale = tvit._kernel_scale(qkv, 0.25)
    assert same is qkv and scale == 0.25
    pre, one = tvit._kernel_scale(qkv, 0.1)
    assert one == 1.0 and torch.equal(pre[..., :16], qkv[..., :16] * 0.1) and torch.equal(pre[..., 16:], qkv[..., 16:])
