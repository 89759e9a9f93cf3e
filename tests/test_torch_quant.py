"""The port's w8a8 int8 path (`nn/quant.py`, `int8_dense`) against the JAX
package's `nn/quant.py`, on the CPU in float32.

- `int8_dot`: the int8 values and scales are the same rounding of the same
  float32 numbers and the int32 products are exact, so the dequantised
  product must equal JAX's bitwise; so must an `int8_dense` Linear, which
  quantises its frozen weight once.
- an `int8_dense` CLS teacher (width 64, 4 heads, depth 2) against JAX's
  on the same weights: the blocks' float32 parts (norms, attention) round
  in another order, which can move an activation across an int8 rounding
  boundary, so the logits are held to 1e-3 of their largest magnitude
  (they read 3.4e-7 of it on the CPU: float32 rounding, no activation
  across a boundary); and to the float32
  teacher as `tests/test_quant.py` holds JAX's: cosine >= 0.99 and
  |difference| < 0.15 of the largest logit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from devias_tpu.nn import create_model as jax_create_model
from devias_tpu.nn.quant import int8_dot as jax_int8_dot
from devias_tpu_torch.ckpt.from_jax import load_jax_params
from devias_tpu_torch.nn import create_model
from devias_tpu_torch.nn import vit as tvit
from devias_tpu_torch.nn.quant import int8_dot, quantize

TINY = dict(depth=2, embed_dim=64, num_heads=4)


@pytest.mark.parametrize("shape,n,dtype", [((4, 64, 96), 128, "float32"), ((37, 64), 24, "float32"),
                                           ((4, 64, 96), 128, "bfloat16")])
def test_int8_dot_bitwise(shape, n, dtype):
    """In float32, and on a bfloat16 activation, which the port quantises
    without casting it first (JAX casts it to float32)."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=shape).astype(np.float32)
    x[0, 0] = 0.0  # an all-zero row: its scale is the 1e-12 floor in both
    w = (rng.normal(size=(shape[-1], n)) * 0.05).astype(np.float32)
    want = np.asarray(jax_int8_dot(jnp.asarray(x).astype(dtype), jnp.asarray(w)))
    got = int8_dot(torch.from_numpy(x).to(getattr(torch, dtype)), torch.from_numpy(w.T.copy()))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_int8_linear_quantises_its_weight_once(monkeypatch):
    """An `int8_dense` Linear quantises its weight on the first call only,
    and again after a load changes it: each output equals `int8_dot` of the
    weight it then holds, plus the bias."""
    calls = []
    monkeypatch.setattr(tvit, "quantize", lambda *a: calls.append(None) or quantize(*a))
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(5, 32)).astype(np.float32))
    lin = tvit.Linear(32, 16, int8_dense=True)
    for step in range(2):
        sd = {"weight": torch.from_numpy(rng.normal(size=(16, 32)).astype(np.float32)),
              "bias": torch.from_numpy(rng.normal(size=16).astype(np.float32))}
        lin.load_state_dict(sd)
        with torch.no_grad():
            outs = [lin(x) for _ in range(2)]
        assert len(calls) == step + 1
        for out in outs:
            assert torch.equal(out, int8_dot(x, sd["weight"]) + sd["bias"])


def test_int8_teacher_matches_jax():
    x = np.random.default_rng(1).normal(size=(2, 4, 32, 32, 3)).astype(np.float32)
    kw = dict(num_classes=16, use_mean_pooling=False, **TINY)
    j8 = jax_create_model("vit_base_patch16_224", int8_dense=True, **kw)
    params = j8.init({"params": jax.random.PRNGKey(0)}, jnp.asarray(x))["params"]
    # a sharper head than the init's, so the logits have a spread
    params = dict(params, head=jax.tree.map(
        lambda a: np.random.default_rng(2).normal(size=a.shape).astype(np.float32) * 0.5, params["head"]))
    want = np.asarray(j8.apply({"params": params}, jnp.asarray(x))["logits"])
    t8 = load_jax_params(create_model("vit_base_patch16_224", device="cpu", int8_dense=True, **kw), params, "plain")
    t32 = load_jax_params(create_model("vit_base_patch16_224", device="cpu", **kw),
                          params, "plain")
    assert all(m.int8_dense for n, m in t8.named_modules() if n.endswith(("attn.qkv", "attn.proj", "fc1", "fc2")))
    assert not t8.head.int8_dense
    with torch.no_grad():
        got = t8(torch.from_numpy(x))["logits"].numpy()
        ref = t32(torch.from_numpy(x))["logits"].numpy()
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 1e-3 * scale, (np.abs(got - want).max(), scale)
    assert np.abs(got - ref).max() < 0.15 * np.abs(ref).max()
    cos = (got * ref).sum() / (np.linalg.norm(got) * np.linalg.norm(ref))
    assert cos >= 0.99, cos
