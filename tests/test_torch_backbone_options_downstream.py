"""The backbone options of the multi-task and slot-fusion models against
the JAX package's (`tests/_torch_options.py::check_option`, as
`tests/test_torch_backbone_options.py` holds the slot and plain ViTs), and
`Attention(return_attn=True)`: (out, probabilities) in eval with K1
requested, and in training with attention dropout, the JAX masks
(captured with `flax.linen.intercept_methods`) handed to the port's
draws; its refusal under sequence parallelism. Float32 at width 64, 4
heads, depth 2, 2 x 4 x 32 x 32 clips; outputs within 1e-5 and gradients
within 1e-4 of the largest magnitude."""

import functools
import sys
from pathlib import Path

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from devias_tpu.nn import vit as jvit
from devias_tpu_torch.core.dist import SPMesh
from devias_tpu_torch.nn import vit as tvit

sys.path.insert(0, str(Path(__file__).resolve().parent))
from _torch_options import GRAD_TOL, OPTIONS, OUT_TOL, check_grads, check_option, close, jitter, t  # noqa: E402


@pytest.mark.parametrize("option", sorted(OPTIONS))
@pytest.mark.parametrize("kind", ["multi_task", "slot_fusion"])
def test_option_forward_and_grads_match_jax(kind, option):
    check_option(kind, option)


def _capture_dropout_masks(fn):
    """`fn()` under flax's method interceptor: its value and the keep masks
    of every `nn.Dropout` with a rate > 0, in call order."""
    masks = []

    def grab(next_fun, args, kwargs, context):
        out = next_fun(*args, **kwargs)
        if isinstance(context.module, fnn.Dropout) and context.method_name == "__call__" and context.module.rate > 0:
            masks.append(torch.from_numpy(np.asarray(out) != 0))
        return out

    with fnn.intercept_methods(grab):
        value = fn()
    return value, masks


def _replay(masks):
    """A stand-in for `vit._keep_mask` that hands out `masks` in order."""
    queue = list(masks)

    def keep_mask(shape, keep, generator, device):
        mask = queue.pop(0)
        assert tuple(mask.shape) == tuple(shape), (mask.shape, shape)
        return mask

    return keep_mask, queue


def _attention_sd(tree):
    """A flax `Attention` tree (params or grads) in the port's layout."""
    return {"qkv.weight": np.asarray(tree["qkv_kernel"]).T, "q_bias": np.asarray(tree["q_bias"]),
            "v_bias": np.asarray(tree["v_bias"]), "proj.weight": np.asarray(tree["proj"]["kernel"]).T,
            "proj.bias": np.asarray(tree["proj"]["bias"])}


def _attention_pair(seed, attn_drop):
    x = np.random.default_rng(seed).normal(size=(2, 9, 64)).astype(np.float32)
    ja = jvit.Attention(num_heads=4, attn_drop=attn_drop)
    p = jitter(ja.init({"params": jax.random.PRNGKey(seed)}, jnp.asarray(x))["params"], seed)
    ta = tvit.Attention(64, 4, fused=True, attn_drop=attn_drop)
    ta.load_state_dict({k: t(v) for k, v in _attention_sd(p).items()}, strict=True)
    return x, ja, p, ta


@pytest.mark.parametrize("training", [False, True], ids=["eval", "train_with_dropout"])
def test_return_attn_matches_jax(monkeypatch, training):
    """`return_attn=True` takes the plain path though K1 is requested and
    returns the probabilities after their dropout (identity in eval)."""
    x, ja, p, ta = _attention_pair(11, 0.25)
    wo, wa = (np.random.default_rng(12).normal(size=s).astype(np.float32) for s in ((2, 9, 64), (2, 4, 9, 9)))
    rngs = {"dropout": jax.random.PRNGKey(13)}
    apply = functools.partial(ja.apply, deterministic=not training, return_attn=True, rngs=rngs)
    (want_o, want_a), masks = _capture_dropout_masks(lambda: apply({"params": p}, jnp.asarray(x)))
    assert len(masks) == 1 and bool(masks[0].all()) != training
    masks = masks if training else []  # in eval the dropout is the identity and draws nothing
    gp, gx = jax.grad(lambda p, x: sum((t * w).sum() for t, w in zip(apply({"params": p}, x), (wo, wa))),
                      argnums=(0, 1))(p, jnp.asarray(x))

    keep_mask, left = _replay(masks)
    monkeypatch.setattr(tvit, "_keep_mask", keep_mask)
    monkeypatch.setattr(tvit, "fused_attention_qkv", None)  # the plain path must not reach K1
    ta.train(training)
    xt = t(x).requires_grad_()
    out, attn = ta(xt, torch.Generator(), return_attn=True)
    assert not left
    close(out.detach().numpy(), want_o, "out", OUT_TOL)
    close(attn.detach().numpy(), want_a, "attn", OUT_TOL)
    ((out * t(wo)).sum() + (attn * t(wa)).sum()).backward()
    close(xt.grad.numpy(), gx, "x", GRAD_TOL)
    check_grads(ta, _attention_sd(gp))


def test_return_attn_under_sequence_parallelism_raises():
    attn = tvit.Attention(64, 4)
    seq = SPMesh(seq_group=None, seq_rank=0, seq_size=1)
    with pytest.raises(NotImplementedError, match="return_attn"):
        attn(torch.zeros(1, 8, 64), torch.Generator(), seq, return_attn=True)
