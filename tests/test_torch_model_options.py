"""The model options of the port against the JAX package's, in float32 at
a small size (width 64, 4 heads, depth 2, 2 x 4 x 32 x 32 clips):

- attention-probability dropout: in training, the JAX masks (captured with
  `flax.linen.intercept_methods` on `nn.Dropout`) handed to the port's
  draws; in eval, K1's deterministic output; under sequence parallelism, a
  refusal;
- activation checkpointing (`remat`): gradients against JAX's `remat=True`
  in the deterministic mode; then the port with it against the port
  without it, with dropout, attention dropout and drop-path at 0.1 from one
  generator: bitwise equal gradients and generator states after the step
  (a plain `torch.utils.checkpoint` of the block fails both, which the test
  shows), also over a second backward of the same graph.

Tolerances: outputs within 1e-5 and gradients within 1e-4 of the largest
magnitude (float32 rounding of the same math in another order, the JAX
side's hand-written VJPs against autograd), as `tests/test_torch_grads.py`
holds them; the checkpointing comparison within the port is exact."""

import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from devias_tpu.nn import create_model as jax_create_model
from devias_tpu.nn import vit as jvit
from devias_tpu_torch.ckpt.from_jax import backbone_from_jax, load_jax_params, state_dict_from_jax
from devias_tpu_torch.core.dist import SPMesh
from devias_tpu_torch.nn import create_model
from devias_tpu_torch.nn import vit as tvit

TINY = dict(depth=2, embed_dim=64, num_heads=4)
SLOT = dict(num_classes=5, num_scene_classes=3, num_latents=2, agg_depth=2)
CLIPS = (2, 4, 32, 32, 3)
OUT_TOL, GRAD_TOL = 1e-5, 1e-4


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _close(got, want, name, tol, floor=0.0):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, name
    err = np.abs(got - want).max()
    assert err <= tol * max(np.abs(want).max(), floor), (name, err)


def _check_grads(module, grads_sd):
    """Every parameter's gradient against the JAX gradient in the port's
    layout, within GRAD_TOL of its largest magnitude (or of 1e-3 of the
    module's largest gradient, for exactly-zero true gradients)."""
    named = list(module.named_parameters())
    floor = 1e-3 * max(np.abs(np.asarray(grads_sd[n])).max() for n, _ in named)
    for name, p in named:
        assert p.grad is not None, name
        _close(p.grad.numpy(), grads_sd[name], name, GRAD_TOL, floor)


def _jitter(params, seed, scale=0.05):
    """The init's params plus noise: biases and LayerNorms away from their
    constant starting values."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: np.asarray(a) + scale * rng.normal(size=a.shape).astype(np.float32), params)


def _clips(seed):
    return np.random.default_rng(seed).normal(size=CLIPS).astype(np.float32)


def _slot_pair(seed, **kw):
    """A JAX slot model with jittered params and the port's model loaded
    from them (in eval mode)."""
    x = _clips(seed)
    jm = jax_create_model("slot_vit_base_patch16_224", **SLOT, **TINY, **kw)
    params = _jitter(jm.init({"params": jax.random.PRNGKey(seed)}, jnp.asarray(x))["params"], seed)
    tm = create_model("slot_vit_base_patch16_224", device="cpu", img_size=32, **SLOT, **TINY, **kw)
    load_jax_params(tm, params, "slot")
    return jm, params, tm, x


# a fixed random weighting of the slot model's outputs as the loss
LOSS_SHAPES = {"slots_head": (2, 2, 8), "slots": (2, 2, 64), "mask_predictions": (2, 2, 4)}


def _slot_loss(out, seed, lib):
    rng = np.random.default_rng(seed + 100)
    weights = {k: rng.normal(size=shape).astype(np.float32) for k, shape in LOSS_SHAPES.items()}
    return sum((out[k] * (w if lib is jnp else _t(w))).sum() for k, w in weights.items())


def _grads_vs_jax(jm, params, tm, x, seed):
    gp = jax.grad(lambda p: _slot_loss(jm.apply({"params": p}, jnp.asarray(x)), seed, jnp))(params)
    _slot_loss(tm(_t(x)), seed, torch).backward()
    _check_grads(tm, state_dict_from_jax(jax.tree.map(np.asarray, gp), "slot", 2))


# ---------------------------------------------------------------- attention dropout


def _capture_dropout_masks(fn):
    """Run `fn()` under flax's method interceptor; returns its value and
    the keep masks of every `nn.Dropout` with a rate > 0, in call order."""
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


def _block_sd(tree):
    """A block's flax tree (params or grads) in the port's Block layout."""
    sd = {}
    backbone_from_jax(sd, {"patch_embed": {"kernel": np.zeros((1536, 64), np.float32),
                                           "bias": np.zeros(64, np.float32)}, "blocks_0": tree})
    return {k[len("blocks.0."):]: v for k, v in sd.items() if k.startswith("blocks.0.")}


def _block_pair(seed, attn_drop):
    x = np.random.default_rng(seed).normal(size=(2, 9, 64)).astype(np.float32)
    jm = jvit.Block(num_heads=4, attn_drop=attn_drop, fused_attention=True, fused_interpret=True)
    p = _jitter(jm.init({"params": jax.random.PRNGKey(seed)}, jnp.asarray(x))["params"], seed)
    tm = tvit.Block(64, 4, fused_attention=True, attn_drop=attn_drop)
    tm.load_state_dict({k: _t(v) for k, v in _block_sd(p).items()}, strict=True)
    return jm, p, tm, x


def test_attention_dropout_in_training_matches_with_the_jax_masks(monkeypatch):
    """A training block at attn_drop 0.25 (fused requested: both packages
    then take the plain attention): the probabilities' dropout masks of the
    JAX call are the port's draws; outputs and gradients match."""
    jm, p, tm, x = _block_pair(3, 0.25)
    rngs = {"dropout": jax.random.PRNGKey(11), "drop_path": jax.random.PRNGKey(12)}
    w = np.random.default_rng(4).normal(size=x.shape).astype(np.float32)
    apply = functools.partial(jm.apply, deterministic=False, rngs=rngs)
    want, masks = _capture_dropout_masks(lambda: apply({"params": p}, jnp.asarray(x)))
    assert len(masks) == 1 and masks[0].shape == (2, 4, 9, 9) and 0 < masks[0].float().mean() < 1
    gp, gx = jax.grad(lambda p, x: (apply({"params": p}, x) * w).sum(), argnums=(0, 1))(p, jnp.asarray(x))

    keep_mask, left = _replay(masks)
    monkeypatch.setattr(tvit, "_keep_mask", keep_mask)
    tm.train()
    xt = _t(x).requires_grad_()
    got = tm(xt, torch.Generator())
    assert not left
    _close(got.detach().numpy(), want, "out", OUT_TOL)
    (got * _t(w)).sum().backward()
    _close(xt.grad.numpy(), gx, "x", GRAD_TOL)
    _check_grads(tm, _block_sd(jax.tree.map(np.asarray, gp)))


def test_attention_dropout_in_eval_is_the_deterministic_attention():
    """In eval the block keeps K1 (its plain version on the CPU): the JAX
    deterministic output, and bitwise the output of the same weights at
    attn_drop 0."""
    jm, p, tm, x = _block_pair(5, 0.25)
    want = jm.apply({"params": p}, jnp.asarray(x))
    no_drop = tvit.Block(64, 4, fused_attention=True)
    no_drop.load_state_dict(tm.state_dict())
    with torch.no_grad():
        got = tm.eval()(_t(x))
        assert torch.equal(got, no_drop.eval()(_t(x)))
    _close(got.numpy(), want, "out", OUT_TOL)


def test_attention_dropout_under_sequence_parallelism_raises():
    attn = tvit.Attention(64, 4, attn_drop=0.1)
    seq = SPMesh(seq_group=None, seq_rank=0, seq_size=1)
    with pytest.raises(NotImplementedError, match="sequence parallelism"):
        attn(torch.zeros(1, 8, 64), torch.Generator(), seq)


# ---------------------------------------------------------------- checkpointing


def test_remat_grads_match_jax_remat(monkeypatch):
    """Deterministic mode (every rate 0): the port's checkpointed blocks
    against `jax.grad` of the JAX model with `remat=True`."""
    calls = []
    wrapped = tvit.checkpointed_block

    def counting(*args):
        calls.append(None)
        return wrapped(*args)

    monkeypatch.setattr(tvit, "checkpointed_block", counting)
    jm, params, tm, x = _slot_pair(6, remat=True)
    _grads_vs_jax(jm, params, tm.train(), x, 6)
    assert len(calls) == TINY["depth"]


def _naive_checkpoint(block, x, generator, path_generator, seq):
    return torch.utils.checkpoint.checkpoint(lambda h: block(h, generator, path_generator, seq), x,
                                             use_reentrant=False)


def _step_grads(model, x, seed):
    g = torch.Generator().manual_seed(seed)
    _slot_loss(model(_t(x), g), seed, torch).backward()
    return {n: p.grad.clone() for n, p in model.named_parameters()}, g.get_state()


def test_remat_keeps_the_draws_and_the_generator(monkeypatch):
    """Dropout, attention dropout and drop-path at 0.1 from one generator:
    the checkpointed step's gradients and the generator's state after it
    equal the plain step's bitwise. A plain `torch.utils.checkpoint` of the
    block redraws the masks in the recompute, so both differ."""
    kw = dict(drop_rate=0.1, attn_drop_rate=0.1, drop_path_rate=0.1)
    x = _clips(7)
    models = {remat: create_model("slot_vit_base_patch16_224", device="cpu", img_size=32, seed=7,
                                  remat=remat, **SLOT, **TINY, **kw).train() for remat in (False, True)}
    want, state = _step_grads(models[False], x, 8)
    got, got_state = _step_grads(models[True], x, 8)
    assert torch.equal(got_state, state)
    for name, grad in want.items():
        assert torch.equal(got[name], grad), name

    models[True].zero_grad()
    monkeypatch.setattr(tvit, "checkpointed_block", _naive_checkpoint)
    naive, naive_state = _step_grads(models[True], x, 8)
    assert not torch.equal(naive_state, state)
    assert any(not torch.equal(naive[n], g) for n, g in want.items())


def test_remat_second_backward_replays_the_same_draws():
    """A second backward of the same checkpointed graph recomputes again
    from the forward's draws (the replay context is reusable): the
    gradients double and the generator is where the forward left it."""
    x = _clips(9)
    model = create_model("slot_vit_base_patch16_224", device="cpu", img_size=32, seed=9, remat=True,
                         drop_rate=0.1, attn_drop_rate=0.1, drop_path_rate=0.1, **SLOT, **TINY).train()
    g = torch.Generator().manual_seed(10)
    loss = _slot_loss(model(_t(x), g), 10, torch)
    state = g.get_state()
    loss.backward(retain_graph=True)
    once = {n: p.grad.clone() for n, p in model.named_parameters()}
    loss.backward()
    assert torch.equal(g.get_state(), state)
    for name, p in model.named_parameters():
        assert torch.equal(p.grad, 2 * once[name]), name
