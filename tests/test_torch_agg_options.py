"""The aggregation block's fields and `nn/pos_encoding.py` of the port
against the JAX package's, in float32 (context [2, 9, 64]):

- one case per field: non-default `heads`/`dim_head`/`ff_mult` tied and
  untied, `last_ln=False`, `pos_enc_type='sine1d'`, and both dropouts in
  training with the JAX masks (captured with
  `flax.linen.intercept_methods`) handed to the port's draws: slots, the
  last round's P and the gradients of a fixed weighting of them (every
  parameter and the context), the weights carried by
  `ckpt/from_jax.py::agg_from_jax` (`strict=True`); the 'sine2d'
  refusal;
- `sine_1d` and `sine_2d` bitwise, `build_position_encoding`, and
  `Learned1D`/`Learned2D` with JAX's weights carried
  (`learned_pos_from_jax`), bitwise.

Tolerances: outputs within 1e-5 and gradients within 1e-4 of the largest
magnitude, as `tests/test_torch_grads.py` holds them."""

import sys
from pathlib import Path

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from devias_tpu.nn import pos_encoding as jpe
from devias_tpu.nn.agg import AggregationBlock as JaxAggregationBlock
from devias_tpu_torch.ckpt.from_jax import agg_from_jax, learned_pos_from_jax
from devias_tpu_torch.nn import pos_encoding as tpe
from devias_tpu_torch.nn import vit as tvit
from devias_tpu_torch.nn.agg import AggregationBlock

sys.path.insert(0, str(Path(__file__).resolve().parent))
from _torch_options import GRAD_TOL, OUT_TOL, check_grads, close, t  # noqa: E402

B, N, D, S = 2, 9, 64, 2
GEOMETRY = dict(heads=8, dim_head=16, ff_mult=2)
CASES = {
    "geometry_tied": dict(depth=3, weight_tie=True, **GEOMETRY),
    "geometry_untied": dict(depth=3, weight_tie=False, **GEOMETRY),
    "no_last_ln": dict(depth=2, weight_tie=True, last_ln=False),
    "sine1d": dict(depth=2, weight_tie=True, pos_enc_type="sine1d"),
    "dropouts": dict(depth=3, weight_tie=True, attn_dropout=0.2, ff_dropout=0.3),
}


def _masks_of(fn):
    """`fn()` under flax's method interceptor: its value and the keep masks
    of every `nn.Dropout` with a rate > 0 that draws, in call order."""
    masks = []

    def grab(next_fun, args, kwargs, context):
        out = next_fun(*args, **kwargs)
        if isinstance(context.module, fnn.Dropout) and context.method_name == "__call__" \
                and context.module.rate > 0 and not kwargs.get("deterministic", True):
            masks.append(torch.from_numpy(np.asarray(out) != 0))
        return out

    with fnn.intercept_methods(grab):
        value = fn()
    return value, masks


@pytest.mark.parametrize("case", sorted(CASES))
def test_agg_field_matches_jax(monkeypatch, case):
    kw = CASES[case]
    training = case == "dropouts"
    seed = sorted(CASES).index(case)
    rng = np.random.default_rng(seed)
    ctx = rng.normal(size=(B, N, D)).astype(np.float32)
    heads = kw.get("heads", 4)
    w_slots, w_P = (rng.normal(size=s).astype(np.float32) for s in ((B, S, D), (B, heads, S, N)))
    jm = JaxAggregationBlock(num_latents=S, latent_dim=D, **kw)
    p = jm.init({"params": jax.random.PRNGKey(seed)}, jnp.asarray(ctx))["params"]
    p = jax.tree.map(lambda a: np.asarray(a) + 0.1 * rng.normal(size=a.shape).astype(np.float32), p)
    rngs = {"dropout": jax.random.PRNGKey(seed + 50)}

    def loss(p, c):
        slots, P = jm.apply({"params": p}, c, deterministic=not training, rngs=rngs)
        return (slots * w_slots).sum() + (P * w_P).sum(), (slots, P)

    (_, (want_slots, want_P)), masks = _masks_of(lambda: loss(p, jnp.asarray(ctx)))
    assert len(masks) == (2 * kw["depth"] if training else 0)
    gp, gc = jax.grad(lambda p, c: loss(p, c)[0], argnums=(0, 1))(p, jnp.asarray(ctx))  # the same draws

    tm = AggregationBlock(num_latents=S, latent_dim=D, **kw)
    sd, gsd = {}, {}
    agg_from_jax(sd, p, kw["depth"], prefix="")
    agg_from_jax(gsd, jax.tree.map(np.asarray, gp), kw["depth"], prefix="")
    tm.load_state_dict({k: t(v) for k, v in sd.items()}, strict=True)
    queue = list(masks)

    def keep_mask(shape, keep, generator, device):
        mask = queue.pop(0)
        assert tuple(mask.shape) == tuple(shape), (mask.shape, shape)
        return mask

    monkeypatch.setattr(tvit, "_keep_mask", keep_mask)
    tm.train(training)
    ct = t(ctx).requires_grad_()
    slots, P = tm(ct, torch.Generator())
    assert not queue
    close(slots.detach().numpy(), want_slots, "slots", OUT_TOL)
    close(P.detach().numpy(), want_P, "P", OUT_TOL)
    ((slots * t(w_slots)).sum() + (P * t(w_P)).sum()).backward()
    close(ct.grad.numpy(), gc, "context", GRAD_TOL)
    check_grads(tm, gsd)
    if case == "no_last_ln":
        assert tm.last_layer is None and not any(k.startswith("last_layer") for k in tm.state_dict())


def test_dropouts_draw_only_in_training():
    """In eval the two dropouts are the identity: the output of the same
    weights at rate 0, bitwise, and nothing drawn."""
    ctx = torch.randn(B, N, D, generator=torch.Generator().manual_seed(0))
    tm = AggregationBlock(num_latents=S, latent_dim=D, depth=2, attn_dropout=0.5, ff_dropout=0.5).eval()
    plain = AggregationBlock(num_latents=S, latent_dim=D, depth=2).eval()
    plain.load_state_dict(tm.state_dict())
    g = torch.Generator().manual_seed(1)
    state = g.get_state()
    with torch.no_grad():
        assert all(torch.equal(a, b) for a, b in zip(tm(ctx, g), plain(ctx)))
    assert torch.equal(g.get_state(), state)


def test_sine2d_through_the_block_raises():
    ctx = np.zeros((B, N, D), np.float32)
    jm = JaxAggregationBlock(num_latents=S, latent_dim=D, depth=1, pos_enc_type="sine2d")
    with pytest.raises(AssertionError):
        jm.init({"params": jax.random.PRNGKey(0)}, jnp.asarray(ctx))
    with pytest.raises(ValueError, match="sine2d"):
        AggregationBlock(num_latents=S, latent_dim=D, depth=1, pos_enc_type="sine2d")(t(ctx))


@pytest.mark.parametrize("kw", [dict(), dict(temperature=100.0), dict(normalize=False), dict(scale=1.5)],
                         ids=["default", "temperature", "unnormalized", "scale"])
def test_sine_tables_are_bitwise_jax(kw):
    for n, dim in ((1, 2), (9, 64), (1568, 768), (7, 10)):
        a, b = tpe.sine_1d(n, dim, **kw), jpe.sine_1d(n, dim, **kw)
        assert a.dtype == b.dtype == np.float32 and np.array_equal(a, b), (n, dim)
    for h, w, dim in ((1, 1, 4), (14, 14, 768), (3, 5, 64)):
        a, b = tpe.sine_2d(h, w, dim, **kw), jpe.sine_2d(h, w, dim, **kw)
        assert a.dtype == b.dtype == np.float32 and np.array_equal(a, b), (h, w, dim)


def test_build_position_encoding_matches_jax():
    for kind in ("none", "", None):
        assert tpe.build_position_encoding(kind, 9, 64) is None and jpe.build_position_encoding(kind, 9, 64) is None
    got = tpe.build_position_encoding("sine1d", 9, 64, dtype=torch.float64)
    assert got.dtype == torch.float64 and got.device.type == "cpu"
    assert torch.equal(got, torch.from_numpy(np.array(jpe.build_position_encoding("sine1d", 9, 64))).double())
    got = tpe.build_position_encoding("sine2d", 12, 64, hw=(3, 4))
    assert np.array_equal(got.numpy(), np.asarray(jpe.build_position_encoding("sine2d", 12, 64, hw=(3, 4))))
    with pytest.raises(ValueError, match="unknown"):
        jpe.build_position_encoding("learned", 9, 64)
    with pytest.raises(ValueError, match="unknown"):
        tpe.build_position_encoding("learned", 9, 64)


def test_learned_tables_carry_jax_weights():
    j1, j2 = jpe.Learned1D(max_len=32), jpe.Learned2D(max_hw=8)
    p1 = j1.init(jax.random.PRNGKey(0), 5, 16)["params"]
    p2 = j2.init(jax.random.PRNGKey(1), 3, 4, 16)["params"]
    t1, t2 = tpe.Learned1D(16, max_len=32), tpe.Learned2D(16, max_hw=8)
    for module, params in ((t1, p1), (t2, p2)):
        module.load_state_dict({k: torch.from_numpy(v) for k, v in learned_pos_from_jax(params).items()},
                               strict=True)
    assert np.array_equal(t1(5).detach().numpy(), np.asarray(j1.apply({"params": p1}, 5, 16)))
    assert np.array_equal(t2(3, 4).detach().numpy(), np.asarray(j2.apply({"params": p2}, 3, 4, 16)))
    # the port's own draw: U(0, 1) from an explicit generator
    tvit.init_weights(t2, torch.Generator().manual_seed(2))
    table = t2(8, 8).detach()
    assert table.shape == (64, 16) and 0.0 <= float(table.min()) and float(table.max()) < 1.0
    again = tpe.Learned2D(16, max_hw=8)
    tvit.init_weights(again, torch.Generator().manual_seed(2))
    assert torch.equal(again(8, 8), table)
