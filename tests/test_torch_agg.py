"""The port's AggregationBlock against the flax one, tied and untied, on
the same weights and context (numpy, from a seed), in float32. The slots
and the last round's pre-renorm map P hold to 1e-4: eight rounds of
float32 rounding in another summation order."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from devias_tpu.nn.agg import AggregationBlock as JaxAggregationBlock
from devias_tpu_torch.ckpt.from_jax import agg_from_jax
from devias_tpu_torch.nn.agg import AggregationBlock


@pytest.mark.parametrize("weight_tie,depth", [(True, 8), (False, 3)])
def test_aggregation_block_matches(weight_tie, depth):
    rng = np.random.default_rng(depth)
    B, N, D = 2, 9, 64
    context = rng.normal(size=(B, N, D)).astype(np.float32)
    jm = JaxAggregationBlock(num_latents=2, latent_dim=D, depth=depth, weight_tie=weight_tie)
    params = jm.init({"params": jax.random.PRNGKey(depth)}, jnp.asarray(context))["params"]
    # non-trivial LayerNorm parameters, so a swapped norm would show
    params = jax.tree_util.tree_map_with_path(
        lambda path, a: a + 0.1 * rng.normal(size=a.shape).astype(np.float32)
        if "norm" in jax.tree_util.keystr(path) else a, params)
    slots_j, P_j = jm.apply({"params": params}, jnp.asarray(context))

    tm = AggregationBlock(num_latents=2, latent_dim=D, depth=depth, weight_tie=weight_tie)
    sd = {}
    agg_from_jax(sd, params, depth, prefix="")
    tm.load_state_dict({k: torch.from_numpy(np.asarray(v, np.float32)) for k, v in sd.items()}, strict=True)
    with torch.no_grad():
        slots_t, P_t = tm(torch.from_numpy(context))
    assert P_t.shape == (B, 4, 2, N) and P_t.dtype == torch.float32
    np.testing.assert_allclose(slots_t.numpy(), np.asarray(slots_j), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(P_t.numpy(), np.asarray(P_j), rtol=1e-4, atol=1e-5)


def test_tied_block_registers_one_layer_at_every_index():
    tm = AggregationBlock(num_latents=2, latent_dim=32, depth=4, weight_tie=True)
    assert all(tm.layers[i] is tm.layers[0] for i in range(4))
    keys = tm.state_dict().keys()
    assert {f"layers.{i}.0.fn.to_q.weight" for i in range(4)} <= set(keys)
    untied = AggregationBlock(num_latents=2, latent_dim=32, depth=4, weight_tie=False)
    layer = sum(p.numel() for p in tm.layers[0].parameters())
    assert sum(p.numel() for p in untied.parameters()) == sum(p.numel() for p in tm.parameters()) + 3 * layer
