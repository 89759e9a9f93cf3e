"""The port's optimizers other than AdamW against the optax chains of
`devias_tpu/train/optim.py` (`make_optimizer`, `--opt adam|sgd|nesterov|
momentum`), on the slot model's parameter tree at a small size (depth 2,
width 64): two updates from the same parameters and gradients, with and
without `clip_grad`, under layer decay, the agg scale, a warmup and a
scheduled weight decay. Parameters hold to 1e-5 relative and the returned
pre-clip gradient norm to 1e-5 relative. optax rounds Adam's bias
corrections to float32 (1 - 0.999 is 1.3e-5 off there); the port keeps
them in float64, as torch.optim.Adam does, so an Adam update differs by
up to ~6e-6 of its size: at lr 1e-3 that stays within the tolerance on
parameters of O(0.05). Adam also divides each gradient by its own size:
where the L2 term cancels a gradient to rounding level (g + wd p of 2e-8
from terms of 1e-3), the two frameworks' global norms, equal to 1e-7,
give updates that differ by a good part of the lr. So under `adam` an
element may leave the tolerance if it stays within the summed lr of the
steps (Adam's per-element step bound), and such elements must be under
0.01 % of the parameters, as `tests/test_torch_train.py` holds the AdamW
trajectory. Also: the optimizers' state dicts resume an update exactly."""

import jax
import numpy as np
import optax
import pytest
import torch

from devias_tpu.nn import create_model as jax_create_model
from devias_tpu.train import OptimConfig as JaxOptimConfig
from devias_tpu.train import make_optimizer as jax_make_optimizer
from devias_tpu_torch.ckpt.from_jax import load_jax_params, state_dict_from_jax
from devias_tpu_torch.nn import create_model
from devias_tpu_torch.train import FusedAdamW, FusedSGD, OptimConfig, make_optimizer

SMALL = dict(depth=2, embed_dim=64, num_heads=4)
SLOT = dict(num_classes=5, num_scene_classes=4, num_latents=2, agg_depth=2, **SMALL)
OPT = dict(lr=1e-3, min_lr=1e-5, warmup_lr=1e-4, total_steps=8, warmup_steps=1, layer_decay=0.75,
           agg_block_scale=0.1, weight_decay=0.05, weight_decay_end=0.1, num_layers=2, momentum=0.8)


def _params():
    x = jax.numpy.zeros((2, 4, 32, 32, 3))
    params = jax_create_model("slot_vit_base_patch16_224", **SLOT).init({"params": jax.random.PRNGKey(0)}, x)["params"]
    rng = np.random.default_rng(0)
    return jax.tree.map(lambda a: np.asarray(a) + 0.05 * rng.normal(size=a.shape).astype(np.float32), params)


@pytest.mark.parametrize("clip_grad", [None, 0.5])
@pytest.mark.parametrize("opt", ["sgd", "nesterov", "momentum", "adam"])
def test_chain_matches_optax(opt, clip_grad):
    params = _params()
    cfg = dict(OPT, opt=opt, clip_grad=clip_grad)
    tx, _ = jax_make_optimizer(params, JaxOptimConfig(**cfg))
    opt_state = tx.init(params)
    model = load_jax_params(create_model("slot_vit_base_patch16_224", device="cpu", img_size=32, **SLOT), params,
                            "slot")
    optimizer, _ = make_optimizer(model, OptimConfig(**cfg), device="cpu")
    assert isinstance(optimizer, FusedAdamW if opt == "adam" else FusedSGD)
    rng = np.random.default_rng(1)
    p_j = params
    norms, lr_sum = [], 0.0
    for _ in range(2):
        grads = jax.tree.map(lambda a: rng.normal(size=a.shape).astype(np.float32) * 0.02, params)
        want_norm = float(optax.global_norm(grads))
        upd, opt_state = tx.update(grads, opt_state, p_j)
        p_j = optax.apply_updates(p_j, upd)
        sd_g = state_dict_from_jax(grads, "slot", SLOT["agg_depth"])
        for name, p in model.named_parameters():
            p.grad = torch.from_numpy(np.ascontiguousarray(sd_g[name]))
        grads_before = {n: p.grad.clone() for n, p in model.named_parameters()}
        lr_sum += optimizer.lr_fn(optimizer.count)
        norm = optimizer.step()
        np.testing.assert_allclose(norm.item(), want_norm, rtol=1e-5)
        norms.append(want_norm)
        for n, p in model.named_parameters():  # the update leaves .grad as it was
            torch.testing.assert_close(p.grad, grads_before[n], rtol=0, atol=0)
    if clip_grad is not None:
        assert max(norms) > clip_grad  # the clip is exercised
    want = state_dict_from_jax(jax.tree.map(np.asarray, p_j), "slot", SLOT["agg_depth"])
    off_count = total = 0
    for name, p in model.named_parameters():
        got = p.detach().numpy()
        if opt != "adam":
            np.testing.assert_allclose(got, want[name], rtol=1e-5, atol=1e-7, err_msg=name)
            continue
        diff = np.abs(got - want[name])
        off = diff > 1e-7 + 1e-5 * np.abs(want[name])
        assert diff[off].max(initial=0) <= lr_sum, name
        off_count, total = off_count + off.sum(), total + off.size
    assert off_count <= 1e-4 * max(total, 1), off_count


@pytest.mark.parametrize("opt", ["sgd", "momentum", "adam", "adamw"])
def test_state_dict_resumes_an_update_exactly(opt):
    """Two updates in one optimizer equal one update, a state-dict round
    trip into a fresh optimizer on a copy of the model, and the second."""
    cfg = OptimConfig(**dict(OPT, opt=opt))

    def model_and_opt():
        m = create_model("slot_vit_base_patch16_224", device="cpu", img_size=32, **SLOT)
        return m, make_optimizer(m, cfg, device="cpu")[0]

    def set_grads(m, seed):
        g = torch.Generator().manual_seed(seed)
        for p in m.parameters():
            p.grad = torch.randn(p.shape, generator=g) * 0.01

    a, opt_a = model_and_opt()
    b, opt_b = model_and_opt()
    for seed in (1, 2):
        set_grads(a, seed)
        opt_a.step()
    set_grads(b, 1)
    opt_b.step()
    c, opt_c = model_and_opt()
    c.load_state_dict(b.state_dict())
    opt_c.load_state_dict(opt_b.state_dict())
    assert opt_c.count == 1
    set_grads(c, 2)
    opt_c.step()
    for (n, p), q in zip(a.named_parameters(), c.parameters()):
        torch.testing.assert_close(p, q, rtol=0, atol=0, msg=n)
