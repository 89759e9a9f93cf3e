"""The slot train step's input branches against the JAX step, and the EMA:
uint8 clips normalised in the step (`device_normalize`) and I420 planes
unpacked in the step (`wire_format="yuv420"`), each for one step with FAME
on the unit-range clips and a student built with `input_norm=True`, in
float32 at the small size of `test_torch_train.py`. Metrics hold to 2e-4
relative, as there."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from devias_tpu.aug.fame import FAMEConfig as JaxFAMEConfig
from devias_tpu.losses import SlotLossConfig as JaxSlotLossConfig
from devias_tpu.train import OptimConfig as JaxOptimConfig
from devias_tpu.train import TrainState as JaxTrainState
from devias_tpu.train import TrainStepConfig as JaxTrainStepConfig
from devias_tpu.train import make_optimizer as jax_make_optimizer
from devias_tpu.train import make_slot_train_step as jax_make_slot_train_step
from devias_tpu_torch.aug import FAMEConfig
from devias_tpu_torch.losses import SlotLossConfig
from devias_tpu_torch.train import OptimConfig, TrainState, TrainStepConfig, make_optimizer, make_slot_train_step
from test_torch_train import OPT, SLOT, TEACHER, _fame_draws, _jax_params, _port


@pytest.mark.parametrize("wire_format", ["rgb", "yuv420"])
def test_uint8_and_i420_branches_match_jax_step(wire_format):
    B, prob_aug = 2, 0.8
    kw = dict(SLOT, input_norm=True)
    jm, params = _jax_params("slot_vit_base_patch16_224", 8, **kw)
    jt, tparams = _jax_params("vit_base_patch16_224", 9, **dict(TEACHER, input_norm=True))
    tx, lr_fn = jax_make_optimizer(params, JaxOptimConfig(**OPT))
    fame = dict(beta=0.5, prob_aug=prob_aug)
    cfg = dict(update_freq=1, use_fame=True, device_normalize=True, wire_format=wire_format)
    jstep = jax.jit(jax_make_slot_train_step(jm, jt, tx, JaxSlotLossConfig(5, 4),
                                             JaxTrainStepConfig(fame=JaxFAMEConfig(**fame), **cfg), lr_fn))
    model = _port("slot_vit_base_patch16_224", "slot", params, **kw)
    teacher = _port("vit_base_patch16_224", "plain", tparams, **dict(TEACHER, input_norm=True))
    opt, t_lr_fn = make_optimizer(model, OptimConfig(**OPT), device="cpu")
    state = TrainState.create(model, opt, device="cpu")
    tstep = make_slot_train_step(model, teacher, opt, SlotLossConfig(5, 4),
                                 TrainStepConfig(fame=FAMEConfig(**fame), **cfg), t_lr_fn, device="cpu")

    data = np.random.default_rng(10)
    shape = (B, 4, 48, 32) if wire_format == "yuv420" else (B, 4, 32, 32, 3)
    batch = {"videos": data.integers(0, 256, size=shape, dtype=np.uint8), "labels": data.integers(0, 5, size=B)}
    key = jax.random.PRNGKey(11)
    _, want = jstep(JaxTrainState.create(params, tx), tparams, {k: jnp.asarray(v) for k, v in batch.items()}, key)
    got = tstep(state, batch, draws=_fame_draws(key, 0, 1, B, prob_aug)[0], host_metrics=True)
    for k in want:
        np.testing.assert_allclose(got[k], float(want[k]), rtol=2e-4, atol=1e-6, err_msg=k)


def test_ema_follows_the_parameters():
    model = _port("slot_vit_base_patch16_224", "slot", _jax_params("slot_vit_base_patch16_224", 12, **SLOT)[1],
                  **SLOT)
    teacher = _port("vit_base_patch16_224", "plain", _jax_params("vit_base_patch16_224", 13, **TEACHER)[1],
                    **TEACHER)
    opt, _ = make_optimizer(model, OptimConfig(**OPT), device="cpu")
    state = TrainState.create(model, opt, use_ema=True, ema_decay=0.9, device="cpu")
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    step = make_slot_train_step(model, teacher, opt, SlotLossConfig(5, 4), TrainStepConfig(use_fame=False),
                                device="cpu")
    data = np.random.default_rng(14)
    step(state, {"videos": data.normal(size=(2, 4, 32, 32, 3)).astype(np.float32),
                 "labels": data.integers(0, 5, size=2)})
    for n, p in model.named_parameters():
        torch.testing.assert_close(state.ema_params[n], 0.9 * before[n] + 0.1 * p.detach(), rtol=1e-6, atol=1e-7)
    assert any(not torch.equal(state.ema_params[n], before[n]) for n in before)
