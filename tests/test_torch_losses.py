"""The port's slot matching and DEVIAS slot loss against the JAX package's,
on the same numpy inputs in float32: every loss term of both branches
('matching', 'hard_select') and both scene criteria (KL, CE), and the
gradients of the total with respect to the student's outputs. Terms hold to
1e-5 relative (float32 sums in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from devias_tpu.losses import SlotLossConfig as JaxSlotLossConfig
from devias_tpu.losses import devias_slot_loss as jax_devias_slot_loss
from devias_tpu.losses.matching import match_action_scene_slots as jax_match
from devias_tpu.losses.slot_loss import cosine_orthogonality_loss as jax_cosine
from devias_tpu.losses.slot_loss import pad_teacher_logits as jax_pad
from devias_tpu_torch.losses import (
    SlotLossConfig,
    cosine_orthogonality_loss,
    devias_slot_loss,
    match_action_scene_slots,
    pad_teacher_logits,
)

TOL = dict(rtol=1e-5, atol=1e-6)


def test_slot_loss_config_defaults_match():
    ours, theirs = SlotLossConfig(400), JaxSlotLossConfig(400)
    for f in ("num_scene_classes", "slot_matching_method", "scene_criterion", "scene_loss_weight",
              "mask_prediction_loss_weight", "mask_distill_loss_weight"):
        assert getattr(ours, f) == getattr(theirs, f), f
    assert (ours.scene_loss_weight, ours.mask_prediction_loss_weight, ours.mask_distill_loss_weight) == (4000, 3, 1)


@pytest.mark.parametrize("S", [2, 3, 5])
def test_matching_with_ties_matches(S):
    """Costs from a few levels, so equal pair totals are common: both take
    the first minimum of the flattened i * S + j order."""
    rng = np.random.default_rng(S)
    ca = rng.integers(0, 3, size=(64, S)).astype(np.float32) * 0.5
    cs = rng.integers(0, 3, size=(64, S)).astype(np.float32) * 0.5
    a_j, s_j = jax_match(jnp.asarray(ca), jnp.asarray(cs))
    a_t, s_t = match_action_scene_slots(torch.from_numpy(ca), torch.from_numpy(cs))
    np.testing.assert_array_equal(a_t.numpy(), np.asarray(a_j))
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
    assert (a_t != s_t).all()
    with pytest.raises(ValueError, match="2 slots"):
        match_action_scene_slots(torch.zeros(2, 1), torch.zeros(2, 1))


def _student(rng, B=4, S=2, A=5, Sc=4, D=16, heads=4, N=32, n_sp=16):
    return {
        "slots_head": rng.normal(size=(B, S, A + Sc)).astype(np.float32) * 2,
        "slots": rng.normal(size=(B, S, D)).astype(np.float32),
        "mask_predictions": rng.uniform(size=(B, S, n_sp)).astype(np.float32),
        "attn": rng.uniform(size=(B, heads, S, N)).astype(np.float32),
    }


@pytest.mark.parametrize("method,criterion", [("matching", "KL"), ("matching", "CE"), ("hard_select", "KL")])
def test_devias_slot_loss_matches(method, criterion):
    rng = np.random.default_rng(7)
    B, A, Sc = 4, 5, 4
    student = _student(rng, B=B, A=A, Sc=Sc)
    teacher = rng.normal(size=(B, Sc)).astype(np.float32) * 3
    labels = rng.integers(0, A, size=B)
    fg = rng.uniform(size=(B, 16)).astype(np.float32)
    fg_pf = rng.uniform(size=(B, 32)).astype(np.float32)
    kw = dict(num_scene_classes=Sc, slot_matching_method=method, scene_criterion=criterion)

    def jax_total(st):
        return jax_devias_slot_loss(st, jnp.asarray(teacher), jnp.asarray(labels), jnp.asarray(fg),
                                    jnp.asarray(fg_pf), JaxSlotLossConfig(A, **kw))

    total_j, logit_j, parts_j = jax_total({k: jnp.asarray(v) for k, v in student.items()})
    grads_j = jax.grad(lambda st: jax_total(st)[0])({k: jnp.asarray(v) for k, v in student.items()})

    st = {k: torch.from_numpy(v).requires_grad_() for k, v in student.items()}
    total, logit, parts = devias_slot_loss(st, torch.from_numpy(teacher), torch.from_numpy(labels),
                                           torch.from_numpy(fg), torch.from_numpy(fg_pf), SlotLossConfig(A, **kw))
    assert set(parts) == set(parts_j)
    for k in parts:
        np.testing.assert_allclose(parts[k].item(), float(parts_j[k]), err_msg=k, **TOL)
    np.testing.assert_allclose(total.item(), float(total_j), **TOL)
    np.testing.assert_allclose(logit.detach().numpy(), np.asarray(logit_j), **TOL)
    total.backward()
    for k in student:
        np.testing.assert_allclose(st[k].grad.numpy(), np.asarray(grads_j[k]), err_msg=k, rtol=1e-4, atol=1e-6)


def test_helpers_match():
    rng = np.random.default_rng(9)
    t = rng.normal(size=(3, 4)).astype(np.float32)
    np.testing.assert_array_equal(pad_teacher_logits(torch.from_numpy(t), 5).numpy(), np.asarray(jax_pad(jnp.asarray(t), 5)))
    s = rng.normal(size=(3, 4, 8)).astype(np.float32)
    s[0, 1] = 0.0  # a zero slot: the 1e-12 norm floor
    np.testing.assert_allclose(cosine_orthogonality_loss(torch.from_numpy(s)).item(),
                               float(jax_cosine(jnp.asarray(s))), **TOL)
