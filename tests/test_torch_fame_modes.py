"""FAME's exact top-k selection and its downsampled per-pair mode in the
port against the JAX package's, on the same numpy clips in float32
(3 clips of 4 frames at 64x64: a static textured background and a moving
textured square, with noise; clip 0 keeps the lower third of every frame
static and noise-free, so its frame differences are exactly zero there
and the fg/bg selections and the binarisation meet large ties).

Tolerance: none on the masks. The exact mode picks the first n pixels of
a stable descending sort, which is `lax.top_k`'s order among ties, so the
binary masks, the pooled patch-grid targets and the mixed clips must be
bitwise equal. The downsampled mode (d = 2, 4, and d = 3, which does not
divide 64 and falls back to full resolution) is held the same way, alone
and with the exact selection. The bisections' selected fraction is held
bitwise to JAX's mean at 224 x 224."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _jax_draws import fame_draws_from_key
from devias_tpu.aug import fame as jfame
from devias_tpu_torch.aug import fame as tfame

MEAN, STD = np.array(tfame.IMAGENET_MEAN, np.float32), np.array(tfame.IMAGENET_STD, np.float32)
MODES = [
    dict(exact_topk=True),
    dict(tubelet_mask_downsample=2),
    dict(tubelet_mask_downsample=4),
    dict(exact_topk=True, tubelet_mask_downsample=4),
    dict(tubelet_mask_downsample=3),
]


def _denorm_clips(seed, B=3, T=4, S=64):
    rng = np.random.default_rng(seed)
    bg = rng.uniform(size=(B, 1, S, S, 3)).astype(np.float32) * 0.5
    x = np.repeat(bg, T, axis=1)
    for b in range(B):
        color = rng.uniform(0.4, 1.0, size=3)
        for t in range(T):
            r, c = 6 + 3 * t + b, 12 + 4 * t
            x[b, t, r:r + 20, c:c + 20] = color * (0.8 + 0.2 * rng.uniform(size=(20, 20, 1)))
    x = x + 0.02 * rng.normal(size=x.shape)
    x[0, :, 44:] = bg[0, 0, 44:]  # static and noise-free: zero differences, tied saliency
    return np.clip(x, 0, 1).astype(np.float32)


@pytest.mark.parametrize("mode", MODES, ids=lambda m: "-".join(f"{k}={v}" for k, v in m.items()))
def test_compute_fame_masks_bitwise(mode):
    x = _denorm_clips(1)
    mask_t, per_t = tfame.compute_fame_masks(torch.from_numpy(x), tfame.FAMEConfig(**mode))
    mask_j, per_j = jfame.compute_fame_masks(jnp.asarray(x), jfame.FAMEConfig(**mode))
    d = mode.get("tubelet_mask_downsample", 1)
    side = 64 // d if 64 % d == 0 else 64
    assert mask_t.shape == (3, 64, 64) and per_t.shape == (3, 2, side, side)
    np.testing.assert_array_equal(mask_t.numpy(), np.asarray(mask_j))
    np.testing.assert_array_equal(per_t.numpy(), np.asarray(per_j))
    # the exact mode takes exactly int(beta * H * W) pixels per map
    if mode.get("exact_topk"):
        assert (per_t.sum(dim=(-2, -1)) == int(0.5 * side * side)).all()


def test_exact_selection_breaks_ties_by_index():
    """Where the saliency ties, the exact mode takes the lower flat index
    first, as `lax.top_k` does."""
    flat = torch.tensor([[0.5, 0.0, 0.5, 0.5, 0.0, 1.0]])
    np.testing.assert_array_equal(tfame._first_n(flat, 3).numpy(), [[5, 0, 2]])
    np.testing.assert_array_equal(tfame._first_n(-flat, 1).numpy(), [[1]])
    _, top = jax.lax.top_k(jnp.asarray(flat.numpy()), 3)
    np.testing.assert_array_equal(np.asarray(top), [[5, 0, 2]])


@pytest.mark.parametrize("mode", [MODES[0], MODES[2]], ids=["exact_topk", "downsample4"])
@pytest.mark.parametrize("prob_aug", [0.5, 1.0])
def test_fame_augment_bitwise(mode, prob_aug):
    """The whole FAME call with the JAX call's own draws
    (`fame_draws_from_key`): mixed clips and both pooled targets bitwise."""
    x = ((_denorm_clips(2) - MEAN) / STD).astype(np.float32)
    labels = np.arange(3)
    key = jax.random.PRNGKey(7)
    v_j, _, (fg_j, pf_j) = jfame.fame_augment(key, jnp.asarray(x), jnp.asarray(labels),
                                              jfame.FAMEConfig(prob_aug=prob_aug, **mode))
    v_t, _, (fg_t, pf_t) = tfame.fame_augment(torch.from_numpy(x), torch.from_numpy(labels),
                                              tfame.FAMEConfig(prob_aug=prob_aug, **mode),
                                              draws=fame_draws_from_key(key, 3, prob_aug))
    assert fg_t.shape == (3, 16) and pf_t.shape == (3, 2 * 16)
    for got, want in ((v_t, v_j), (fg_t, fg_j), (pf_t, pf_j)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("frac", [0.5, 0.1])
def test_selected_fraction_is_jax_mean(frac):
    """The bisections compare the selected fraction of a 224 x 224 map with
    `frac`; JAX's `mean` is the sum times the reciprocal of the count,
    which is not always the sum divided by it at 50176 pixels. Around the
    count `frac` selects, the port's fraction equals JAX's bitwise."""
    n = 224 * 224
    counts = np.arange(int(frac * n) - 40, int(frac * n) + 40)
    mask = np.arange(n)[None, :] < counts[:, None]
    want = np.asarray(jnp.asarray(mask).mean(axis=-1, keepdims=True))
    np.testing.assert_array_equal(tfame._fraction(torch.from_numpy(mask)).numpy(), want)
