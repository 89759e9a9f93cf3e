"""The port's FAME and I420 unpack against the JAX package's, on the same
numpy clips in float32 (3 clips of 4 frames at 64x64: a static textured
background and a moving textured square, plus noise).

The mask thresholds are 26-step bisections on per-sample statistics, so a
rounding difference (a blur summed in another order, a cosine one ulp off)
may move a pixel across a boundary. So the binary masks are held to an IoU
of at least 0.99; the pooled patch-grid targets to a max difference of 1/64
(four flipped pixels of a 16x16 patch) and a mean of 1e-3; and the mixed
clips to exact equality wherever the two masks agree. The pieces without a
threshold hold exactly or to float32 rounding."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from devias_tpu.aug import fame as jfame
from devias_tpu.data.yuv import i420_to_rgb as jax_i420_to_rgb
from devias_tpu_torch.aug import fame as tfame
from devias_tpu_torch.data import i420_to_rgb

MEAN, STD = np.array(tfame.IMAGENET_MEAN, np.float32), np.array(tfame.IMAGENET_STD, np.float32)


def _clips(seed, B=3, T=4, S=64):
    rng = np.random.default_rng(seed)
    bg = rng.uniform(size=(B, 1, S, S, 3)).astype(np.float32) * 0.5
    x = np.repeat(bg, T, axis=1)
    for b in range(B):
        color = rng.uniform(0.4, 1.0, size=3)
        for t in range(T):
            r, c = 10 + 3 * t + b, 12 + 4 * t
            x[b, t, r:r + 20, c:c + 20] = color * (0.8 + 0.2 * rng.uniform(size=(20, 20, 1)))
    x = np.clip(x + 0.02 * rng.normal(size=x.shape), 0, 1).astype(np.float32)
    return ((x - MEAN) / STD).astype(np.float32)


def _iou(a, b):
    a, b = np.asarray(a) > 0.5, np.asarray(b) > 0.5
    return (a & b).sum() / max((a | b).sum(), 1)


def test_config_and_pieces_without_thresholds_match():
    cfg_t, cfg_j = tfame.FAMEConfig(), jfame.FAMEConfig()
    assert (cfg_t.gauss_size, cfg_t.gauss_sigma, cfg_t.beta, cfg_t.prob_aug) == \
        (cfg_j.gauss_size, cfg_j.gauss_sigma, cfg_j.beta, cfg_j.prob_aug)
    np.testing.assert_array_equal(tfame._blur_band_matrix(64, 11, 11 / 3), jfame._blur_band_matrix(64, 11, 11 / 3))
    rng = np.random.default_rng(0)
    img = rng.uniform(size=(3, 64, 48)).astype(np.float32)
    np.testing.assert_allclose(tfame._gaussian_blur(torch.from_numpy(img), 11, 11 / 3).numpy(),
                               np.asarray(jfame._gaussian_blur(jnp.asarray(img), 11, 11 / 3)), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tfame._minmax_norm(torch.from_numpy(img)).numpy(),
                               np.asarray(jfame._minmax_norm(jnp.asarray(img))), rtol=1e-6, atol=1e-7)
    frame = rng.uniform(-0.1, 1.1, size=(2, 64, 64, 3)).astype(np.float32)
    frame[0, 0, :4] = [[0.5, 0.5, 0.5], [1, 0, 0], [0, 1, 0], [0, 0, 1]]  # grey and pure hues
    for a, b in zip(tfame._rgb_to_hsv(torch.from_numpy(frame.clip(0, 1))),
                    jfame._rgb_to_hsv(jnp.asarray(frame.clip(0, 1)))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)
    cm_t = tfame._color_map(torch.from_numpy(frame)).numpy()
    cm_j = np.asarray(jfame._color_map(jnp.asarray(frame)))
    assert (cm_t != cm_j).mean() < 1e-3 and cm_t.min() >= 0 and cm_t.max() <= 1000
    sal = rng.uniform(size=(4, 4096)).astype(np.float32)
    sal[0, :2048] = 0.0  # heavy ties at zero
    for ours, theirs in ((tfame._top_fraction_threshold, jfame._top_fraction_threshold),
                         (tfame._bottom_fraction_threshold, jfame._bottom_fraction_threshold)):
        for frac in (0.5, 0.1):
            np.testing.assert_array_equal(ours(torch.from_numpy(sal), frac).numpy(), np.asarray(theirs(jnp.asarray(sal), frac)))


def test_compute_fame_masks_match():
    x = _clips(1)
    denorm = x * STD + MEAN
    mask_t, per_t = tfame.compute_fame_masks(torch.from_numpy(denorm), tfame.FAMEConfig())
    mask_j, per_j = jfame.compute_fame_masks(jnp.asarray(denorm), jfame.FAMEConfig())
    assert mask_t.shape == (3, 64, 64) and per_t.shape == (3, 2, 64, 64)
    assert set(np.unique(mask_t.numpy())) <= {0.0, 1.0}
    assert _iou(mask_t.numpy(), mask_j) >= 0.99
    assert _iou(per_t.numpy(), per_j) >= 0.99


@pytest.mark.parametrize("seed,prob_aug", [(2, 0.5), (3, 1.0)])
def test_fame_augment_with_injected_draws_matches(seed, prob_aug):
    """The JAX draws of `_fame_core` (split key -> permutation, uniform <
    prob_aug) are handed to the port as `draws`."""
    x = _clips(seed)
    labels = np.arange(3)
    key = jax.random.PRNGKey(seed)
    perm_key, keep_key = jax.random.split(key)
    perm = np.asarray(jax.random.permutation(perm_key, 3))
    keep = (np.asarray(jax.random.uniform(keep_key, (3,))) < prob_aug) if prob_aug < 1 else np.ones(3, bool)
    cfg_j, cfg_t = jfame.FAMEConfig(prob_aug=prob_aug), tfame.FAMEConfig(prob_aug=prob_aug)
    v_j, l_j, (fg_j, pf_j) = jfame.fame_augment(key, jnp.asarray(x), jnp.asarray(labels), cfg_j)
    draws = {"perm": torch.from_numpy(perm), "keep": torch.from_numpy(keep)}
    v_t, l_t, (fg_t, pf_t) = tfame.fame_augment(torch.from_numpy(x), torch.from_numpy(labels), cfg_t, draws=draws)
    np.testing.assert_array_equal(l_t.numpy(), np.asarray(l_j))
    assert fg_t.shape == (3, 16) and pf_t.shape == (3, 2 * 16)
    for got, want in ((fg_t, fg_j), (pf_t, pf_j)):
        d = np.abs(got.numpy() - np.asarray(want))
        assert d.max() <= 1 / 64 and d.mean() <= 1e-3, (d.max(), d.mean())

    denorm = x * STD + MEAN
    mask_t = tfame.compute_fame_masks(torch.from_numpy(denorm), cfg_t)[0].numpy()
    mask_j = np.asarray(jfame.compute_fame_masks(jnp.asarray(denorm), cfg_j)[0])
    agree = np.broadcast_to((mask_t == mask_j)[:, None, :, :, None], x.shape)
    assert agree.mean() >= 0.99
    np.testing.assert_array_equal(v_t.numpy()[agree], np.asarray(v_j)[agree])
    mixed = keep & (perm != np.arange(3))
    unmixed = ~keep
    np.testing.assert_array_equal(v_t.numpy()[unmixed], x[unmixed])
    if mixed.any():
        assert not np.array_equal(v_t.numpy()[mixed], x[mixed])


def test_draws_come_from_the_generator():
    x = torch.from_numpy(_clips(4))
    labels = torch.arange(3)
    g = torch.Generator().manual_seed(0)
    d = tfame.fame_draws(3, tfame.FAMEConfig(prob_aug=0.5), g, x.device)
    assert sorted(d["perm"].tolist()) == [0, 1, 2] and d["keep"].dtype == torch.bool
    assert tfame.fame_draws(3, tfame.FAMEConfig(prob_aug=1.0), g, x.device)["keep"].all()
    a = tfame.fame_augment(x, labels, generator=torch.Generator().manual_seed(5))[0]
    b = tfame.fame_augment(x, labels, generator=torch.Generator().manual_seed(5))[0]
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    with pytest.raises(ValueError, match="Generator"):
        tfame.fame_augment(x, labels)
    exact = tfame.FAMEConfig(exact_topk=True)
    a = tfame.fame_augment(x, labels, exact, generator=torch.Generator().manual_seed(5))
    b = tfame.fame_augment(x, labels, exact, generator=torch.Generator().manual_seed(5))
    for got, want in ((a[0], b[0]), (a[2][0], b[2][0]), (a[2][1], b[2][1])):
        torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_i420_to_rgb_matches():
    rng = np.random.default_rng(6)
    planes = rng.integers(0, 256, size=(2, 3, 48, 32), dtype=np.uint8)  # H=32, W=32
    got = i420_to_rgb(torch.from_numpy(planes)).numpy()
    want = np.asarray(jax_i420_to_rgb(jnp.asarray(planes)))
    assert got.shape == (2, 3, 32, 32, 3)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
