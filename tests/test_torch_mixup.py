"""The port's mixup / CutMix against the JAX package's, in float32 on 8x12x16
clips: the batch, pair and elem modes, with the square box and with
`cutmix_minmax`, with both alphas on, mixup only and CutMix only. The draws
of each JAX call are rebuilt from its key chain (the same splits, uniforms,
betas and integer draws) and handed to the port as `draws`; clips and soft
targets hold to 1e-6 over several keys, so both the mixup and the CutMix
branch and clips that do not mix are all reached. Also: the config's
checks, and the port's own draws (the gamma sampler's Beta moments,
determinism per generator state)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _jax_draws import mixup_draws_from_key
from devias_tpu.aug import mixup as jmix
from devias_tpu_torch.aug import mixup as tmix

TOL = dict(rtol=1e-6, atol=1e-6)
B, T, H, W, K = 6, 8, 12, 16, 7
KEYS = range(6)


ALPHAS = {"both": dict(mixup_alpha=0.8, cutmix_alpha=1.0), "mixup": dict(mixup_alpha=0.8, cutmix_alpha=0.0),
          "cutmix": dict(mixup_alpha=0.0, cutmix_alpha=1.0)}


# every mode with each pair of alphas and the square box, and with
# cutmix_minmax (which forces cutmix_alpha to 1.0, so only "both" differs)
CASES = [(mode, None, alphas) for mode in ("batch", "pair", "elem") for alphas in ALPHAS] + \
    [(mode, (0.3, 0.7), "both") for mode in ("batch", "pair", "elem")]


@pytest.mark.parametrize("mode,minmax,alphas", CASES)
def test_mixup_cutmix_matches_jax_on_its_draws(mode, minmax, alphas):
    kw = dict(ALPHAS[alphas], prob=0.8 if mode != "batch" else 1.0, switch_prob=0.5, label_smoothing=0.1,
              num_classes=K, mode=mode, cutmix_minmax=minmax)
    cfg_j, cfg_t = jmix.MixupConfig(**kw), tmix.MixupConfig(**kw)
    rng = np.random.default_rng(0)
    videos = rng.normal(size=(B, T, H, W, 3)).astype(np.float32)
    labels = rng.integers(0, K, size=B)
    changed = 0
    for k in KEYS:
        key = jax.random.PRNGKey(k)
        v_j, t_j = jmix.mixup_cutmix(key, jnp.asarray(videos), jnp.asarray(labels), cfg_j)
        v_t, t_t = tmix.mixup_cutmix(torch.from_numpy(videos), torch.from_numpy(labels), cfg_t,
                                     draws=mixup_draws_from_key(key, cfg_j, B, H, W))
        np.testing.assert_allclose(v_t.numpy(), np.asarray(v_j), err_msg=f"key {k}", **TOL)
        np.testing.assert_allclose(t_t.numpy(), np.asarray(t_j), err_msg=f"key {k}", **TOL)
        assert v_t.dtype == torch.float32 and t_t.shape == (B, K)
        np.testing.assert_allclose(t_t.sum(-1).numpy(), 1.0, rtol=1e-5)
        changed += int(not np.array_equal(v_t.numpy(), videos))
    assert changed > 0


def test_disabled_mixup_smooths_only():
    kw = dict(mixup_alpha=0.0, cutmix_alpha=0.0, label_smoothing=0.2, num_classes=K)
    videos = np.random.default_rng(1).normal(size=(B, T, H, W, 3)).astype(np.float32)
    labels = np.arange(B) % K
    v_j, t_j = jmix.mixup_cutmix(jax.random.PRNGKey(0), jnp.asarray(videos), jnp.asarray(labels),
                                 jmix.MixupConfig(**kw))
    v_t, t_t = tmix.mixup_cutmix(torch.from_numpy(videos), torch.from_numpy(labels), tmix.MixupConfig(**kw))
    assert not tmix.MixupConfig(**kw).enabled
    np.testing.assert_array_equal(v_t.numpy(), videos)
    np.testing.assert_allclose(t_t.numpy(), np.asarray(t_j), **TOL)


def test_config_checks_and_defaults_match():
    assert tmix.MixupConfig() == tmix.MixupConfig(**{f: getattr(jmix.MixupConfig(), f)
                                                     for f in ("mixup_alpha", "cutmix_alpha", "prob", "switch_prob",
                                                               "label_smoothing", "num_classes", "mode",
                                                               "cutmix_minmax")})
    assert tmix.MixupConfig(cutmix_alpha=0.3, cutmix_minmax=(0.2, 0.8)).cutmix_alpha == 1.0
    with pytest.raises(ValueError, match="batch\\|pair\\|elem"):
        tmix.MixupConfig(mode="row")
    with pytest.raises(ValueError, match="two ratios"):
        tmix.MixupConfig(cutmix_minmax=(0.2, 0.5, 0.8))


@pytest.mark.parametrize("alpha", [0.8, 1.0, 2.5])
def test_beta_sampler_moments(alpha):
    """Beta(alpha, alpha) from the gamma sampler: mean 1/2, variance
    1 / (4 (2 alpha + 1)), within 4 standard errors over 40,000 draws."""
    x = tmix._beta(alpha, 40_000, torch.Generator().manual_seed(3), "cpu").double()
    assert ((x > 0) & (x < 1)).all()
    var = 1.0 / (4 * (2 * alpha + 1))
    assert abs(x.mean().item() - 0.5) < 4 * (var / 40_000) ** 0.5
    assert abs(x.var().item() - var) < 0.05 * var


@pytest.mark.parametrize("mode,minmax", [("batch", None), ("elem", (0.3, 0.7)), ("pair", None)])
def test_own_draws_are_valid_and_repeat_per_generator_state(mode, minmax):
    cfg = tmix.MixupConfig(mode=mode, cutmix_minmax=minmax, num_classes=K)
    d = tmix.mixup_draws(B, H, W, cfg, torch.Generator().manual_seed(0))
    n = {"batch": 1, "elem": B, "pair": B // 2}[mode]
    assert all(v.shape == (n,) for v in d.values())
    if minmax is None:
        assert ((d["cy"] >= 0) & (d["cy"] < H)).all() and ((d["cx"] >= 0) & (d["cx"] < W)).all()
    else:
        assert ((d["cut_h"] >= int(H * 0.3)) & (d["cut_h"] < int(H * 0.7))).all()
        assert ((d["y1"] >= 0) & (d["y1"] + d["cut_h"] <= H)).all()
        assert ((d["x1"] >= 0) & (d["x1"] + d["cut_w"] <= W)).all()
    videos = torch.randn(B, T, H, W, 3, generator=torch.Generator().manual_seed(1))
    labels = torch.arange(B) % K
    a = tmix.mixup_cutmix(videos, labels, cfg, generator=torch.Generator().manual_seed(4))
    b = tmix.mixup_cutmix(videos, labels, cfg, generator=torch.Generator().manual_seed(4))
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    with pytest.raises(ValueError, match="Generator"):
        tmix.mixup_cutmix(videos, labels, cfg)
