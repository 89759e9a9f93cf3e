"""The random draws of the JAX package's batch ops, rebuilt from their keys
in the port's explicit-draws format, for the parity tests: FAME's
{"perm", "keep"} (`devias_tpu/aug/fame.py::_fame_core`), the Segformer
mix's {"perm", "keep", "frame"} (`devias_tpu/aug/segformer_mix.py`) and
mixup's (`devias_tpu/aug/mixup.py::mixup_cutmix`, format in
`devias_tpu_torch/aug/mixup.py`)."""

import jax
import numpy as np
import torch


def _t(x):
    return torch.from_numpy(np.array(x))


def fame_draws_from_key(key, B, prob_aug):
    """`_fame_core`'s draws: split the key -> permutation, uniform < prob_aug."""
    perm_key, keep_key = jax.random.split(key)
    perm = np.asarray(jax.random.permutation(perm_key, B))
    keep = np.asarray(jax.random.uniform(keep_key, (B,))) < prob_aug if prob_aug < 1 else np.ones(B, bool)
    return {"perm": _t(perm), "keep": _t(keep)}


def segformer_draws_from_key(key, B, frames, prob_aug):
    """`segformer_mix_sample`'s draws: split the key in three ->
    permutation, uniform < prob_aug, the shared frame index."""
    perm_key, keep_key, frame_key = jax.random.split(key, 3)
    perm = np.asarray(jax.random.permutation(perm_key, B))
    keep = np.asarray(jax.random.uniform(keep_key, (B,))) < prob_aug if prob_aug < 1 else np.ones(B, bool)
    return {"perm": _t(perm), "keep": _t(keep), "frame": _t(jax.random.randint(frame_key, (), 0, frames))}


def step_key(key, step, U, u):
    """The key of micro-batch u in a JAX train step at `step`:
    split(fold_in(key, step), U)[u]."""
    return jax.random.split(jax.random.fold_in(key, step), U)[u]


def _box_draws(key, n, cfg, H, W):
    if cfg.cutmix_minmax is not None:
        lo, hi = cfg.cutmix_minmax
        rh, rw, ry, rx = jax.random.split(key, 4)
        cut_h = jax.random.randint(rh, (n,), int(H * lo), int(H * hi))
        cut_w = jax.random.randint(rw, (n,), int(W * lo), int(W * hi))
        return {"cut_h": _t(cut_h), "cut_w": _t(cut_w), "y1": _t(jax.random.randint(ry, (n,), 0, H - cut_h)),
                "x1": _t(jax.random.randint(rx, (n,), 0, W - cut_w))}
    ry, rx = jax.random.split(key)
    return {"cy": _t(jax.random.randint(ry, (n,), 0, H)), "cx": _t(jax.random.randint(rx, (n,), 0, W))}


def mixup_draws_from_key(key, cfg, B, H, W):
    """The draws `devias_tpu.aug.mixup.mixup_cutmix(key, ...)` takes on B
    clips of H x W under `cfg` (a JAX MixupConfig)."""
    m, c = cfg.mixup_alpha, cfg.cutmix_alpha
    if cfg.mode in ("elem", "pair"):
        n = B if cfg.mode == "elem" else B // 2
        r_par, r_box = jax.random.split(key)
        r_switch, r_beta_c, r_beta_m, r_prob = jax.random.split(r_par, 4)
        d = {"mix": _t(jax.random.uniform(r_prob, (n,)) < cfg.prob),
             "switch": _t(jax.random.uniform(r_switch, (n,)) < cfg.switch_prob)}
        if m > 0:
            d["lam_mix"] = _t(jax.random.beta(r_beta_m, m, m, (n,)))
        if c > 0:
            d["lam_cut"] = _t(jax.random.beta(r_beta_c, c, c, (n,)))
        return {**d, **_box_draws(r_box, n, cfg, H, W)}
    r_use, r_switch, r_lam_m, r_lam_c, r_box = jax.random.split(key, 5)
    d = {"mix": _t(jax.random.uniform(r_use) < cfg.prob).view(1),
         "switch": _t(jax.random.uniform(r_switch) < cfg.switch_prob).view(1)}
    if m > 0:
        d["lam_mix"] = _t(jax.random.beta(r_lam_m, m, m)).view(1)
    if c > 0:
        d["lam_cut"] = _t(jax.random.beta(r_lam_c, c, c)).view(1)
    return {**d, **_box_draws(r_box, 1, cfg, H, W)}
