"""FAME foreground/background mixing on the device (port of
`devias_tpu/aug/fame.py`, the default path: threshold selection and full
resolution).

On a batch of clips [B, T, H, W, C]:
  1. denormalise to [0, 1];
  2. motion saliency (absolute frame differences) for the whole clip and
     for each frame pair (2i, 2i+1), Gaussian-blurred with reflect padding
     and min-max normalised per map;
  3. per map, a colour-histogram refinement against the clip's mean frame:
     the top-50 % salient pixels against the bottom-10 % build 10x10x10 HSV
     histograms, each pixel takes the foreground posterior of its bin, which
     is blurred, normalised and binarised at the top beta fraction;
  4. mix: videos[perm] * (1 - mask) + videos * mask for the samples that
     `keep` selects;
  5. pool the clip mask and the per-pair masks to the patch grid.

Reference quirks kept: the blur kernel is sized from crop_size=112 (11x11,
sigma 11/3) whatever the input size, and the hue angle is multiplied by 2*pi
twice. The selection thresholds are 26-step bisections, as in the JAX
package, not `topk`: the two differ at ties. The histograms are counts by
`index_add_` and the posterior lookup a `gather`, where the JAX package
uses one-hot matmuls because TPU scatters are slow; the counts are integers
and the lookup a pure gather, so the results are the same. Blurs are
float32 matrix products (full float32 on the card: TF32 stays off for
matmuls by default).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

_EPS = 1e-8
_DIM = 10  # histogram bins per HSV-derived channel
_N_BINS = _DIM * _DIM * _DIM + 1  # bin ids reach exactly 1000
_ITERS = 26  # bisection steps of the thresholds


@dataclasses.dataclass(frozen=True)
class FAMEConfig:
    beta: float = 0.5  # foreground area fraction
    prob_aug: float = 0.5  # per-sample probability of using the mixed clip
    crop_size: int = 112  # sets the blur kernel; the reference default
    patch_size: int = 16  # pooling of the patch-grid masks
    exact_topk: bool = False  # True (exact top-k selection) is not ported
    tubelet_mask_downsample: int = 1  # > 1 (the reduced fast mode) is not ported

    @property
    def gauss_size(self) -> int:
        return int(0.1 * self.crop_size) // 2 * 2 + 1

    @property
    def gauss_sigma(self) -> float:
        return self.gauss_size / 3.0


@functools.lru_cache(maxsize=8)
def _blur_band_matrix(n: int, size: int, sigma: float) -> np.ndarray:
    """[n, n] band matrix applying a 1-D Gaussian with reflect padding
    (no edge duplication): out[i] = sum_j M[i, j] in[j]."""
    xk = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    k = np.exp(-0.5 * (xk / sigma) ** 2)
    k = (k / k.sum()).astype(np.float32)
    pad = size // 2
    M = np.zeros((n, n), np.float32)
    for i in range(n):
        for t in range(size):
            j = i - pad + t
            if j < 0:
                j = -j
            elif j >= n:
                j = 2 * n - 2 - j
            M[i, j] += k[t]
    return M


def _gaussian_blur(img: torch.Tensor, size: int, sigma: float) -> torch.Tensor:
    """Separable Gaussian blur with reflect padding on [B, H, W]."""
    _, H, W = img.shape
    Mh = torch.from_numpy(_blur_band_matrix(H, size, sigma)).to(img.device)
    Mw = torch.from_numpy(_blur_band_matrix(W, size, sigma)).to(img.device)
    return torch.matmul(torch.matmul(Mh, img), Mw.t())


def _minmax_norm(m: torch.Tensor) -> torch.Tensor:
    """Per-sample min-max normalisation over the flattened map."""
    flat = m.reshape(m.shape[0], -1)
    flat = flat - flat.amin(dim=-1, keepdim=True)
    flat = flat / (flat.amax(dim=-1, keepdim=True) + _EPS)
    return flat.reshape(m.shape)


def _rgb_to_hsv(rgb: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """RGB [..., 3] in [0, 1] -> (h in [0, 1), s, v)."""
    r, g, b = rgb.unbind(-1)
    maxc = torch.maximum(torch.maximum(r, g), b)
    minc = torch.minimum(torch.minimum(r, g), b)
    rng = maxc - minc
    s = torch.where(maxc > 0, rng / (maxc + _EPS), torch.zeros_like(maxc))
    safe = torch.where(rng > 0, rng, torch.ones_like(rng))
    rc, gc, bc = (maxc - r) / safe, (maxc - g) / safe, (maxc - b) / safe
    h = torch.where(maxc == r, bc - gc, torch.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.where(rng > 0, torch.remainder(h / 6.0, 1.0), torch.zeros_like(h))
    return h, s, maxc


def _color_map(frame: torch.Tensor) -> torch.Tensor:
    """Histogram bin of each pixel of [B, H, W, 3] (clipped to [0, 1]) in a
    10x10x10 HSV cylinder: [B, H*W] int64 in [0, 1000]. The hue angle is
    h * (2 pi)^2: the reference converts to radians and multiplies by 2 pi
    again."""
    h, s, v = _rgb_to_hsv(frame.clamp(0.0, 1.0))
    two_pi = 2.0 * math.pi
    ang = h * two_pi * two_pi
    hq = torch.round((s * torch.cos(ang) + 1.0) / 2.0 * (_DIM - 1) + 1)
    sq = torch.round((s * torch.sin(ang) + 1.0) / 2.0 * (_DIM - 1) + 1)
    vq = torch.round(v * (_DIM - 1) + 1)
    cmap = hq + (sq - 1) * _DIM + (vq - 1) * _DIM * _DIM
    return cmap.reshape(frame.shape[0], -1).long()


def _fraction(mask: torch.Tensor) -> torch.Tensor:
    return mask.sum(dim=-1, keepdim=True, dtype=torch.float32) / mask.shape[-1]


def _top_fraction_threshold(x: torch.Tensor, frac: float) -> torch.Tensor:
    """Per-row t with |{x >= t}| ~= frac * N over [0, 1]-valued x [R, N],
    by bisection; never under-selects. Returns [R, 1]."""
    lo = torch.zeros(x.shape[0], 1, dtype=x.dtype, device=x.device)
    hi = torch.ones_like(lo)
    for _ in range(_ITERS):
        mid = (lo + hi) * 0.5
        take = _fraction(x >= mid) >= frac
        lo = torch.where(take, mid, lo)
        hi = torch.where(take, hi, mid)
    return lo


def _bottom_fraction_threshold(x: torch.Tensor, frac: float) -> torch.Tensor:
    """Per-row t with |{x <= t}| ~= frac * N, never under-selecting; not the
    complement of the top threshold (ties at zero saliency)."""
    lo = torch.zeros(x.shape[0], 1, dtype=x.dtype, device=x.device)
    hi = torch.ones_like(lo)
    for _ in range(_ITERS):
        mid = (lo + hi) * 0.5
        take = _fraction(x <= mid) >= frac
        hi = torch.where(take, mid, hi)
        lo = torch.where(take, lo, mid)
    return hi


def _hist_posterior(cmap: torch.Tensor, w_fg: torch.Tensor, w_bg: torch.Tensor) -> torch.Tensor:
    """Foreground posterior of each pixel's colour bin. cmap [B, P] bins,
    w_fg / w_bg [B, M, P] selections. Returns [B, M, P] float32."""
    B, M, P = w_fg.shape
    rows = torch.arange(B * M, device=cmap.device).view(B, M, 1) * _N_BINS
    idx = (rows + cmap[:, None, :]).reshape(-1)

    def hist(w):
        h = torch.zeros(B * M * _N_BINS, dtype=torch.float32, device=cmap.device)
        return h.index_add_(0, idx, w.reshape(-1).float()).view(B, M, _N_BINS)

    dict_fg, dict_bg = hist(w_fg), hist(w_bg) + 1.0
    dict_fg = dict_fg / (dict_fg.sum(dim=-1, keepdim=True) + _EPS)
    dict_bg = dict_bg / (dict_bg.sum(dim=-1, keepdim=True) + _EPS)
    ratio = dict_fg / (dict_bg + dict_fg)
    return ratio.gather(-1, cmap[:, None, :].expand(B, M, P))


def _get_seg_multi(masks: torch.Tensor, mean_frame: torch.Tensor, beta: float, cfg: FAMEConfig) -> torch.Tensor:
    """Colour-histogram refinement and top-beta binarisation of M saliency
    maps per sample that share one mean frame. masks [B, M, H, W] in
    [0, 1], mean_frame [B, H, W, 3]. Returns binary [B, M, H, W] float32."""
    B, M, H, W = masks.shape
    flat = masks.reshape(B * M, H * W)
    cmap = _color_map(mean_frame)
    w_fg = (flat >= _top_fraction_threshold(flat, 0.5)).reshape(B, M, -1)
    w_bg = (flat <= _bottom_fraction_threshold(flat, 0.1)).reshape(B, M, -1)
    refine = _hist_posterior(cmap, w_fg, w_bg).reshape(B * M, H, W)
    refine = _minmax_norm(_gaussian_blur(refine, cfg.gauss_size, cfg.gauss_sigma)).reshape(B * M, -1)
    return (refine >= _top_fraction_threshold(refine, beta)).float().reshape(B, M, H, W)


def compute_fame_masks(video: torch.Tensor, cfg: FAMEConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """(clip mask [B, H, W], per-pair masks [B, T/2, H, W]) of the
    denormalised clips [B, T, H, W, C] in float32."""
    if cfg.exact_topk or cfg.tubelet_mask_downsample != 1:
        raise NotImplementedError("FAME's exact_topk and downsampled modes are not ported")
    B, T, H, W, C = video.shape
    mean_frame = video.mean(dim=1)
    pairs = video.reshape(B, T // 2, 2, H, W, C)
    diffs = (pairs[:, :, 0] - pairs[:, :, 1]).abs().sum(dim=-1)
    clip_diff = (video[:, :-1] - video[:, 1:]).abs().sum(dim=-1).mean(dim=1)
    sal = torch.cat([clip_diff[:, None], diffs], dim=1).reshape(B * (1 + T // 2), H, W)
    sal = _minmax_norm(_gaussian_blur(sal, cfg.gauss_size, cfg.gauss_sigma)).reshape(B, 1 + T // 2, H, W)
    seg = _get_seg_multi(sal, mean_frame, cfg.beta, cfg)
    return seg[:, 0], seg[:, 1:]


def _pool_to_patches(m: torch.Tensor, patch: int) -> torch.Tensor:
    """Average-pool [..., H, W] by patch x patch."""
    *lead, H, W = m.shape
    return m.reshape(*lead, H // patch, patch, W // patch, patch).mean(dim=(-3, -1))


def fame_draws(batch: int, cfg: FAMEConfig, generator: torch.Generator,
               device: torch.device) -> Dict[str, torch.Tensor]:
    """The donor permutation and the per-sample keep of one FAME call."""
    perm = torch.randperm(batch, generator=generator, device=device)
    if cfg.prob_aug < 1:
        keep = torch.rand(batch, generator=generator, device=device) < cfg.prob_aug
    else:
        keep = torch.ones(batch, dtype=torch.bool, device=device)
    return {"perm": perm, "keep": keep}


def _fame_core(videos: torch.Tensor, cfg: FAMEConfig, generator: Optional[torch.Generator],
               draws: Optional[Dict[str, torch.Tensor]], mean: Sequence[float], std: Sequence[float]):
    """Masks and mix of one FAME call: (mixed videos, fg_mask, fg_pf, perm,
    keep), with `draws` or draws from `generator`."""
    if draws is None:
        if generator is None:
            raise ValueError("FAME needs a torch.Generator or explicit draws")
        draws = fame_draws(videos.shape[0], cfg, generator, videos.device)
    dev = videos.device
    mean_t = torch.tensor(mean, dtype=torch.float32, device=dev)
    std_t = torch.tensor(std, dtype=torch.float32, device=dev)
    denorm = videos.float() * std_t + mean_t
    mask, per_pair = compute_fame_masks(denorm, cfg)

    perm = draws["perm"].to(dev)
    keep = draws["keep"].to(dev)
    m = mask[:, None, :, :, None]
    fused = videos[perm] * (1.0 - m) + videos * m
    videos_out = torch.where(keep.view(-1, 1, 1, 1, 1), fused, videos).to(videos.dtype)

    B = videos.shape[0]
    fg_mask = _pool_to_patches(mask, cfg.patch_size).reshape(B, -1)
    fg_pf = _pool_to_patches(per_pair, cfg.patch_size).reshape(B, -1)
    return videos_out, fg_mask, fg_pf, perm, keep


def fame_augment(videos: torch.Tensor, labels: torch.Tensor, cfg: FAMEConfig = FAMEConfig(),
                 generator: Optional[torch.Generator] = None, draws: Optional[Dict[str, torch.Tensor]] = None,
                 mean: Sequence[float] = IMAGENET_MEAN, std: Sequence[float] = IMAGENET_STD):
    """FAME on a normalised batch [B, T, H, W, C]. Returns (videos, labels,
    (fg_mask [B, (H/p)(W/p)], fg_masks_per_frames [B, T/2 (H/p)(W/p)])).

    `draws` = {"perm": LongTensor[B], "keep": BoolTensor[B]} fixes the donor
    permutation and the samples that take the mixed clip; without it both
    are drawn from `generator`. Labels pass through: the foreground keeps
    its action."""
    videos_out, fg_mask, fg_pf, _, _ = _fame_core(videos, cfg, generator, draws, mean, std)
    return videos_out, labels, (fg_mask, fg_pf)


def fame_augment_hvu(videos: torch.Tensor, action_labels: torch.Tensor, scene_labels: torch.Tensor,
                     cfg: FAMEConfig = FAMEConfig(), generator: Optional[torch.Generator] = None,
                     draws: Optional[Dict[str, torch.Tensor]] = None, mean: Sequence[float] = IMAGENET_MEAN,
                     std: Sequence[float] = IMAGENET_STD):
    """FAME-HVU: FAME as `fame_augment`, and a mixed sample takes its
    background donor's scene label, `scene_labels[perm]` where `keep`
    holds. Reference quirk kept: with `prob_aug >= 1` every sample is
    mixed but the scene labels pass through unswapped. Returns (videos,
    action_labels, scene_labels, (fg_mask, fg_masks_per_frames))."""
    videos_out, fg_mask, fg_pf, perm, keep = _fame_core(videos, cfg, generator, draws, mean, std)
    if cfg.prob_aug < 1:
        scene_labels = torch.where(keep, scene_labels[perm], scene_labels)
    return videos_out, action_labels, scene_labels, (fg_mask, fg_pf)
