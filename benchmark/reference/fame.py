"""FAME foreground/background mixing, plain float32 (a frozen copy of the
arithmetic of the port's `aug/fame.py` at its published settings: masks
at full resolution, thresholds by 26-step bisection).

On normalised clips [B, T, H, W, C]: denormalise; motion saliency of the
clip and of each frame pair, blurred (11 x 11, sigma 11/3, reflect) and
min-max normalised; a 10 x 10 x 10 HSV histogram refinement against the
mean frame (top half salient against bottom tenth), blurred, normalised and
binarised at the top `beta` fraction; the donor `perm` mixed in where
`keep` holds; the masks pooled to the patch grid. The reference's quirks
are kept: the blur is sized from crop 112, the hue angle is multiplied by
2 pi twice, means are sums times the count's reciprocal.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
_EPS = 1e-8
_DIM = 10
_N_BINS = _DIM ** 3 + 1
_ITERS = 26
_BLUR = 11  # int(0.1 * 112) // 2 * 2 + 1
_PATCH = 16


def _band(n: int, size: int, sigma: float) -> torch.Tensor:
    xk = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    k = np.exp(-0.5 * (xk / sigma) ** 2)
    k = (k / k.sum()).astype(np.float32)
    pad = size // 2
    M = np.zeros((n, n), np.float32)
    for i in range(n):
        for t in range(size):
            j = i - pad + t
            j = -j if j < 0 else (2 * n - 2 - j if j >= n else j)
            M[i, j] += k[t]
    return torch.from_numpy(M)


def _blur(img: torch.Tensor) -> torch.Tensor:
    _, H, W = img.shape
    Mh, Mw = _band(H, _BLUR, _BLUR / 3.0).to(img.device), _band(W, _BLUR, _BLUR / 3.0).to(img.device)
    return torch.matmul(torch.matmul(Mh, img), Mw.t())


def _minmax(m: torch.Tensor) -> torch.Tensor:
    flat = m.reshape(m.shape[0], -1)
    flat = flat - flat.amin(dim=-1, keepdim=True)
    return (flat / (flat.amax(dim=-1, keepdim=True) + _EPS)).reshape(m.shape)


def _mean(x: torch.Tensor, dim: int, keepdim: bool = False) -> torch.Tensor:
    return x.sum(dim=dim, keepdim=keepdim, dtype=torch.float32) * (1.0 / x.shape[dim])


def _color_map(frame: torch.Tensor) -> torch.Tensor:
    rgb = frame.clamp(0.0, 1.0)
    r, g, b = rgb.unbind(-1)
    maxc = torch.maximum(torch.maximum(r, g), b)
    minc = torch.minimum(torch.minimum(r, g), b)
    rng = maxc - minc
    s = torch.where(maxc > 0, rng / (maxc + _EPS), torch.zeros_like(maxc))
    safe = torch.where(rng > 0, rng, torch.ones_like(rng))
    rc, gc, bc = (maxc - r) / safe, (maxc - g) / safe, (maxc - b) / safe
    h = torch.where(maxc == r, bc - gc, torch.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.where(rng > 0, torch.remainder(h / 6.0, 1.0), torch.zeros_like(h))
    ang = h * (2.0 * math.pi) * (2.0 * math.pi)
    hq = torch.round((s * torch.cos(ang) + 1.0) / 2.0 * (_DIM - 1) + 1)
    sq = torch.round((s * torch.sin(ang) + 1.0) / 2.0 * (_DIM - 1) + 1)
    vq = torch.round(maxc * (_DIM - 1) + 1)
    return (hq + (sq - 1) * _DIM + (vq - 1) * _DIM * _DIM).reshape(frame.shape[0], -1).long()


def _threshold(x: torch.Tensor, frac: float, top: bool) -> torch.Tensor:
    lo = torch.zeros(x.shape[0], 1, dtype=x.dtype, device=x.device)
    hi = torch.ones_like(lo)
    for _ in range(_ITERS):
        mid = (lo + hi) * 0.5
        take = _mean(x >= mid if top else x <= mid, -1, keepdim=True) >= frac
        if top:
            lo, hi = torch.where(take, mid, lo), torch.where(take, hi, mid)
        else:
            hi, lo = torch.where(take, mid, hi), torch.where(take, lo, mid)
    return lo if top else hi


def _segment(masks: torch.Tensor, mean_frame: torch.Tensor, beta: float) -> torch.Tensor:
    B, M, H, W = masks.shape
    flat = masks.reshape(B * M, H * W)
    cmap = _color_map(mean_frame)
    w_fg = (flat >= _threshold(flat, 0.5, True)).reshape(B, M, -1)
    w_bg = (flat <= _threshold(flat, 0.1, False)).reshape(B, M, -1)
    idx = (torch.arange(B * M, device=cmap.device).view(B, M, 1) * _N_BINS + cmap[:, None, :]).reshape(-1)

    def hist(w):
        h = torch.zeros(B * M * _N_BINS, dtype=torch.float32, device=cmap.device)
        return h.index_add_(0, idx, w.reshape(-1).float()).view(B, M, _N_BINS)

    fg, bg = hist(w_fg), hist(w_bg) + 1.0
    fg = fg / (fg.sum(dim=-1, keepdim=True) + _EPS)
    bg = bg / (bg.sum(dim=-1, keepdim=True) + _EPS)
    refine = (fg / (bg + fg)).gather(-1, cmap[:, None, :].expand(B, M, H * W)).reshape(B * M, H, W)
    refine = _minmax(_blur(refine)).reshape(B * M, -1)
    return (refine >= _threshold(refine, beta, True)).float().reshape(B, M, H, W)


def _pool(m: torch.Tensor) -> torch.Tensor:
    *lead, H, W = m.shape
    return m.reshape(*lead, H // _PATCH, _PATCH, W // _PATCH, _PATCH).mean(dim=(-3, -1))


def fame(videos: torch.Tensor, draws: Dict[str, torch.Tensor], beta: float
         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(mixed clips, fg_mask [B, (H/16)(W/16)], fg_pf [B, T/2 (H/16)(W/16)])
    of ImageNet-normalised clips with the donor `perm` and the samples that
    `keep` mixes."""
    B, T, H, W, C = videos.shape
    dev = videos.device
    denorm = videos * torch.tensor(IMAGENET_STD, device=dev) + torch.tensor(IMAGENET_MEAN, device=dev)
    mean_frame = _mean(denorm, 1)
    pairs = denorm.reshape(B, T // 2, 2, H, W, C)
    diffs = (pairs[:, :, 0] - pairs[:, :, 1]).abs().sum(dim=-1)
    clip_diff = _mean((denorm[:, :-1] - denorm[:, 1:]).abs().sum(dim=-1), 1)
    sal = torch.cat([clip_diff[:, None], diffs], dim=1).reshape(B * (1 + T // 2), H, W)
    sal = _minmax(_blur(sal)).reshape(B, 1 + T // 2, H, W)
    seg = _segment(sal, mean_frame, beta)
    mask, per_pair = seg[:, 0], seg[:, 1:]
    m = mask[:, None, :, :, None]
    mixed = videos[draws["perm"]] * (1.0 - m) + videos * m
    out = torch.where(draws["keep"].view(-1, 1, 1, 1, 1), mixed, videos)
    return out, _pool(mask).reshape(B, -1), _pool(per_pair).reshape(B, -1)
