"""Mixup / CutMix on the device (port of `devias_tpu/aug/mixup.py`; timm
semantics in batch, pair and elem modes).

Every mode mixes clip i with its partner in the flipped batch, j = B-1-i:
  batch - one (lam, use_cutmix, box) for the whole batch;
  elem  - an independent (lam, use_cutmix, box) per clip;
  pair  - B//2 draws, mirrored so clips i and B-1-i share theirs.
`cutmix_minmax` replaces the square, lam-derived box by one of random
height and width in [min, max] of the frame, wholly inside it, and forces
`cutmix_alpha` to 1.0. The targets are smoothed one-hot labels mixed by
the lam the box actually covers.

The random draws of one call (`mixup_draws`) are a dict of tensors of n
entries, n = 1 (batch), B (elem) or B // 2 (pair):
  "mix"     bool, uniform < prob (the clip mixes at all);
  "switch"  bool, uniform < switch_prob (cutmix rather than mixup, when
            both are on);
  "lam_mix" / "lam_cut"  float32 Beta(alpha, alpha) draws of the modes
            that are on;
  "cy", "cx"  int box centres in [0, H) and [0, W); or, with
            `cutmix_minmax`, "cut_h", "cut_w", "y1", "x1".
`mixup_cutmix` is a deterministic function of the clips, the labels and
these draws, so a test can pass the draws the JAX package's key chain
gives. The Beta draws come from the generator on its own device
(Marsaglia and Tsang's gamma sampler), so a card generator never makes
the host wait.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class MixupConfig:
    mixup_alpha: float = 0.8
    cutmix_alpha: float = 1.0
    prob: float = 1.0
    switch_prob: float = 0.5  # P(cutmix | mixing)
    label_smoothing: float = 0.1
    num_classes: int = 400
    mode: str = "batch"  # batch | pair | elem
    cutmix_minmax: Optional[Tuple[float, float]] = None

    def __post_init__(self):
        if self.mode not in ("batch", "pair", "elem"):
            raise ValueError(f"--mixup_mode must be batch|pair|elem, got {self.mode!r}")
        if self.cutmix_minmax is not None and len(self.cutmix_minmax) != 2:
            raise ValueError("--cutmix_minmax takes exactly two ratios")
        if self.cutmix_minmax is not None:
            # ref mixup.py:116-118: minmax active forces cutmix_alpha=1.0
            object.__setattr__(self, "cutmix_alpha", 1.0)

    @property
    def enabled(self) -> bool:
        return self.mixup_alpha > 0 or self.cutmix_alpha > 0


def _smooth_one_hot(labels: torch.Tensor, num_classes: int, smoothing: float) -> torch.Tensor:
    on = 1.0 - smoothing + smoothing / num_classes
    off = smoothing / num_classes
    return F.one_hot(labels.long(), num_classes).float() * (on - off) + off


def _gamma(alpha: float, n: int, generator: torch.Generator, device, tries: int = 16) -> torch.Tensor:
    """n Gamma(alpha, 1) draws by Marsaglia and Tsang's method, each the
    first of `tries` candidates that passes (a candidate fails with
    probability under 5 % at shape >= 1); shapes below 1 take the boost
    Gamma(alpha + 1) U^(1/alpha)."""
    a = alpha + 1.0 if alpha < 1.0 else alpha
    d = a - 1.0 / 3.0
    c = 1.0 / math.sqrt(9.0 * d)
    x = torch.randn((tries, n), generator=generator, device=device)
    u = torch.rand((tries, n), generator=generator, device=device)
    v = (1.0 + c * x) ** 3
    ok = (v > 0) & (u.log() < 0.5 * x * x + d - d * v + d * v.clamp_min(1e-30).log())
    first = ok.float().argmax(dim=0, keepdim=True)
    g = (d * v.gather(0, first)[0]).clamp_min(1e-30)
    if alpha < 1.0:
        g = g * torch.rand(n, generator=generator, device=device).pow(1.0 / alpha)
    return g


def _beta(alpha: float, n: int, generator: torch.Generator, device) -> torch.Tensor:
    x, y = _gamma(alpha, n, generator, device), _gamma(alpha, n, generator, device)
    return x / (x + y)


def mixup_draws(batch: int, height: int, width: int, cfg: MixupConfig,
                generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """The random draws of one `mixup_cutmix` call on `batch` clips of
    height x width (module docstring), from `generator`, on its device."""
    dev = generator.device
    n = {"batch": 1, "elem": batch, "pair": batch // 2}[cfg.mode]
    d = {"mix": torch.rand(n, generator=generator, device=dev) < cfg.prob,
         "switch": torch.rand(n, generator=generator, device=dev) < cfg.switch_prob}
    if cfg.mixup_alpha > 0:
        d["lam_mix"] = _beta(cfg.mixup_alpha, n, generator, dev)
    if cfg.cutmix_alpha > 0:
        d["lam_cut"] = _beta(cfg.cutmix_alpha, n, generator, dev)
    if cfg.cutmix_minmax is not None:
        lo, hi = cfg.cutmix_minmax
        for key, size in (("cut_h", height), ("cut_w", width)):
            low = int(size * lo)
            d[key] = torch.randint(low, max(int(size * hi), low + 1), (n,), generator=generator, device=dev)
        for key, size, cut in (("y1", height, d["cut_h"]), ("x1", width, d["cut_w"])):
            d[key] = (torch.rand(n, generator=generator, device=dev) * (size - cut)).long()
    else:
        d["cy"] = torch.randint(0, height, (n,), generator=generator, device=dev)
        d["cx"] = torch.randint(0, width, (n,), generator=generator, device=dev)
    return d


def _boxes(d: Dict[str, torch.Tensor], H: int, W: int, lam: torch.Tensor, cfg: MixupConfig):
    """(y1, y2, x1, x2, corrected lam) per draw. The square box's side is
    the frame's times sqrt(1 - lam), truncated to an integer in float32,
    as `jnp`'s astype does; its corners are clipped to the frame."""
    if cfg.cutmix_minmax is not None:
        y1, x1 = d["y1"], d["x1"]
        y2, x2 = y1 + d["cut_h"], x1 + d["cut_w"]
    else:
        ratio = torch.sqrt(1.0 - lam.float())
        cut_h, cut_w = (H * ratio).to(torch.int64), (W * ratio).to(torch.int64)
        y1 = (d["cy"] - cut_h // 2).clamp(0, H)
        y2 = (d["cy"] + cut_h // 2).clamp(0, H)
        x1 = (d["cx"] - cut_w // 2).clamp(0, W)
        x2 = (d["cx"] + cut_w // 2).clamp(0, W)
    lam_box = 1.0 - ((y2 - y1) * (x2 - x1)) / (H * W)
    return y1, y2, x1, x2, lam_box.float()


def _elem_params(d: Dict[str, torch.Tensor], cfg: MixupConfig):
    """Per-draw (lam, use_cutmix) of the elem and pair modes; lam is 1
    where the clip does not mix."""
    if cfg.mixup_alpha > 0 and cfg.cutmix_alpha > 0:
        use_cutmix = d["switch"]
        lam_mix = torch.where(use_cutmix, d["lam_cut"], d["lam_mix"])
    elif cfg.mixup_alpha > 0:
        use_cutmix = torch.zeros_like(d["switch"])
        lam_mix = d["lam_mix"]
    else:
        use_cutmix = torch.ones_like(d["switch"])
        lam_mix = d["lam_cut"]
    lam = torch.where(d["mix"], lam_mix.float(), torch.ones_like(lam_mix, dtype=torch.float32))
    return lam, use_cutmix


def _mix_elemwise(videos: torch.Tensor, lam: torch.Tensor, use_cutmix: torch.Tensor, boxes,
                  pair_axes_quirk: bool = False):
    """Clip i mixes with the unmixed clip B-1-i under its own (lam,
    use_cutmix, box). Returns (mixed videos, per-clip corrected lam).

    `pair_axes_quirk` keeps a reference bug of the pair mode: timm's
    `_mix_pair` slices `x[i][:, yl:yh, xl:xh]`, written for [C, H, W]
    images; on [C, T, H, W] clips that cuts the box along (T, H) with every
    column, usually an empty region since yl is drawn from [0, H) and
    H >> T, while lam is still corrected by the (H, W) box's area."""
    T, H, W = videos.shape[1:4]
    flipped = videos.flip(0)
    y1, y2, x1, x2, lam_box = boxes
    # a minmax box does not depend on lam; a clip that does not mix keeps
    # no box (the reference's `if lam != 1.` guard)
    use_box = use_cutmix & (lam != 1.0)

    def e(t):
        return t.view(-1, 1, 1, 1, 1)

    dev = videos.device
    if pair_axes_quirk:
        frm = torch.arange(T, device=dev).view(1, T, 1, 1, 1)
        row = torch.arange(H, device=dev).view(1, 1, H, 1, 1)
        box = (frm >= e(y1)) & (frm < e(y2)) & (row >= e(x1)) & (row < e(x2))
    else:
        row = torch.arange(H, device=dev).view(1, 1, H, 1, 1)
        col = torch.arange(W, device=dev).view(1, 1, 1, W, 1)
        box = (row >= e(y1)) & (row < e(y2)) & (col >= e(x1)) & (col < e(x2))
    box = box & e(use_box)
    mixed_mix = videos * e(lam) + flipped * (1.0 - e(lam))
    out = torch.where(box, flipped, torch.where(e(use_cutmix), videos, mixed_mix))
    return out, torch.where(use_box, lam_box, lam)


def mixup_cutmix(videos: torch.Tensor, labels: torch.Tensor, cfg: MixupConfig,
                 generator: Optional[torch.Generator] = None,
                 draws: Optional[Dict[str, torch.Tensor]] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """videos [B, T, H, W, C], integer labels [B] -> (mixed videos, soft
    targets [B, num_classes] float32), with `draws` or draws from
    `generator`. Without mixing (`cfg.enabled` false) the clips pass
    through with the smoothed one-hot targets."""
    B, T, H, W, _ = videos.shape
    targets = _smooth_one_hot(labels, cfg.num_classes, cfg.label_smoothing)
    if not cfg.enabled:
        return videos, targets
    if draws is None:
        if generator is None:
            raise ValueError("mixup_cutmix needs a torch.Generator or explicit draws")
        draws = mixup_draws(B, H, W, cfg, generator)
    d = {k: v.to(videos.device) for k, v in draws.items()}
    t_flipped = targets.flip(0)

    if cfg.mode in ("elem", "pair"):
        lam, use_cutmix = _elem_params(d, cfg)
        boxes = _boxes(d, H, W, lam, cfg)
        if cfg.mode == "pair":
            # B//2 draws mirrored, so clips i and B-1-i share them
            lam, use_cutmix = (torch.cat([v, v.flip(0)]) for v in (lam, use_cutmix))
            boxes = tuple(torch.cat([v, v.flip(0)]) for v in boxes)
        out, lam_out = _mix_elemwise(videos, lam, use_cutmix, boxes, pair_axes_quirk=cfg.mode == "pair")
        lam_t = lam_out[:, None]
        return out.to(videos.dtype), targets * lam_t + t_flipped * (1.0 - lam_t)

    dev = videos.device
    use_mixing = d["mix"][0]
    if cfg.cutmix_alpha <= 0:
        use_cutmix = torch.zeros((), dtype=torch.bool, device=dev)
    elif cfg.mixup_alpha <= 0:
        use_cutmix = torch.ones((), dtype=torch.bool, device=dev)
    else:
        use_cutmix = d["switch"][0]
    one = torch.ones((), dtype=torch.float32, device=dev)
    lam_mix = d["lam_mix"][0].float() if cfg.mixup_alpha > 0 else one
    lam_cut = d["lam_cut"][0].float() if cfg.cutmix_alpha > 0 else one

    flipped = videos.flip(0)
    mixed_mix = videos * lam_mix + flipped * (1.0 - lam_mix)
    y1, y2, x1, x2, lam_cut_c = (v[0] for v in _boxes(d, H, W, lam_cut.view(1), cfg))
    row = torch.arange(H, device=dev)[:, None]
    col = torch.arange(W, device=dev)[None, :]
    box = ((row >= y1) & (row < y2) & (col >= x1) & (col < x2))[None, None, :, :, None]
    mixed_cut = torch.where(box, flipped, videos)

    lam = torch.where(use_cutmix, lam_cut_c, lam_mix)
    mixed = torch.where(use_cutmix, mixed_cut, mixed_mix)
    out_videos = torch.where(use_mixing, mixed, videos)
    out_targets = torch.where(use_mixing, targets * lam + t_flipped * (1.0 - lam), targets)
    return out_videos.to(videos.dtype), out_targets
