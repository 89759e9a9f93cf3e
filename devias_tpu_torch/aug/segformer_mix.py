"""Segformer-driven background mixing for slot training (port of
`devias_tpu/aug/segformer_mix.py`; ref engine/engine_for_slot.py:16-47,
108-118):

  * the frozen SegFormer runs on every OTHER frame of the clip (8 of 16)
    on the clips as the step holds them, normalized (a reference quirk:
    no SegFormer-specific preprocessing)
  * quarter-res logits are upsampled x4, argmax == person (11)
  * the per-frame masks are repeated x2 in time and the clips mixed
    against a batch permutation: videos[perm]*(1-m) + videos*m
  * each sample takes the mix with probability `prob_aug`
  * the masks average-pool to the patch grid: `fg_mask` is ONE randomly
    chosen frame's pooled mask (one shared frame index, as the reference's
    torch.randint(0, 8, (1,))), `fg_masks_per_frames` all of them.

Layout: channels-last [B, T, H, W, C]. The three draws (the permutation,
the keeps and the frame index) come from a `torch.Generator` or are
passed as `draws`.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from devias_tpu_torch.nn.segformer import person_masks
from devias_tpu_torch.utils.profiling import count


def segformer_frame_masks(apply_fn: Callable, videos: torch.Tensor) -> torch.Tensor:
    """Person masks of every other frame: `apply_fn` [N, H, W, 3] ->
    quarter-res logits, run without gradients; videos [B, T, H, W, C];
    returns float32 masks [B, T//2, H, W]. Counts the frames masked
    (`mask_frames`)."""
    B, T, H, W, C = videos.shape
    count("mask_frames", B * (T // 2))
    frames = videos[:, ::2].reshape(B * (T // 2), H, W, C)
    with torch.no_grad():
        logits = apply_fn(frames)
    return person_masks(logits, (H, W)).reshape(B, T // 2, H, W).float()


def segformer_draws(batch: int, frames: int, prob_aug: float, generator: torch.Generator,
                    device: torch.device) -> Dict[str, torch.Tensor]:
    """The donor permutation, the per-sample keeps and the shared frame
    index of one mix over `frames` mask frames."""
    perm = torch.randperm(batch, generator=generator, device=device)
    if prob_aug < 1:
        keep = torch.rand(batch, generator=generator, device=device) < prob_aug
    else:
        keep = torch.ones(batch, dtype=torch.bool, device=device)
    frame = torch.randint(0, frames, (), generator=generator, device=device)
    return {"perm": perm, "keep": keep, "frame": frame}


def segformer_mix_sample(masks: torch.Tensor, videos: torch.Tensor, labels: torch.Tensor, prob_aug: float = 0.5,
                         patch_size: int = 16, generator: Optional[torch.Generator] = None,
                         draws: Optional[Dict[str, torch.Tensor]] = None):
    """Mix batch backgrounds behind per-frame person masks. masks
    [B, T/2, H, W] float, videos [B, T, H, W, C]. Returns (videos, labels,
    (fg_mask [B, N], fg_masks_per_frames [B, T/2 N])), N = (H/p)(W/p).
    `draws` ({"perm", "keep", "frame"}) fixes the draws; without it they
    come from `generator`."""
    B, T, H, W, C = videos.shape
    Th = masks.shape[1]
    if draws is None:
        if generator is None:
            raise ValueError("the segformer mix needs a torch.Generator or explicit draws")
        draws = segformer_draws(B, Th, prob_aug, generator, videos.device)
    perm, keep, frame = (draws[k].to(videos.device) for k in ("perm", "keep", "frame"))
    m = masks.repeat_interleave(2, dim=1)[..., None]  # [B, T, H, W, 1]
    fused = videos[perm] * (1.0 - m) + videos * m
    videos_out = torch.where(keep.view(-1, 1, 1, 1, 1), fused, videos).to(videos.dtype)
    gh, gw = H // patch_size, W // patch_size
    pooled = masks.reshape(B, Th, gh, patch_size, gw, patch_size).mean(dim=(3, 5))
    fg_mask = pooled.index_select(1, frame.view(1).long())[:, 0]
    return videos_out, labels, (fg_mask.reshape(B, -1), pooled.reshape(B, -1))
