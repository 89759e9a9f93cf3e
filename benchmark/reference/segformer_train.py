"""The reference's slot train steps with the SegFormer mix
(`--mask_model Segformer`) in FAME's place.

`run_train` follows the program's first steps as `reference/train.py`'s
does (its `build`, `_blocks` and `_near_ties`), from the same weights,
clips, labels, draws and drop-path draws; the one difference is the mix.
Each batch brings its person masks of the even frames ([B, T/2, H, W],
made by the caller from the reference SegFormer) and the draws `perm`,
`keep` and `frame`: where `keep`, the clip becomes
`videos[perm] (1 - m) + videos m`, m the masks repeated over each pair of
frames; `fg_mask` is the masks pooled to the patch grid at the frame
`frame`, `fg_masks_per_frames` all of them pooled. Then the teacher, the
student in blocks of `rows` clips, the slot loss and AdamW, as there.

`half=True` is the planted fault of `reference/train.py`: the model and the
loss see only the first half of each batch.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from reference import fame as ref_fame
from reference import losses as ref_losses
from reference.optim import AdamW
from reference.train import _blocks, _near_ties, build


def mix(videos: torch.Tensor, masks: torch.Tensor, perm: torch.Tensor, keep: torch.Tensor, frame: torch.Tensor):
    """(mixed clips, fg_mask [B, (H/16)(W/16)], fg_pf [B, T/2 (H/16)(W/16)])
    of clips [B, T, H, W, C] behind float masks [B, T/2, H, W]."""
    B = videos.shape[0]
    m = masks.repeat_interleave(2, dim=1)[..., None]
    mixed = videos[perm] * (1.0 - m) + videos * m
    out = torch.where(keep.view(-1, 1, 1, 1, 1), mixed, videos)
    pooled = ref_fame._pool(masks)
    return out, pooled[:, frame].reshape(B, -1), pooled.reshape(B, -1)


def run_train(cfg: dict, weights, batches: List[dict], drop_keeps: List[dict], device, rows: int = 4,
              quant: Optional[str] = None, half: bool = False) -> Dict:
    """`batches[s]`: {"videos", "labels", "masks", "perm", "keep",
    "frame"} on `device`; the rest and what it returns as
    `reference/train.py::run_train` (the configuration has a teacher)."""
    student, teacher = build(cfg, weights, device, quant)
    params = dict(student.named_parameters())
    opt = AdamW(params, cfg["optim"], cfg["model"]["depth"])
    depth = cfg["model"]["depth"]
    loss_cfg = {**cfg["loss"], "num_action_classes": cfg["model"]["num_classes"]}
    out = {"steps": []}
    for s, batch in enumerate(batches):
        B = batch["videos"].shape[0]
        n = B // 2 if half else B
        with torch.no_grad():
            mixed, fg, pf = mix(batch["videos"], batch["masks"], batch["perm"], batch["keep"], batch["frame"])
            t_logits = torch.cat([teacher(mixed[sl]) for sl in _blocks(n, rows)])
        labels = batch["labels"]
        t_min = t_logits.min()
        top2 = t_logits.topk(2, dim=-1).values
        t_gap = top2[:, 0] - top2[:, 1]
        out.setdefault("teacher_margins", []).append(float(t_gap.min()))

        def terms_of(sl, alt=None):
            masks = [None] * depth
            for i, (ka, km) in drop_keeps[s].items():
                masks[i] = (ka[sl], km[sl])
            res = student(mixed[sl], masks)
            return ref_losses.slot_loss(res, t_logits[sl], labels[sl], fg[sl], pf[sl], loss_cfg, t_min, alt)

        sums = {k: 0.0 for k in ref_losses.TERMS}
        margins = []
        for p in params.values():
            p.grad = None
        for sl in _blocks(n, rows):
            terms, margin = terms_of(sl)
            margins.append(margin)
            (sum(t.sum() for t in terms.values()) / n).backward()
            for k in sums:
                sums[k] += float(terms[k].detach().sum()) / n
        sums["loss"] = sum(sums[k] for k in ref_losses.TERMS)
        out["steps"].append(sums)
        margin = torch.cat(margins)
        out.setdefault("margins", []).append(float(margin.min()))
        grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p)) for k, p in params.items()}
        if s == 0:
            out["grad_norms"] = {k: float(g.norm()) for k, g in grads.items()}
            out["first_step"] = {"terms": dict(sums), "grads": {k: g.clone() for k, g in grads.items()},
                                 "near": _near_ties(terms_of, params, margin, t_gap[:n], n)}
        opt.step(grads)
    with torch.no_grad():
        out["change_norms"] = {k: float((p - weights["model"][k]).norm()) for k, p in params.items()}
    del student, teacher, opt, params
    return out
