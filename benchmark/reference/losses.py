"""The DEVIAS slot losses, plain float32 (a frozen copy of the arithmetic
of the port's `losses/slot_loss.py` at the published 'matching' settings).

Both losses return per-sample terms, so a batch can be run in blocks of
rows: each term of the batch is the sum of its rows' terms over B. The
teacher pad's minimum is the whole batch's, so it is passed in. `alt`
marks samples whose slot matching takes its second-best pair (a near-tie
resolved the other way).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

TERMS = ("action_loss", "scene_loss", "cosine_loss", "mask_prediction_loss", "mask_distill_loss")


def _ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return -logits.log_softmax(dim=-1).gather(-1, labels[:, None])[:, 0]


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return x.gather(1, idx.view(-1, 1, *([1] * (x.dim() - 2))).expand(-1, 1, *x.shape[2:])).squeeze(1)


def match(cost_action: torch.Tensor, cost_scene: torch.Tensor, alt: Optional[torch.Tensor] = None
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The slot pair (i != j) with the least cost_action[i] + cost_scene[j];
    the first such pair in i * S + j order, or where `alt` holds the next
    pair. Also each sample's margin: how far the next pair's cost lies
    above the least."""
    B, S = cost_action.shape
    pair = cost_action[:, :, None] + cost_scene[:, None, :]
    pair = pair.masked_fill(torch.eye(S, dtype=torch.bool, device=pair.device)[None], float("inf"))
    flat = pair.reshape(B, S * S)
    idx = flat.argmin(dim=-1)
    best = flat.topk(2, dim=-1, largest=False, sorted=True)
    if alt is not None:
        other = torch.where(best.indices[:, 0] == idx, best.indices[:, 1], best.indices[:, 0])
        idx = torch.where(alt, other, idx)
    return idx // S, idx % S, best.values[:, 1] - best.values[:, 0]


def _common(out: Dict[str, torch.Tensor], action: torch.Tensor, scene: torch.Tensor, fg_mask, fg_pf,
            w: dict, alt: Optional[torch.Tensor]) -> Tuple[Dict[str, torch.Tensor], torch.Tensor, torch.Tensor]:
    """Per-sample action, mask and cosine terms, the scene slot's logits
    and the matching's margins."""
    head, slots = out["slots_head"], out["slots"]
    attn = out["attn"].mean(dim=1)
    B, S, _ = head.shape
    probs = head.softmax(dim=-1)
    cost_a = -probs.gather(-1, action.view(B, 1, 1).expand(B, S, 1))[..., 0]
    cost_s = -probs.gather(-1, scene.view(B, 1, 1).expand(B, S, 1))[..., 0]
    a_idx, s_idx, margin = match(cost_a, cost_s, alt)
    pred = _take(out["mask_predictions"], a_idx)
    s = slots / slots.norm(dim=-1, keepdim=True).clamp_min(1e-12)
    sim = torch.einsum("bsd,btd->bst", s, s) * (1.0 - torch.eye(S, device=s.device))
    terms = {
        "action_loss": _ce(_take(head, a_idx), action),
        "mask_distill_loss": ((_take(attn, a_idx) - fg_pf) ** 2).mean(dim=-1) * w["mask_distill_loss_weight"],
        # the reference feeds the mask predictor's sigmoid output to BCE as logits
        "mask_prediction_loss": (F.softplus(pred) - pred * fg_mask).mean(dim=-1) * w["mask_prediction_loss_weight"],
        "cosine_loss": sim.sum(dim=(1, 2)) / (S * (S - 1)),
    }
    return terms, _take(head, s_idx), margin.detach()


def slot_loss(out, teacher_logits, labels, fg_mask, fg_pf, loss_cfg: dict, teacher_min, alt=None):
    """Per-sample terms of the K400 slot loss (KL to the padded teacher),
    and the matching's margins."""
    A = loss_cfg["num_action_classes"]
    B = teacher_logits.shape[0]
    padded = torch.cat([(teacher_min - 1.0).expand(B, A), teacher_logits], dim=1)
    scene = teacher_logits.argmax(dim=1) + A
    terms, scene_logits, margin = _common(out, labels, scene, fg_mask, fg_pf, loss_cfg, alt)
    C = scene_logits.shape[-1]
    t, s = padded.log_softmax(dim=-1), scene_logits.log_softmax(dim=-1)
    terms["scene_loss"] = (t.exp() * (t - s)).sum(dim=-1) / C * loss_cfg["scene_loss_weight"]
    return terms, margin


def hvu_loss(out, action, scene, fg_mask, fg_pf, loss_cfg: dict, alt=None):
    """Per-sample terms of the HVU slot loss (cross-entropy to the real
    scene label in the unified head), and the matching's margins."""
    scene = scene + loss_cfg["num_action_classes"]
    terms, scene_logits, margin = _common(out, action, scene, fg_mask, fg_pf, loss_cfg, alt)
    terms["scene_loss"] = _ce(scene_logits, scene)
    return terms, margin
