"""The reference's train steps and eval forward, in blocks of rows.

`run_train` follows the program's first steps from the same weights, clips,
labels, FAME draws and drop-path draws: FAME on the whole batch (and, for
HVU, the donor's scene label where a sample is mixed), the teacher's logits
and their batch minimum, then the student, the loss and its backward in
blocks of `rows` clips with the gradients summed, then AdamW. It returns
what the check compares: each step's loss and terms, each leaf's gradient
norm at step 1 and each leaf's change after the last step; and each step's
smallest margin of the slot matching (an argmin over slot pairs) and of
the teacher's argmax, by which a near-tie can be told.

`half=True` is a planted fault: the model and the loss see only the first
half of each batch, the mean taken over that half.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from harness import spec
from reference import fame as ref_fame
from reference import losses as ref_losses
from reference import model as ref_model
from reference.optim import AdamW

# near-ties of the first step's discrete choices that bfloat16 rounding can
# resolve the other way: the matching's cost margin (probabilities, of the
# order of 1e-3 at these widths) and the teacher's top-two logit gap; at
# most MAX_TIES of them, whose 2**MAX_TIES subsets the check searches whole
MATCH_TIE = 1e-4
TEACHER_TIE = 0.05
MAX_TIES = 12


def _load(model: torch.nn.Module, weights: Dict[str, torch.Tensor], requires_grad: bool) -> None:
    params = dict(model.named_parameters())
    if set(params) != set(weights):
        raise ValueError(f"reference and weights differ: {sorted(set(params) ^ set(weights))[:6]}")
    with torch.no_grad():
        for n, p in params.items():
            p.copy_(weights[n])
            p.requires_grad_(requires_grad)


def build(cfg: dict, weights: Dict[str, Dict[str, torch.Tensor]], device, quant: Optional[str] = None):
    """(student, teacher or None) in float32 on `device` with `weights`,
    each the reference of its model file (`models/<name>.py`)."""
    student = spec.model(cfg["model"]["name"]).reference(cfg["model"]).to(device)
    _load(student, weights["model"], True)
    teacher = None
    if cfg.get("teacher"):
        teacher = spec.model(cfg["teacher"]["name"]).reference(cfg["teacher"]).to(device).eval()
        _load(teacher, weights["teacher"], False)
    for m in (student, teacher):
        if m is not None:
            ref_model.set_quant(m, quant)
    return student, teacher


def _blocks(n: int, rows: int):
    return [slice(i, min(i + rows, n)) for i in range(0, n, rows)]


def run_train(cfg: dict, weights, batches: List[dict], drop_keeps: List[dict], device, rows: int = 4,
              quant: Optional[str] = None, half: bool = False) -> dict:
    """`batches[s]`: {"videos", "labels", ["scene_labels"], "perm", "keep"}
    on `device`; `drop_keeps[s]`: {block: (attn keep [B], mlp keep [B])}.
    Returns {"steps": [{"loss", term: value}], "grad_norms": {leaf: norm}
    at step 1, "change_norms": {leaf: norm} after the last step, "margins"
    and "teacher_margins": each step's smallest, "first_step": the first
    step's terms and gradients with its near-ties (`_near_ties`)}."""
    student, teacher = build(cfg, weights, device, quant)
    params = dict(student.named_parameters())
    opt = AdamW(params, cfg["optim"], cfg["model"]["depth"])
    depth = cfg["model"]["depth"]
    loss_cfg = {**cfg["loss"], "num_action_classes": cfg["model"]["num_classes"]}
    hvu = teacher is None
    out = {"steps": []}
    for s, batch in enumerate(batches):
        B = batch["videos"].shape[0]
        n = B // 2 if half else B
        with torch.no_grad():
            mixed, fg, pf = ref_fame.fame(batch["videos"], {"perm": batch["perm"], "keep": batch["keep"]},
                                          cfg["fame"]["beta"])
        labels = batch["labels"]
        scene = t_logits = t_min = None
        t_gap = torch.full((B,), float("inf"), device=device)
        if hvu:
            scene = batch["scene_labels"]
            if cfg["fame"]["prob_aug"] < 1:
                scene = torch.where(batch["keep"], scene[batch["perm"]], scene)
        else:
            with torch.no_grad():
                t_logits = torch.cat([teacher(mixed[sl]) for sl in _blocks(n, rows)])
            t_min = t_logits.min()
            top2 = t_logits.topk(2, dim=-1).values
            t_gap = top2[:, 0] - top2[:, 1]
            out.setdefault("teacher_margins", []).append(float(t_gap.min()))

        def terms_of(sl, alt=None):
            masks = [None] * depth
            for i, (ka, km) in drop_keeps[s].items():
                masks[i] = (ka[sl], km[sl])
            res = student(mixed[sl], masks)
            if hvu:
                return ref_losses.hvu_loss(res, labels[sl], scene[sl], fg[sl], pf[sl], loss_cfg, alt)
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


def _near_ties(terms_of, params, margin, t_gap, n: int) -> List[dict]:
    """The first step's near-ties, nearest first: each sample whose slot
    matching lies within MATCH_TIE of its next pair, or whose teacher argmax
    lies within TEACHER_TIE of its next class (up to MAX_TIES samples), with
    the change of the step's terms and gradients (None for a leaf it does
    not reach) if that sample took its next pair (with two slots, the
    other assignment), computed on that sample alone."""
    closeness = torch.minimum(margin / MATCH_TIE, t_gap / TEACHER_TIE)
    near = [i for i in closeness.argsort().tolist() if closeness[i] < 1.0][:MAX_TIES]
    out = []
    for i in near:
        sl = slice(i, i + 1)
        base, _ = terms_of(sl)
        alt, _ = terms_of(sl, torch.ones(1, dtype=torch.bool, device=margin.device))
        for p in params.values():
            p.grad = None
        (sum(alt[k].sum() - base[k].sum() for k in ref_losses.TERMS) / n).backward()
        out.append({"sample": i,
                    "terms": {k: float(alt[k].detach().sum() - base[k].detach().sum()) / n for k in ref_losses.TERMS},
                    "grads": {k: p.grad for k, p in params.items()}})
    for p in params.values():
        p.grad = None
    return out


@torch.no_grad()
def run_eval(cfg: dict, weights, clips: torch.Tensor, device, rows: int = 4, quant: Optional[str] = None) -> dict:
    """Per clip: the student's scene logits of every slot [K, S, Sc], the
    slots' selection criterion [K, S] and the teacher's logits [K, Sc]."""
    student, teacher = build(cfg, weights, device, quant)
    A = cfg["model"]["num_classes"]
    logits, crit, t_logits = [], [], []
    for sl in _blocks(clips.shape[0], rows):
        x = clips[sl].to(device)
        head = student(x)["slots_head"]
        logits.append(head[..., A:].cpu())
        crit.append(ref_model.scene_criterion(head, A).cpu())
        t_logits.append(teacher(x).cpu())
    del student, teacher
    return {"slot_logits": torch.cat(logits), "crit": torch.cat(crit), "teacher": torch.cat(t_logits)}
