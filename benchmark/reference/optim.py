"""AdamW as the DEVIAS recipe runs it, plain float32 (a frozen copy of the
arithmetic of the port's `train/optim.py` FusedAdamW and
`core/schedules.py`): layer-wise lr decay, the agg block's own lr scale,
no decay on 1-D tensors and biases, lr and weight decay read from per-step
cosine schedules with a linear warm-up at the update count.
"""

from __future__ import annotations

import math
from typing import Callable, Dict

import torch


def cosine(base: float, final: float, total: int, warmup: int = 0, start: float = 0.0) -> Callable[[int], float]:
    n = max(total - warmup, 1)

    def fn(step: int) -> float:
        if step < warmup:
            return start + (base - start) * step / (warmup - 1) if warmup > 1 else base
        i = min(max(step - warmup, 0), n - 1)
        return final + 0.5 * (base - final) * (1.0 + math.cos(math.pi * i / n))

    return fn


def schedule(optim: dict) -> Dict[str, object]:
    """The recipe's numbers (`optim` of a configuration file) as the CLI
    derives them: lr scaled by the global batch over 256, steps per epoch
    from the training set over the global batch."""
    steps_per_epoch = optim["train_clips"] // optim["global_batch"]
    total = optim["epochs"] * steps_per_epoch
    lr = optim["lr"] * optim["global_batch"] / 256.0
    return {"lr": lr, "total_steps": total, "warmup_steps": optim["warmup_epochs"] * steps_per_epoch,
            "lr_fn": cosine(lr, optim["min_lr"], total, optim["warmup_epochs"] * steps_per_epoch, optim["warmup_lr"]),
            "wd_fn": cosine(optim["weight_decay"], optim["weight_decay"], total, 0)}


def lr_scale(name: str, optim: dict, depth: int) -> float:
    head = name.split(".")[0]
    if head == "agg_block":
        return optim["agg_block_scale"]
    if optim["layer_decay"] < 1.0:
        lid = 0 if head in ("cls_token", "pos_embed", "patch_embed") else (
            int(name.split(".")[1]) + 1 if head == "blocks" else depth + 1)
        return optim["layer_decay"] ** (depth + 1 - lid)
    return 1.0


def decays(name: str, p: torch.Tensor) -> bool:
    if p.dim() <= 1 or name.endswith("bias"):
        return False
    return not any(part in ("pos_embed", "cls_token", "scene_token") for part in name.split("."))


class AdamW:
    def __init__(self, named: Dict[str, torch.Tensor], optim: dict, depth: int):
        self.params = named
        self.sched = schedule(optim)
        self.b1, self.b2, self.eps = optim.get("beta1", 0.9), optim.get("beta2", 0.999), optim.get("eps", 1e-8)
        self.scale = {n: lr_scale(n, optim, depth) for n in named}
        self.decay = {n: decays(n, p) for n, p in named.items()}
        self.m = {n: torch.zeros_like(p) for n, p in named.items()}
        self.v = {n: torch.zeros_like(p) for n, p in named.items()}
        self.count = 0

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]) -> None:
        lr, wd = self.sched["lr_fn"](self.count), self.sched["wd_fn"](self.count)
        c = self.count + 1
        bc1, bc2 = 1 - self.b1 ** c, 1 - self.b2 ** c
        for n, p in self.params.items():
            g = grads[n]
            self.m[n].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.v[n].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            u = (self.m[n] / bc1) / ((self.v[n] / bc2).sqrt() + self.eps)
            if self.decay[n] and wd != 0.0:
                u = u + wd * p
            p.add_(u, alpha=-(lr * self.scale[n]))
        self.count += 1
