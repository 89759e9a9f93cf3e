"""AdamW with layer-decay learning-rate scales, the agg-block scale,
no-decay groups and per-step cosine schedules (port of
`devias_tpu/train/optim.py`, the AdamW path).

Rules, per parameter name of the port (reference layout):
* layer id: `cls_token`, `pos_embed`, `patch_embed.*` -> 0; `blocks.{i}.*`
  -> i + 1; everything else -> num_layers + 1. With layer_decay < 1 the lr
  scale is layer_decay ** (num_layers + 1 - id).
* anything under `agg_block.` takes `agg_block_scale` instead.
* no weight decay on 1-D tensors, on `*bias` and on `NO_DECAY_NAMES`.

The update is FusedAdamW's (`optim.py:172-184`, `:205-221`): with
c = count + 1, m = b1 m + (1 - b1) g, v = b2 v + (1 - b2) g^2,
u = (m / (1 - b1^c)) / (sqrt(v / (1 - b2^c)) + eps) + wd p [decay], then
p += -(lr * scale) u, with lr and wd from the schedules at the optimizer's
own count. With `clip_grad` the gradients are first clipped by their global
norm, as the optax chain does. `step()` returns the global norm of the
gradients before clipping, as a device tensor. Moments are float32 and the
parameters float32 masters.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterable, Optional, Tuple

import torch
from torch import nn

from devias_tpu_torch.core.schedules import cosine_schedule
from devias_tpu_torch.device import DeviceLike, require_on, resolve_device

NO_DECAY_NAMES = ("pos_embed", "cls_token", "suffix_tokens")


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    lr: float = 5e-4  # already scaled by total_batch/256 by the caller
    min_lr: float = 1e-6
    warmup_lr: float = 1e-6
    weight_decay: float = 0.05
    weight_decay_end: Optional[float] = None
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8
    layer_decay: float = 1.0  # < 1 enables layer-wise decay
    agg_block_scale: float = 1.0  # recipe: 0.1 for slot training
    num_layers: int = 12
    total_steps: int = 1000
    warmup_steps: int = 0
    clip_grad: Optional[float] = None
    opt: str = "adamw"  # only adamw is ported; adam, sgd, nesterov, momentum raise


def layer_id(name: str, num_layers: int) -> int:
    parts = name.split(".")
    if parts[0] in ("cls_token", "pos_embed", "patch_embed"):
        return 0
    if parts[0] == "blocks":
        return int(parts[1]) + 1
    return num_layers + 1


def lr_scale(name: str, cfg: OptimConfig) -> float:
    if name.split(".")[0] == "agg_block":
        return cfg.agg_block_scale
    if cfg.layer_decay < 1.0:
        return cfg.layer_decay ** (cfg.num_layers + 1 - layer_id(name, cfg.num_layers))
    return 1.0


def decays(name: str, param: torch.Tensor) -> bool:
    if param.dim() <= 1 or name.endswith("bias"):
        return False
    return not any(part in NO_DECAY_NAMES for part in name.split("."))


class FusedAdamW(torch.optim.Optimizer):
    """AdamW with one lr scale and one decay flag per parameter and
    scheduled lr and weight decay (module docstring). One parameter group;
    the update runs as `torch._foreach_*` passes over all parameters."""

    def __init__(self, named_params: Iterable[Tuple[str, nn.Parameter]], cfg: OptimConfig,
                 lr_fn: Callable[[int], float], wd_fn: Callable[[int], float]):
        named = list(named_params)
        super().__init__([p for _, p in named], {})
        self.cfg, self.lr_fn, self.wd_fn = cfg, lr_fn, wd_fn
        self.names = [n for n, _ in named]
        self.scales = [lr_scale(n, cfg) for n in self.names]
        self.decay = [decays(n, p) for n, p in named]
        self.count = 0
        for _, p in named:
            self.state[p]["exp_avg"] = torch.zeros_like(p, dtype=torch.float32)
            self.state[p]["exp_avg_sq"] = torch.zeros_like(p, dtype=torch.float32)

    @torch.no_grad()
    def step(self, closure=None) -> torch.Tensor:
        if closure is not None:
            raise ValueError("FusedAdamW takes no closure")
        cfg = self.cfg
        params = self.param_groups[0]["params"]
        grads = [torch.zeros_like(p, dtype=torch.float32) if p.grad is None else p.grad.float() for p in params]
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        if cfg.clip_grad is not None:
            # optax.clip_by_global_norm: g * clip / norm where norm >= clip
            factor = torch.where(norm < cfg.clip_grad, torch.ones_like(norm), cfg.clip_grad / norm)
            grads = torch._foreach_mul(grads, factor)
        ms = [self.state[p]["exp_avg"] for p in params]
        vs = [self.state[p]["exp_avg_sq"] for p in params]
        b1, b2 = cfg.beta1, cfg.beta2
        c = self.count + 1
        bc1, bc2 = 1 - b1 ** c, 1 - b2 ** c
        lr, wd = self.lr_fn(self.count), self.wd_fn(self.count)

        torch._foreach_mul_(ms, b1)
        torch._foreach_add_(ms, grads, alpha=1 - b1)
        torch._foreach_mul_(vs, b2)
        torch._foreach_addcmul_(vs, grads, grads, value=1 - b2)
        denom = torch._foreach_div(vs, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, cfg.eps)
        upd = torch._foreach_div(ms, bc1)
        torch._foreach_div_(upd, denom)
        dec = [i for i, d in enumerate(self.decay) if d]
        if dec and wd != 0.0:
            torch._foreach_add_([upd[i] for i in dec], [params[i] for i in dec], alpha=wd)
        torch._foreach_mul_(upd, [-(lr * s) for s in self.scales])
        torch._foreach_add_(params, upd)
        self.count += 1
        return norm


def make_optimizer(model: nn.Module, cfg: OptimConfig,
                   device: DeviceLike = None) -> Tuple[FusedAdamW, Callable[[int], float]]:
    """(optimizer, lr_fn) over `model`'s parameters, which must lie on
    `device` (`cuda` unless the caller asks for `cpu`). lr_fn is the lr
    schedule, for logging."""
    require_on(model, resolve_device(device))
    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    opt = cfg.opt.lower()
    if opt in ("adam", "sgd", "nesterov", "momentum"):
        raise NotImplementedError(f"--opt {cfg.opt!r} is not ported yet; the port has adamw")
    if opt != "adamw":
        raise ValueError(f"--opt {cfg.opt!r} is not supported (supported: adamw)")
    lr_fn = cosine_schedule(cfg.lr, cfg.min_lr, cfg.total_steps, cfg.warmup_steps, cfg.warmup_lr)
    wd_end = cfg.weight_decay_end if cfg.weight_decay_end is not None else cfg.weight_decay
    wd_fn = cosine_schedule(cfg.weight_decay, wd_end, cfg.total_steps, 0)
    return FusedAdamW(named, cfg, lr_fn, wd_fn), lr_fn
