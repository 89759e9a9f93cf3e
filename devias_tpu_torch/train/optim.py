"""Optimizers with layer-decay learning-rate scales, the agg-block scale,
no-decay groups and per-step cosine schedules (port of
`devias_tpu/train/optim.py`: FusedAdamW and the optax chains of `--opt
adam|sgd|nesterov|momentum`).

Rules, per parameter name of the port (reference layout):
* layer id: `cls_token`, `pos_embed`, `patch_embed.*` -> 0; `blocks.{i}.*`
  -> i + 1; everything else -> num_layers + 1, the multi-task
  `scene_token` too (the reference's quirk, `devias_tpu/train/optim.py:
  65-69`). With layer_decay < 1 the lr scale is layer_decay **
  (num_layers + 1 - id).
* anything under `agg_block.` takes `agg_block_scale` instead.
* no weight decay on 1-D tensors, on `*bias` and on `NO_DECAY_NAMES`.

Every update reads lr and wd from the schedules at the optimizer's own
count c (from 0), first clips the gradients by their global norm when
`clip_grad` is set, as the optax chains do, and ends with p += -(lr *
scale) u; `step()` returns the global norm of the gradients before
clipping, as a device tensor. State is float32 and the parameters are
float32 masters. u is, per `--opt`:
* adamw (FusedAdamW, `optim.py:172-184`, `:205-221`): m = b1 m + (1 - b1)
  g, v = b2 v + (1 - b2) g^2, u = (m / (1 - b1^(c+1))) / (sqrt(v / (1 -
  b2^(c+1))) + eps) + wd p [decay];
* adam (`optim.py:263-270`): the same moments of g + wd p [decay] (L2
  weight decay folded into the gradient, as torch.optim.Adam does), and
  no decoupled term;
* sgd, nesterov, momentum (`optim.py:252-261`): with g' = g + wd p
  [decay] (L2, before the momentum buffer, as torch.optim.SGD does), the
  buffer t = g' + momentum t; u = g' + momentum t for sgd and nesterov
  (`optax.trace(nesterov=True)`, which differs from torch.optim.SGD's
  in-place form only in where the lr is applied), u = t for momentum.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterable, Optional, Tuple

import torch
from torch import nn

from devias_tpu_torch.core.schedules import cosine_schedule
from devias_tpu_torch.device import DeviceLike, require_on, resolve_device

# the port's names of the JAX list's pos_embed, cls_token and suffix_tokens
NO_DECAY_NAMES = ("pos_embed", "cls_token", "scene_token")


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
    opt: str = "adamw"  # adamw | adam | sgd | nesterov | momentum
    momentum: float = 0.9  # the SGD family only


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


class ScheduledOptimizer(torch.optim.Optimizer):
    """The part every optimizer of the port shares: one lr scale and one
    decay flag per parameter, scheduled lr and weight decay read at the
    update count, the global-norm clip, and a state dict that carries the
    count. One parameter group; a subclass names its float32 buffers in
    BUFFERS (kept in `self.state[p]`) and defines `_update(params, grads,
    lr, wd)`, which returns the step's unscaled update u of each
    parameter."""

    BUFFERS: Tuple[str, ...] = ()

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
            for buf in self.BUFFERS:
                self.state[p][buf] = torch.zeros_like(p, dtype=torch.float32)

    def state_dict(self) -> dict:
        """torch's optimizer state dict plus the update count the schedules
        and bias corrections read."""
        return {**super().state_dict(), "count": self.count}

    def load_state_dict(self, state_dict: dict) -> None:
        state_dict = dict(state_dict)
        count = int(state_dict.pop("count"))
        super().load_state_dict(state_dict)
        self.count = count

    def _buffers(self, name: str):
        return [self.state[p][name] for p in self.param_groups[0]["params"]]

    def _add_l2(self, grads, params, wd: float) -> list:
        """g + wd p on the decayed parameters (new tensors: `grads` may be
        the parameters' own .grad)."""
        grads = list(grads)
        dec = [i for i, d in enumerate(self.decay) if d]
        if dec and wd != 0.0:
            for i, g in zip(dec, torch._foreach_add([grads[i] for i in dec], [params[i] for i in dec], alpha=wd)):
                grads[i] = g
        return grads

    @torch.no_grad()
    def step(self, closure=None) -> torch.Tensor:
        if closure is not None:
            raise ValueError(f"{type(self).__name__} takes no closure")
        cfg = self.cfg
        params = self.param_groups[0]["params"]
        grads = [torch.zeros_like(p, dtype=torch.float32) if p.grad is None else p.grad.float() for p in params]
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        if cfg.clip_grad is not None:
            # optax.clip_by_global_norm, in its order: (g / norm) * clip
            # where norm >= clip
            clipped = torch._foreach_div(grads, norm)
            torch._foreach_mul_(clipped, cfg.clip_grad)
            keep = norm < cfg.clip_grad
            grads = [torch.where(keep, g, c) for g, c in zip(grads, clipped)]
        lr, wd = self.lr_fn(self.count), self.wd_fn(self.count)
        upd = self._update(params, grads, lr, wd)
        torch._foreach_mul_(upd, [-(lr * s) for s in self.scales])
        torch._foreach_add_(params, upd)
        self.count += 1
        return norm


class FusedAdamW(ScheduledOptimizer):
    """AdamW (`--opt adamw`), or Adam with L2 weight decay folded into the
    gradient (`--opt adam`), as `torch._foreach_*` passes over all
    parameters (module docstring)."""

    BUFFERS = ("exp_avg", "exp_avg_sq")

    def _update(self, params, grads, lr: float, wd: float):
        cfg = self.cfg
        l2 = cfg.opt.lower() == "adam"
        if l2:
            grads = self._add_l2(grads, params, wd)
        ms, vs = self._buffers("exp_avg"), self._buffers("exp_avg_sq")
        b1, b2 = cfg.beta1, cfg.beta2
        c = self.count + 1
        bc1, bc2 = 1 - b1 ** c, 1 - b2 ** c
        torch._foreach_mul_(ms, b1)
        torch._foreach_add_(ms, grads, alpha=1 - b1)
        torch._foreach_mul_(vs, b2)
        torch._foreach_addcmul_(vs, grads, grads, value=1 - b2)
        denom = torch._foreach_div(vs, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, cfg.eps)
        upd = torch._foreach_div(ms, bc1)
        torch._foreach_div_(upd, denom)
        if not l2:
            dec = [i for i, d in enumerate(self.decay) if d]
            if dec and wd != 0.0:
                torch._foreach_add_([upd[i] for i in dec], [params[i] for i in dec], alpha=wd)
        return upd


class FusedSGD(ScheduledOptimizer):
    """SGD with momentum and L2 weight decay: Nesterov for `--opt sgd` and
    `--opt nesterov`, heavy ball for `--opt momentum` (module docstring)."""

    BUFFERS = ("momentum_buffer",)

    def _update(self, params, grads, lr: float, wd: float):
        grads = self._add_l2(grads, params, wd)
        trace = self._buffers("momentum_buffer")
        mu = self.cfg.momentum
        torch._foreach_mul_(trace, mu)
        torch._foreach_add_(trace, grads)
        if self.cfg.opt.lower() == "momentum":
            return [t.clone() for t in trace]
        return torch._foreach_add(grads, trace, alpha=mu)


_OPTIMIZERS = {"adamw": FusedAdamW, "adam": FusedAdamW, "sgd": FusedSGD, "nesterov": FusedSGD,
               "momentum": FusedSGD}


def make_optimizer(model: nn.Module, cfg: OptimConfig,
                   device: DeviceLike = None) -> Tuple[ScheduledOptimizer, Callable[[int], float]]:
    """(optimizer, lr_fn) over `model`'s parameters, which must lie on
    `device` (`cuda` unless the caller asks for `cpu`): FusedAdamW for
    `cfg.opt` adamw and adam, FusedSGD for sgd, nesterov and momentum.
    lr_fn is the lr schedule, for logging."""
    require_on(model, resolve_device(device))
    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    cls = _OPTIMIZERS.get(cfg.opt.lower())
    if cls is None:
        # the reference's optim_factory dispatches on --opt
        # (ref utils/optim_factory.py:96-181); fail loudly on another value
        raise ValueError(f"--opt {cfg.opt!r} is not supported (supported: {', '.join(_OPTIMIZERS)})")
    lr_fn = cosine_schedule(cfg.lr, cfg.min_lr, cfg.total_steps, cfg.warmup_steps, cfg.warmup_lr)
    wd_end = cfg.weight_decay_end if cfg.weight_decay_end is not None else cfg.weight_decay
    wd_fn = cosine_schedule(cfg.weight_decay, wd_end, cfg.total_steps, 0)
    return cls(named, cfg, lr_fn, wd_fn), lr_fn
