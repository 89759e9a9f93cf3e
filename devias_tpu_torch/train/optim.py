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
float32 masters.

The per-update scalars are read on the device, so that an update enqueues
no host value that changes from one update to the next and a captured
update replays as the next one (`train/graph.py`): a table on the
parameters' device holds, per count, wd, the bias corrections 1 - b^(c+1)
and -(lr * s) for each distinct scale s, each the Python float
arithmetic's value cast to float32, as a Python scalar reaches the
kernels; a device counter, advanced by the update itself, picks the row.
The host `count` mirrors it and fills the table's rows in chunks, ahead
of the count. Past the table's last row (total_steps) the counter stays
on that row, and the table grows when the schedules' row for the count
differs from it. The weight-decay terms add wd p, rounded on its own, to
u or g. u is, per `--opt`:
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
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from devias_tpu_torch.core.schedules import cosine_schedule
from devias_tpu_torch.device import DeviceLike, require_on, resolve_device

# the port's names of the JAX list's pos_embed, cls_token and suffix_tokens
NO_DECAY_NAMES = ("pos_embed", "cls_token", "scene_token")
# columns of the schedule table: wd, 1 - b1^(c+1), 1 - b2^(c+1), then
# -(lr * s) for each distinct lr scale s
WD, BC1, BC2, LR_SCALED = 0, 1, 2, 3


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
    update count from the device table (module docstring), the global-norm
    clip, and a state dict that carries the count. One parameter group; a
    subclass names its float32 buffers in BUFFERS (kept in
    `self.state[p]`) and defines `_update(params, grads, row)`, which
    returns the step's unscaled update u of each parameter from the
    count's table row (0-d device tensors at `WD`, `BC1`, `BC2`).
    `version` changes whenever the table or the state's tensors are
    replaced."""

    BUFFERS: Tuple[str, ...] = ()
    # rows of the schedule table computed at a time
    TABLE_CHUNK = 2048

    def __init__(self, named_params: Iterable[Tuple[str, nn.Parameter]], cfg: OptimConfig,
                 lr_fn: Callable[[int], float], wd_fn: Callable[[int], float]):
        named = list(named_params)
        super().__init__([p for _, p in named], {})
        self.cfg, self.lr_fn, self.wd_fn = cfg, lr_fn, wd_fn
        self.names = [n for n, _ in named]
        self.scales = [lr_scale(n, cfg) for n in self.names]
        self.decay = [decays(n, p) for n, p in named]
        self.count = 0
        # a placement's cuts (`core/dist.py::shard_train_state`): the
        # buffers of the parameters in `shards` (by index) hold this rank's
        # slice, and the update runs on that slice; under TP the parameters
        # flagged in `cut` hold this rank's part, and their squared norms
        # are summed over `model_group`
        self.shards: Dict[int, Any] = {}
        self.cut: Optional[List[bool]] = None
        self.model_group = None
        for _, p in named:
            for buf in self.BUFFERS:
                self.state[p][buf] = torch.zeros_like(p, dtype=torch.float32)
        # the parameters of each distinct lr scale, by index
        self.scale_values = sorted(set(self.scales))
        self.scale_groups = [[i for i, s in enumerate(self.scales) if s == v] for v in self.scale_values]
        self._device = named[0][1].device if named else torch.device("cpu")
        self.version = 0
        self._counter = torch.zeros((), dtype=torch.int64, device=self._device)
        self._table, self._filled, self._wd_zero = None, 0, True
        self._new_table(max(cfg.total_steps, cfg.warmup_steps + 1, 1))
        self.extend_schedule()

    def _rows(self, start: int, stop: int) -> np.ndarray:
        """The table's rows for counts start..stop-1, float32."""
        b1, b2 = self.cfg.beta1, self.cfg.beta2
        counts = range(start, stop)
        cols = np.array([[self.wd_fn(c) for c in counts], [1 - b1 ** (c + 1) for c in counts],
                         [1 - b2 ** (c + 1) for c in counts]], dtype=np.float64).T
        lr = np.array([self.lr_fn(c) for c in counts], dtype=np.float64)
        scaled = -(lr[:, None] * np.array(self.scale_values, dtype=np.float64)[None, :])
        return np.concatenate([cols, scaled], axis=1).astype(np.float32)

    def _new_table(self, n: int) -> None:
        """A table of n rows that keeps the filled rows of the last one."""
        table = torch.empty((n, LR_SCALED + len(self.scale_values)), dtype=torch.float32, device=self._device)
        if self._filled:
            table[:self._filled].copy_(self._table[:self._filled])
        self._table = table
        self.version += 1

    def _fill(self, stop: int) -> None:
        """Fill the rows from the first unfilled one to `stop`, in stream
        order: the updates in flight read rows before them."""
        rows = self._rows(self._filled, stop)
        src = torch.from_numpy(rows)
        self._table[self._filled:stop].copy_(src.pin_memory() if self._device.type == "cuda" else src,
                                             non_blocking=True)
        self._filled, self._last_row = stop, rows[-1]
        if self._wd_zero and rows[:, WD].any():
            # an update made while wd was zero everywhere added no wd p
            self._wd_zero = False
            self.version += 1

    def extend_schedule(self) -> None:
        """Make the table hold the row of the update at `count`: fill it
        TABLE_CHUNK rows at a time, ahead of the count; past its last row,
        where the counter stays, grow it when the schedules' row for the
        count differs from that one."""
        n = self._table.shape[0]
        if self.count >= n:
            if self._filled < n:
                self._fill(n)
            if np.array_equal(self._rows(self.count, self.count + 1)[0], self._last_row):
                return
            n = max(2 * n, self.count + 1)
            self._new_table(n)
        if self.count >= self._filled:
            self._fill(min(n, max(self.count + 1, self._filled + self.TABLE_CHUNK)))

    def state_dict(self) -> dict:
        """torch's optimizer state dict plus the update count the schedules
        and bias corrections read."""
        return {**super().state_dict(), "count": self.count}

    def load_state_dict(self, state_dict: dict) -> None:
        state_dict = dict(state_dict)
        count = int(state_dict.pop("count"))
        super().load_state_dict(state_dict)
        self.count = count
        self._counter.fill_(count)
        self.version += 1

    def _global_norm(self, grads) -> torch.Tensor:
        """The gradients' global norm; under TP the cut parameters' squared
        norms are summed over the model group first."""
        norms = torch.stack(torch._foreach_norm(grads))
        if self.cut is None:
            return torch.linalg.vector_norm(norms)
        cut = torch.tensor(self.cut, device=norms.device)
        sq = norms.square()
        cut_sq = sq[cut].sum()
        torch.distributed.all_reduce(cut_sq, group=self.model_group)
        return (sq[~cut].sum() + cut_sq).sqrt()

    def _buffers(self, name: str):
        return [self.state[p][name] for p in self.param_groups[0]["params"]]

    def _add_wd(self, to, params, wd: torch.Tensor, inplace: bool = False) -> list:
        """`to` + wd p on the decayed parameters: in place, or as new
        tensors (`to` may be the parameters' own .grad)."""
        to = list(to)
        dec = [i for i, d in enumerate(self.decay) if d]
        if not dec or self._wd_zero:
            return to
        terms = torch._foreach_mul([params[i] for i in dec], wd)
        if inplace:
            torch._foreach_add_([to[i] for i in dec], terms)
        else:
            for i, t in zip(dec, torch._foreach_add([to[i] for i in dec], terms)):
                to[i] = t
        return to

    @torch.no_grad()
    def step(self, closure=None) -> torch.Tensor:
        if closure is not None:
            raise ValueError(f"{type(self).__name__} takes no closure")
        cfg = self.cfg
        params = self.param_groups[0]["params"]
        grads = [torch.zeros_like(p, dtype=torch.float32) if p.grad is None else p.grad.float() for p in params]
        norm = self._global_norm(grads)
        if cfg.clip_grad is not None:
            # optax.clip_by_global_norm, in its order: (g / norm) * clip
            # where norm >= clip
            clipped = torch._foreach_div(grads, norm)
            torch._foreach_mul_(clipped, cfg.clip_grad)
            keep = norm < cfg.clip_grad
            grads = [torch.where(keep, g, c) for g, c in zip(grads, clipped)]
        self.extend_schedule()
        row = self._table.index_select(0, self._counter.clamp(max=self._table.shape[0] - 1).view(1))[0]
        if self.shards:
            params = [self.shards[i].view(p) if i in self.shards else p for i, p in enumerate(params)]
            grads = [self.shards[i].view(g) if i in self.shards else g for i, g in enumerate(grads)]
        upd = self._update(params, grads, row)
        for j, group in enumerate(self.scale_groups):
            torch._foreach_mul_([upd[i] for i in group], row[LR_SCALED + j])
        torch._foreach_add_(params, upd)
        self._counter.add_(1)
        self.count += 1
        return norm


class FusedAdamW(ScheduledOptimizer):
    """AdamW (`--opt adamw`), or Adam with L2 weight decay folded into the
    gradient (`--opt adam`), as `torch._foreach_*` passes over all
    parameters (module docstring)."""

    BUFFERS = ("exp_avg", "exp_avg_sq")

    def _update(self, params, grads, row: torch.Tensor):
        cfg = self.cfg
        l2 = cfg.opt.lower() == "adam"
        if l2:
            grads = self._add_wd(grads, params, row[WD])
        ms, vs = self._buffers("exp_avg"), self._buffers("exp_avg_sq")
        b1, b2 = cfg.beta1, cfg.beta2
        bc1, bc2 = row[BC1], row[BC2]
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
            self._add_wd(upd, params, row[WD], inplace=True)
        return upd


class FusedSGD(ScheduledOptimizer):
    """SGD with momentum and L2 weight decay: Nesterov for `--opt sgd` and
    `--opt nesterov`, heavy ball for `--opt momentum` (module docstring)."""

    BUFFERS = ("momentum_buffer",)

    def _update(self, params, grads, row: torch.Tensor):
        grads = self._add_wd(grads, params, row[WD])
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
