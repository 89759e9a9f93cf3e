"""Steps of the port (`devias_tpu/train/step.py`): the eval step and the
DEVIAS slot train step.

The slot train step, per micro-batch of `update_freq`: the optional uint8
or I420 unpack, FAME (mixed clips and patch-grid foreground masks), the
frozen teacher's forward on the mixed clips under `no_grad`, the student's
forward in `train()` mode, `devias_slot_loss` and its backward; the f32
gradients of the micro-batches are summed and divided by their number, and
one optimizer step follows. The sequence-parallel variant (`sp_mesh`)
runs FAME once per seq group and broadcasts it, the teacher on the full
clips, the student's backbone on this rank's frames
(`core/dist.py::seq_parallel_tokens`) and the agg, heads and loss on the
gathered tokens, and sums the backbone's gradients over the group before
the optimizer step. HVU, classification and multi-task steps, the
segformer mix and the pipeline-parallel variant are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence, Union

import numpy as np
import torch
from torch import nn

from devias_tpu_torch.aug.fame import IMAGENET_MEAN, IMAGENET_STD, FAMEConfig, fame_augment
from devias_tpu_torch.core.dist import (
    SPMesh,
    broadcast_from_seq_root,
    reduce_backbone_grads,
    seq_parallel_tokens,
    split_generator,
)
from devias_tpu_torch.data.yuv import i420_to_rgb
from devias_tpu_torch.device import DeviceLike, require_on, resolve_device
from devias_tpu_torch.losses.slot_loss import SlotLossConfig, devias_slot_loss
from devias_tpu_torch.train.state import TrainState

METRIC_NAMES = ("loss", "action_loss", "scene_loss", "cosine_loss", "mask_prediction_loss",
                "mask_distill_loss", "class_acc")


@dataclasses.dataclass(frozen=True)
class TrainStepConfig:
    update_freq: int = 1  # gradient accumulation
    use_fame: bool = True
    fame: FAMEConfig = FAMEConfig()
    num_data_shards: int = 1  # shard-local FAME comes with the parallel modes
    # uint8 clips, converted to [0, 1] in the step; the student must be built
    # with input_norm=True
    device_normalize: bool = False
    # 'yuv420': uint8 I420 planes [B, T, H*3//2, W], unpacked to [0, 1] RGB in
    # the step; needs device_normalize=True
    wire_format: str = "rgb"


def to_device(videos: Union[np.ndarray, torch.Tensor], device: torch.device) -> torch.Tensor:
    """Clips as a tensor on `device`. A host array bound for the card goes
    through pinned memory, so the copy is asynchronous to the host."""
    x = torch.from_numpy(np.ascontiguousarray(videos)) if isinstance(videos, np.ndarray) else videos
    if device.type == "cuda" and x.device.type == "cpu":
        x = x.pin_memory()
    return x.to(device, non_blocking=True)


def mix_clips(videos: torch.Tensor, labels: torch.Tensor, step_cfg: TrainStepConfig,
              generator: Optional[torch.Generator] = None, draws: Optional[Dict] = None,
              sp_mesh: Optional[SPMesh] = None):
    """FAME on unpacked clips, or none: (videos, labels, fg_mask
    [B, (H/16)(W/16)], fg_pf [B, T/2 (H/16)(W/16)]), the masks zero without
    FAME. With `sp_mesh`, FAME runs on the seq group's first rank only and
    its outputs are broadcast to the group, whatever the other ranks'
    generators hold."""
    B, T, H, W = videos.shape[:4]
    n_sp = (H // 16) * (W // 16)
    if not step_cfg.use_fame:
        zeros = [torch.zeros(B, n, device=videos.device) for n in (n_sp, (T // 2) * n_sp)]
        return (videos, labels, *zeros)
    if sp_mesh is None or sp_mesh.seq_rank == 0:
        mean, std = ((0.0, 0.0, 0.0), (1.0, 1.0, 1.0)) if step_cfg.device_normalize else (IMAGENET_MEAN, IMAGENET_STD)
        videos, labels, (fg_mask, fg_pf) = fame_augment(videos, labels, step_cfg.fame, generator=generator,
                                                        draws=draws, mean=mean, std=std)
    else:
        videos, labels = torch.empty_like(videos), torch.empty_like(labels)
        fg_mask = torch.empty(B, n_sp, device=videos.device)
        fg_pf = torch.empty(B, (T // 2) * n_sp, device=videos.device)
    if sp_mesh is not None:
        broadcast_from_seq_root([videos, labels, fg_mask, fg_pf], sp_mesh)
    return videos, labels, fg_mask, fg_pf


def slot_loss(model: nn.Module, teacher: nn.Module, videos: torch.Tensor, labels: torch.Tensor,
              loss_cfg: SlotLossConfig, step_cfg: TrainStepConfig, generator: Optional[torch.Generator] = None,
              draws: Optional[Dict] = None, sp_mesh: Optional[SPMesh] = None):
    """One micro-batch of the slot train step up to its loss: the uint8 or
    I420 unpack, FAME, the teacher under `no_grad` on the mixed clips, the
    student's forward and `devias_slot_loss`. Returns (total loss, the
    seven metrics detached); the caller runs the backward.

    With `sp_mesh`, every rank of the seq group passes the same clips and
    a `generator` in the same state. Three generators are split from it:
    FAME's, used on the group's first rank only, whose mixed clips, labels
    and masks are broadcast (GSPMD computes them once; it also keeps
    `index_add_`'s atomic order on the card from giving ranks different
    mixes); the backbone's (`seq_parallel_tokens`: token dropout per rank,
    drop-path shared); and the one of the replicated heads, shared."""
    if step_cfg.wire_format == "yuv420":
        videos = i420_to_rgb(videos)
    elif step_cfg.device_normalize:
        videos = videos.float() / 255.0
    fame_gen = backbone_gen = head_gen = generator
    if sp_mesh is not None:
        fame_gen, backbone_gen, head_gen = split_generator(generator, [videos.device, "cpu", videos.device])
    videos, labels, fg_mask, fg_pf = mix_clips(videos, labels, step_cfg, fame_gen, draws, sp_mesh)
    with torch.no_grad():
        teacher_logits = teacher(videos)["logits"]
    tokens = None
    if sp_mesh is not None:
        tokens = seq_parallel_tokens(model, videos, sp_mesh, deterministic=False, generator=backbone_gen)
    student = model(videos, generator=head_gen, tokens=tokens)
    total, action_logits, parts = devias_slot_loss(student, teacher_logits, labels, fg_mask, fg_pf, loss_cfg)
    acc = (action_logits.argmax(dim=-1) == labels).float().mean()
    metrics = {k: v.detach() for k, v in parts.items()}
    return total, {**metrics, "loss": total.detach(), "class_acc": acc}


def make_slot_train_step(model: nn.Module, teacher: nn.Module, optimizer: torch.optim.Optimizer,
                         loss_cfg: SlotLossConfig, step_cfg: TrainStepConfig = TrainStepConfig(),
                         lr_fn: Optional[Callable[[int], float]] = None, segformer_apply=None,
                         pp_mesh=None, sp_mesh=None, device: DeviceLike = None) -> Callable:
    """DEVIAS slot train step `step(state, batch, generator=None,
    draws=None, host_metrics=False) -> metrics`.

    `batch` is {"videos": [B, T, H, W, C], "labels": [B]}, numpy arrays or
    tensors, copied to `device` (`cuda` unless the caller asks for `cpu`),
    where the student, the teacher and the optimizer's parameters must
    already be; B = update_freq x micro-batch. Dropout, drop-path and FAME
    draw from `generator`, or from the step's own generator (seed 0).
    `draws` fixes FAME's draws: one {"perm", "keep"} dict per micro-batch
    (a list), or one dict when update_freq is 1.

    `sp_mesh` (`core/dist.py::make_sp_mesh`) selects sequence-parallel
    training: every rank of the seq group calls the step with the same
    batch and generator state (see `slot_loss`), and the backbone's
    gradients are summed over the group before the optimizer step, which
    is then the same on every rank. Its own generator lives on the CPU: the
    streams are split from host draws, and a card generator passed in makes
    each micro-batch's draw wait for the card.

    Returns the seven loss and accuracy metrics averaged over the
    micro-batches, `grad_norm` (before clipping) and, with `lr_fn`, `lr` at
    the step before the update: 0-d device tensors, or host floats with
    `host_metrics=True` (which synchronises)."""
    if segformer_apply is not None or pp_mesh is not None:
        raise NotImplementedError("the segformer mix and the pipeline-parallel step are not ported")
    if step_cfg.num_data_shards > 1:
        raise NotImplementedError("shard-local FAME (num_data_shards > 1) comes with the parallel modes")
    if step_cfg.wire_format not in ("rgb", "yuv420"):
        raise ValueError(f"unknown wire_format {step_cfg.wire_format!r}")
    if step_cfg.wire_format == "yuv420" and not step_cfg.device_normalize:
        raise ValueError("wire_format='yuv420' requires device_normalize=True")
    dev = resolve_device(device)
    require_on(model, dev)
    require_on(teacher, dev, "teacher")
    teacher.eval().requires_grad_(False)
    # the SP step splits its streams from host draws (`slot_loss`); a card
    # generator would make each such draw wait for the card
    own_generator = torch.Generator(device="cpu" if sp_mesh is not None else dev).manual_seed(0)
    U = step_cfg.update_freq

    def step(state: TrainState, batch: Dict, generator: Optional[torch.Generator] = None,
             draws: Optional[Union[Dict, Sequence[Dict]]] = None, host_metrics: bool = False):
        if state.optimizer is not optimizer:
            raise ValueError("the state holds another optimizer than the step was made with")
        gen = own_generator if generator is None else generator
        videos = to_device(batch["videos"], dev)
        labels = to_device(batch["labels"], dev).long()
        if videos.shape[0] % U:
            raise ValueError(f"batch {videos.shape[0]} is not a multiple of update_freq {U}")
        if isinstance(draws, dict):
            draws = [draws]
        if draws is not None and len(draws) != U:
            raise ValueError(f"draws holds {len(draws)} micro-batches; update_freq is {U}")
        mb = videos.shape[0] // U
        model.train()
        state.optimizer.zero_grad(set_to_none=True)
        sums = None
        for u in range(U):
            sl = slice(u * mb, (u + 1) * mb)
            total, m = slot_loss(model, teacher, videos[sl], labels[sl], loss_cfg, step_cfg, gen,
                                 None if draws is None else draws[u], sp_mesh)
            total.backward()
            sums = m if sums is None else {k: sums[k] + m[k] for k in sums}
        if sp_mesh is not None:
            reduce_backbone_grads(model, sp_mesh)
        if U > 1:
            for p in model.parameters():
                if p.grad is not None:
                    p.grad.div_(U)
            sums = {k: v / U for k, v in sums.items()}
        metrics = {k: sums[k] for k in METRIC_NAMES}
        if lr_fn is not None:
            metrics["lr"] = torch.tensor(lr_fn(state.step), dtype=torch.float32)
        metrics["grad_norm"] = state.optimizer.step()
        state.optimizer.zero_grad(set_to_none=True)
        state.update_ema()
        state.step += 1
        if host_metrics:
            return {k: float(v) for k, v in metrics.items()}
        return metrics

    return step


def make_eval_step(model: nn.Module, output_key: Optional[str] = None,
                   device: DeviceLike = None) -> Callable:
    """Deterministic forward `step(videos)` returning the model's output
    dict, or its `output_key` entry, under `torch.inference_mode()`.
    `videos` may be a numpy array or a tensor; they go to `device` (`cuda`
    unless the caller asks for `cpu`), where the model must already be."""
    dev = resolve_device(device)
    require_on(model, dev)
    model.eval()

    def step(videos):
        with torch.inference_mode():
            out = model(to_device(videos, dev))
        return out[output_key] if output_key else out

    return step
