"""Steps of the port (`devias_tpu/train/step.py`): the eval step, the
DEVIAS slot train step, the HVU slot train step, the plain
classification train step and the multi-task train step.

The slot train step, per micro-batch of `update_freq`: the optional uint8
or I420 unpack, FAME or, with `segformer_apply`, the Segformer mix (mixed
clips and patch-grid foreground masks; the mix runs independently on each
of `num_data_shards` blocks of the micro-batch when they divide it), the
frozen teacher's forward on the mixed clips under
`no_grad`, the student's forward in `train()` mode, `devias_slot_loss` and
its backward; the f32 gradients of the micro-batches are summed and
divided by their number, and one optimizer step follows.

Two process layouts (`core/dist.py`) extend it. Data parallelism
(`dp_mesh`, `make_mesh()`): each rank runs the step on its own local
batch and the gradients and metrics are averaged over the data group
before the optimizer step. Sequence parallelism (`sp_mesh`,
`make_sp_mesh(S)`) runs FAME once per seq group and broadcasts it, the
teacher on the full clips, the student's backbone on this rank's frames
(`core/dist.py::seq_parallel_tokens`) and the agg, heads and loss on the
gathered tokens, and sums the backbone's gradients over the group; with
more than one data row it also averages over the data group.

The HVU step (`make_hvu_train_step`) trains on real scene labels with no
teacher: FAME-HVU, `hvu_slot_loss`. The classification step
(`make_classification_train_step`) runs optional mixup / CutMix, the
model and a criterion on hard or soft targets. Both take `dp_mesh`; their
batch ops mix across the global micro-batch, as under jit on the JAX data
mesh (`core/dist.py::over_data_group`). The multi-task step
(`make_multi_task_train_step`) runs the student, the frozen CLS teacher
under `no_grad` and `multi_task_loss`. All four steps share the
accumulation, the reductions and the optimizer step (`_run_step`), and
with it the placements of `core/dist.py::shard_train_state` (ZeRO-1,
FSDP, TP). The slot step also takes a pipeline layout (`pp_mesh`,
`core/pipeline.py`).

On a CUDA device, with no layout and no placed state, each of the four
steps replays its whole step as one CUDA graph (`train/graph.py`): the
first such call captures it, with the caller's generator, and every later
call with the same batch shapes and dtypes, draws, generator, state and
update_freq copies its batch into the graph's inputs and replays it, at
most two steps ahead of the card. Any other call, a call on the CPU,
under a layout or a placement, and every call after a capture that
failed (a step that waits for the host), runs eager as described above.
The step function's `graph` attribute is its `StepGraph`.

The steps' phases and the eval forward are spans of `utils/profiling.py`
(`train.step`, `train.fame`, `train.teacher`, `train.student`,
`train.loss`, `train.backward`, `train.optimizer`, `eval.forward`), and
`to_device` stages host arrays under `h2d.stage` and counts their bytes;
they record only under a profiler. A replay enters `train.step` and
`train.graph_wait` alone.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence, Union

import numpy as np
import torch
from torch import nn

from devias_tpu_torch.aug.fame import IMAGENET_MEAN, IMAGENET_STD, FAMEConfig, fame_augment, fame_augment_hvu
from devias_tpu_torch.aug.mixup import MixupConfig, mixup_cutmix
from devias_tpu_torch.aug.segformer_mix import segformer_frame_masks, segformer_mix_sample
from devias_tpu_torch.core.dist import (
    SPMesh,
    broadcast_in_row,
    mean_over_data,
    min_over_data,
    mix_generators,
    over_data_group,
    rank_generators,
    reduce_grads,
    seq_parallel_tokens,
)
from devias_tpu_torch.core.pipeline import pipeline_tokens
from devias_tpu_torch.data.yuv import i420_to_rgb
from devias_tpu_torch.device import DeviceLike, require_on, resolve_device
from devias_tpu_torch.losses.slot_loss import (
    SlotLossConfig,
    cross_entropy,
    devias_slot_loss,
    hvu_slot_loss,
    multi_task_loss,
)
from devias_tpu_torch.train.graph import StepGraph, graph_safe
from devias_tpu_torch.train.state import TrainState
from devias_tpu_torch.utils.profiling import count, span

METRIC_NAMES = ("loss", "action_loss", "scene_loss", "cosine_loss", "mask_prediction_loss",
                "mask_distill_loss", "class_acc")
CLASSIFICATION_METRIC_NAMES = ("loss", "class_acc")
MULTI_TASK_METRIC_NAMES = ("loss", "action_loss", "logit_loss", "class_acc")


@dataclasses.dataclass(frozen=True)
class TrainStepConfig:
    update_freq: int = 1  # gradient accumulation
    use_fame: bool = True
    fame: FAMEConfig = FAMEConfig()
    # FAME runs independently on this many contiguous blocks of each
    # micro-batch (JAX's per-device shards; each rank of a data-parallel
    # run is one block of its own)
    num_data_shards: int = 1
    # uint8 clips, converted to [0, 1] in the step; the student must be built
    # with input_norm=True
    device_normalize: bool = False
    # 'yuv420': uint8 I420 planes [B, T, H*3//2, W], unpacked to [0, 1] RGB in
    # the step; needs device_normalize=True
    wire_format: str = "rgb"
    # GPipe micro-batches of each micro-batch under pp_mesh
    pp_microbatches: int = 4


def to_device(videos: Union[np.ndarray, torch.Tensor], device: torch.device) -> torch.Tensor:
    """Clips as a tensor on `device`. A host array bound for the card goes
    through pinned memory, so the copy is asynchronous to the host."""
    x = torch.from_numpy(np.ascontiguousarray(videos)) if isinstance(videos, np.ndarray) else videos
    if device.type != "cuda" or x.device.type != "cpu":
        return x.to(device, non_blocking=True)
    with span("h2d.stage"):
        count("h2d_bytes", x.numel() * x.element_size())
        return x.pin_memory().to(device, non_blocking=True)


def _by_shards(mix: Callable, B: int, n: int, draws):
    """`mix(slice, draws)` -> (videos, labels, (fg_mask, fg_pf)) on the
    whole micro-batch of B, or on each of `n` contiguous blocks with the
    block's own draws (one generator stream in block order, or `draws[k]`
    for block k) when they divide it. Returns the four concatenated."""
    if n <= 1 or B % n:
        videos, labels, (fg_mask, fg_pf) = mix(slice(0, B), draws)
        return videos, labels, fg_mask, fg_pf
    if draws is not None and len(draws) != n:
        raise ValueError(f"draws holds {len(draws)} shards; num_data_shards is {n}")
    b = B // n
    parts = [mix(slice(k * b, (k + 1) * b), None if draws is None else draws[k]) for k in range(n)]
    return (torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts]),
            torch.cat([p[2][0] for p in parts]), torch.cat([p[2][1] for p in parts]))


def _fame(videos: torch.Tensor, labels: torch.Tensor, step_cfg: TrainStepConfig,
          generator: Optional[torch.Generator], draws):
    """FAME, per block of `num_data_shards` (`_by_shards`)."""
    mean, std = ((0.0, 0.0, 0.0), (1.0, 1.0, 1.0)) if step_cfg.device_normalize else (IMAGENET_MEAN, IMAGENET_STD)
    return _by_shards(lambda sl, d: fame_augment(videos[sl], labels[sl], step_cfg.fame, generator=generator, draws=d,
                                                 mean=mean, std=std),
                      videos.shape[0], step_cfg.num_data_shards, draws)


def _segformer_mix(videos: torch.Tensor, labels: torch.Tensor, step_cfg: TrainStepConfig,
                   generator: Optional[torch.Generator], draws, segformer_apply: Callable):
    """The mask model's person masks on the whole micro-batch (fed
    ImageNet-normalized clips, as the reference feeds the normalized
    video; under `device_normalize` the step's [0, 1] clips are normalized
    for it), then the mix per block of `num_data_shards` (`_by_shards`:
    each block permutes only its own samples, as FAME's blocks do), with
    FAME's `prob_aug`."""
    seg_in = videos
    if step_cfg.device_normalize:
        mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=videos.device)
        std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=videos.device)
        seg_in = (videos - mean) / std
    masks = segformer_frame_masks(segformer_apply, seg_in)
    return _by_shards(lambda sl, d: segformer_mix_sample(masks[sl], videos[sl], labels[sl], step_cfg.fame.prob_aug,
                                                         generator=generator, draws=d),
                      videos.shape[0], step_cfg.num_data_shards, draws)


def mix_clips(videos: torch.Tensor, labels: torch.Tensor, step_cfg: TrainStepConfig,
              generator: Optional[torch.Generator] = None, draws=None, mesh: Optional[SPMesh] = None,
              segformer_apply: Optional[Callable] = None):
    """The Segformer mix with `segformer_apply`, else FAME, else none, on
    unpacked clips: (videos, labels, fg_mask [B, (H/16)(W/16)], fg_pf
    [B, T/2 (H/16)(W/16)]), the masks zero without a mix. `draws`: one
    dict ({"perm", "keep"} for FAME, and "frame" for the Segformer mix), or
    one per block of `num_data_shards`. With a `mesh` whose data rows hold
    more than one rank (seq, model or pipe), the mix runs on the row's first
    rank only and its outputs are broadcast to the row, whatever the other
    ranks' generators hold."""
    B, T, H, W = videos.shape[:4]
    n_sp = (H // 16) * (W // 16)
    if not step_cfg.use_fame and segformer_apply is None:
        zeros = [torch.zeros(B, n, device=videos.device) for n in (n_sp, (T // 2) * n_sp)]
        return (videos, labels, *zeros)
    row = mesh is not None and mesh.inner[2] > 1
    if not row or mesh.inner[1] == 0:
        if segformer_apply is not None:
            videos, labels, fg_mask, fg_pf = _segformer_mix(videos, labels, step_cfg, generator, draws,
                                                            segformer_apply)
        else:
            videos, labels, fg_mask, fg_pf = _fame(videos, labels, step_cfg, generator, draws)
    else:
        videos, labels = torch.empty_like(videos), torch.empty_like(labels)
        fg_mask = torch.empty(B, n_sp, device=videos.device)
        fg_pf = torch.empty(B, (T // 2) * n_sp, device=videos.device)
    if row:
        broadcast_in_row([videos, labels, fg_mask, fg_pf], mesh)
    return videos, labels, fg_mask, fg_pf


def slot_loss(model: nn.Module, teacher: nn.Module, videos: torch.Tensor, labels: torch.Tensor,
              loss_cfg: SlotLossConfig, step_cfg: TrainStepConfig, generator: Optional[torch.Generator] = None,
              draws=None, sp_mesh: Optional[SPMesh] = None, dp_mesh: Optional[SPMesh] = None,
              segformer_apply: Optional[Callable] = None, pp_mesh: Optional[SPMesh] = None):
    """One micro-batch of the slot train step up to its loss: the uint8 or
    I420 unpack, FAME or the Segformer mix (`mix_clips`), the teacher
    under `no_grad` on the mixed clips, the student's forward and
    `devias_slot_loss`. Returns (total loss, the seven metrics detached);
    the caller runs the backward.

    With a layout (`sp_mesh`, `pp_mesh` or `dp_mesh`), every rank passes a
    `generator` in the same state, and three streams are split from it per
    data row (`core/dist.py::rank_generators`): FAME's, used on the row's
    first rank only, whose mixed clips, labels and masks are broadcast to
    the row (GSPMD computes them once; it also keeps `index_add_`'s atomic
    order on the card from giving ranks different mixes); the backbone's
    (`seq_parallel_tokens`: token dropout per rank, drop-path shared along
    seq; `pipeline_tokens`: the seed of its per-block draws); and the one of
    the replicated heads, shared along the row. Every rank of a data row
    passes the same clips. Under `pp_mesh` the backbone runs as a pipeline
    of `step_cfg.pp_microbatches` micro-batches and the agg block, heads and
    loss run on its tokens on every pipe rank."""
    if step_cfg.wire_format == "yuv420":
        videos = i420_to_rgb(videos)
    elif step_cfg.device_normalize:
        videos = videos.float() / 255.0
    mesh = next((m for m in (sp_mesh, pp_mesh, dp_mesh) if m is not None), None)
    fame_gen = backbone_gen = head_gen = generator
    if mesh is not None:
        fame_gen, backbone_gen, head_gen = rank_generators(generator, mesh, videos.device)
    with span("train.fame"):
        videos, labels, fg_mask, fg_pf = mix_clips(videos, labels, step_cfg, fame_gen, draws, mesh,
                                                   segformer_apply)
    with span("train.teacher"), torch.no_grad():
        teacher_logits = teacher(videos)["logits"]
    with span("train.student"):
        tokens = None
        if sp_mesh is not None:
            tokens = seq_parallel_tokens(model, videos, sp_mesh, deterministic=False, generator=backbone_gen)
        elif pp_mesh is not None:
            tokens = pipeline_tokens(model, videos, pp_mesh, step_cfg.pp_microbatches, deterministic=False,
                                     generator=backbone_gen)
        student = model(videos, generator=head_gen, tokens=tokens)
    # the teacher pad's batch minimum is the global micro-batch's, as in
    # the JAX step (the reference's DDP ranks take their own)
    teacher_min = None if mesh is None else min_over_data(teacher_logits.float().min(), mesh)
    with span("train.loss"):
        total, action_logits, parts = devias_slot_loss(student, teacher_logits, labels, fg_mask, fg_pf, loss_cfg,
                                                       teacher_min)
    acc = (action_logits.argmax(dim=-1) == labels).float().mean()
    metrics = {k: v.detach() for k, v in parts.items()}
    return total, {**metrics, "loss": total.detach(), "class_acc": acc}


def make_slot_train_step(model: nn.Module, teacher: nn.Module, optimizer: torch.optim.Optimizer,
                         loss_cfg: SlotLossConfig, step_cfg: TrainStepConfig = TrainStepConfig(),
                         lr_fn: Optional[Callable[[int], float]] = None, segformer_apply=None,
                         pp_mesh=None, sp_mesh=None, dp_mesh=None, device: DeviceLike = None) -> Callable:
    """DEVIAS slot train step `step(state, batch, generator=None,
    draws=None, host_metrics=False) -> metrics`.

    `segformer_apply` (a frozen mask model, [N, H, W, 3] -> quarter-res
    logits) selects the reference's `--mask_model Segformer` branch in
    place of FAME (`mix_clips`), its mix with FAME's `prob_aug`.

    `batch` is {"videos": [B, T, H, W, C], "labels": [B]}, numpy arrays or
    tensors, copied to `device` (`cuda` unless the caller asks for `cpu`),
    where the student, the teacher and the optimizer's parameters must
    already be; B = update_freq x micro-batch. Dropout, drop-path and FAME
    draw from `generator`, or from the step's own generator (seed 0).
    `draws` fixes FAME's draws: one entry per micro-batch (a list), or one
    entry when update_freq is 1; an entry is a {"perm", "keep"} dict (and
    "frame" with `segformer_apply`), or a list of one such dict per block
    when `num_data_shards` blocks divide the micro-batch.

    `dp_mesh` (`core/dist.py::make_mesh`) selects data-parallel training:
    each rank calls the step with its own local batch, and the gradients
    and metrics are averaged over the data group before the optimizer
    step, which is then the same on every rank. Every local batch must have
    the same size (each rank's loss is a mean over its own samples).
    `sp_mesh` (`core/dist.py::make_sp_mesh`) selects sequence-parallel
    training: every rank of a seq group calls the step with the same batch
    (see `slot_loss`), the backbone's gradients are summed over the group,
    and a layout of several data rows also averages over the data group.
    `pp_mesh` (`core/pipeline.py::make_pp_mesh`) selects pipeline-parallel
    training: every rank of a data row calls the step with the same batch,
    the row's pipe ranks each run their stage's blocks over
    `step_cfg.pp_microbatches` micro-batches (`pipeline_tokens`), and the
    stages' gradients are summed over the pipe group
    (`core/dist.py::reduce_stage_grads`). A `dp_mesh` of
    `make_mesh(model_parallel=t)` trains tensor-parallel once the state is
    placed with `shard_train_state(..., tp=True)`: the t ranks of a data row
    pass the same batch. Under any layout every rank passes a generator in
    the same state, and the step's own generator lives on the CPU: the
    streams are split from host draws, and a card generator passed in makes
    each micro-batch's draw wait for the card. A placed state
    (`state.placement`: ZeRO-1, FSDP, TP) is updated as its placement says
    (`_run_step`).

    Returns the seven loss and accuracy metrics averaged over the
    micro-batches (and the data group), `grad_norm` (before clipping) and,
    with `lr_fn`, `lr` at the step before the update: 0-d device tensors,
    or host floats with `host_metrics=True` (which synchronises)."""
    if pp_mesh is not None and sp_mesh is not None:
        raise ValueError("pp_mesh and sp_mesh are mutually exclusive")
    if sp_mesh is not None and dp_mesh is not None:
        raise ValueError("sp_mesh and dp_mesh are exclusive: a layout with seq ranks is an sp_mesh")
    if pp_mesh is not None and dp_mesh is not None:
        raise ValueError("pp_mesh and dp_mesh are exclusive: a layout with pipe ranks is a pp_mesh")
    if dp_mesh is not None and dp_mesh.seq_size > 1:
        raise ValueError(f"dp_mesh has {dp_mesh.seq_size} seq ranks; pass it as sp_mesh")
    if step_cfg.wire_format not in ("rgb", "yuv420"):
        raise ValueError(f"unknown wire_format {step_cfg.wire_format!r}")
    if step_cfg.wire_format == "yuv420" and not step_cfg.device_normalize:
        raise ValueError("wire_format='yuv420' requires device_normalize=True")
    dev = resolve_device(device)
    require_on(model, dev)
    require_on(teacher, dev, "teacher")
    teacher.eval().requires_grad_(False)
    mesh = next((m for m in (sp_mesh, pp_mesh, dp_mesh) if m is not None), None)
    # a layout's step splits its streams from host draws (`slot_loss`); a
    # card generator would make each such draw wait for the card
    own_generator = _layout_generator(mesh, dev)
    U = step_cfg.update_freq

    graph = StepGraph()

    def micro(x, sl, gen, d):
        return slot_loss(model, teacher, x["videos"][sl], x["labels"][sl], loss_cfg, step_cfg, gen, d, sp_mesh,
                         dp_mesh, segformer_apply, pp_mesh)

    def step(state: TrainState, batch: Dict, generator: Optional[torch.Generator] = None,
             draws: Optional[Union[Dict, Sequence]] = None, host_metrics: bool = False):
        inputs = {"videos": to_device(batch["videos"], dev), "labels": to_device(batch["labels"], dev).long()}
        return _run_step(state, optimizer, model, inputs, U, micro, own_generator if generator is None
                         else generator, draws, mesh, METRIC_NAMES, lr_fn, host_metrics, graph)

    step.graph = graph
    return step


def _micro_draws(draws, U: int):
    """`draws` as one entry per micro-batch (or None): a dict stands for
    the one micro-batch of update_freq 1."""
    if isinstance(draws, dict):
        draws = [draws]
    if draws is not None and len(draws) != U:
        raise ValueError(f"draws holds {len(draws)} micro-batches; update_freq is {U}")
    return draws


def _run_step(state: TrainState, optimizer: torch.optim.Optimizer, model: nn.Module, inputs: Dict[str, torch.Tensor],
              U: int, micro: Callable, generator: torch.Generator, draws, mesh: Optional[SPMesh],
              metric_names: Sequence[str], lr_fn: Optional[Callable[[int], float]], host_metrics: bool,
              graph: Optional[StepGraph]):
    """The part every train step shares: `micro(inputs, slice, generator,
    draws)` -> (loss, metrics) for each of the U micro-batches of the
    `inputs` (device tensors of one batch), its backward, the f32
    gradients and metrics summed; under a layout the gradients reduced and
    the metrics averaged over the data group; both divided by U; then `lr`
    (with `lr_fn`, at the step before the update), one optimizer step
    (`grad_norm`, before clipping), the EMA and the step count. A placed
    state (`core/dist.py::Placement`) has its full parameters gathered
    before the first micro-batch (FSDP), and after the update the updated
    slices all-gathered (ZeRO-1) or the full parameters freed (FSDP),
    before the EMA. With `graph` the step is a replay of its capture where
    the call allows one (`train/graph.py`), else it runs eager."""
    if state.optimizer is not optimizer:
        raise ValueError("the state holds another optimizer than the step was made with")
    videos = next(iter(inputs.values()))
    batch = videos.shape[0]
    if batch % U:
        raise ValueError(f"batch {batch} is not a multiple of update_freq {U}")
    draws = _micro_draws(draws, U)
    mb = batch // U

    def forward_backward(x, d, gen):
        sums = None
        for u in range(U):
            total, m = micro(x, slice(u * mb, (u + 1) * mb), gen, None if d is None else d[u])
            with span("train.backward"):
                total.backward()
                # the loss holds the autograd graph: free it inside the span
                del total
            sums = m if sums is None else {k: sums[k] + m[k] for k in sums}
        return sums

    def body(x, d, gen):
        placement = state.placement
        if placement is not None:
            placement.gather_params()
        optimizer.zero_grad(set_to_none=True)
        sums = forward_backward(x, d, gen)
        if mesh is not None:
            reduce_grads(model, mesh)
            sums = mean_over_data(sums, mesh)
        if U > 1:
            for p in model.parameters():
                if p.grad is not None:
                    p.grad.div_(U)
            sums = {k: v / U for k, v in sums.items()}
        with span("train.optimizer"):
            grad_norm = optimizer.step()
            optimizer.zero_grad(set_to_none=True)
            if placement is not None:
                placement.after_update()
            state.update_ema()
            state.step += 1
        return {k: sums[k] for k in metric_names}, grad_norm

    with span("train.step"):
        lr_step = state.step
        model.train()
        out = None
        if graph is not None and graph_safe(videos.device, mesh, state.placement):
            out = graph.run(state, optimizer, inputs, draws, generator, U, forward_backward, body)
        metrics, grad_norm = body(inputs, draws, generator) if out is None else out
        if lr_fn is not None:
            metrics["lr"] = torch.tensor(lr_fn(lr_step), dtype=torch.float32)
        metrics["grad_norm"] = grad_norm
        if host_metrics:
            return {k: float(v) for k, v in metrics.items()}
        return metrics


def _check_dp_mesh(dp_mesh: Optional[SPMesh]) -> None:
    if dp_mesh is not None and dp_mesh.seq_size > 1:
        raise ValueError(f"dp_mesh has {dp_mesh.seq_size} seq ranks; this step has no sequence-parallel form")


def _layout_generator(mesh: Optional[SPMesh], dev: torch.device) -> torch.Generator:
    """The step's own generator (seed 0): on the host under a layout,
    whose streams are split from host draws; else on `dev`."""
    return torch.Generator(device="cpu" if mesh is not None else dev).manual_seed(0)


def hvu_loss(model: nn.Module, videos: torch.Tensor, action_labels: torch.Tensor, scene_labels: torch.Tensor,
             loss_cfg: SlotLossConfig, step_cfg: TrainStepConfig, generator: Optional[torch.Generator] = None,
             draws=None, dp_mesh: Optional[SPMesh] = None):
    """One micro-batch of the HVU train step up to its loss: FAME-HVU (or
    zero masks without FAME), the student in its own mode and
    `hvu_slot_loss`. Returns (total loss, the seven metrics detached).

    With `dp_mesh`, FAME-HVU runs on the data group's global micro-batch
    (`over_data_group`) with draws from `mix_generators`' shared stream,
    as the JAX step mixes its global micro-batch under jit, and the
    student draws from this rank's folded stream; `draws` then hold the
    global micro-batch's {"perm", "keep"}."""
    model_gen = mix_gen = generator
    if dp_mesh is not None:
        mix_gen, model_gen = mix_generators(generator, dp_mesh, videos.device)
    B, T, H, W = videos.shape[:4]
    n_sp = (H // 16) * (W // 16)
    if step_cfg.use_fame:
        def op(v, a, s):
            v, a, s, (fg, pf) = fame_augment_hvu(v, a, s, step_cfg.fame, mix_gen, draws)
            return v, a, s, fg, pf

        with span("train.fame"):
            videos, action_labels, scene_labels, fg_mask, fg_pf = over_data_group(
                op, (videos, action_labels, scene_labels), dp_mesh)
    else:
        fg_mask = torch.zeros(B, n_sp, device=videos.device)
        fg_pf = torch.zeros(B, (T // 2) * n_sp, device=videos.device)
    with span("train.student"):
        student = model(videos, generator=model_gen)
    with span("train.loss"):
        total, action_logits, parts = hvu_slot_loss(student, action_labels, scene_labels, fg_mask, fg_pf,
                                                    loss_cfg)
    acc = (action_logits.argmax(dim=-1) == action_labels).float().mean()
    metrics = {k: v.detach() for k, v in parts.items()}
    return total, {**metrics, "loss": total.detach(), "class_acc": acc}


def make_hvu_train_step(model: nn.Module, optimizer: torch.optim.Optimizer, loss_cfg: SlotLossConfig,
                        step_cfg: TrainStepConfig = TrainStepConfig(), lr_fn: Optional[Callable[[int], float]] = None,
                        dp_mesh: Optional[SPMesh] = None, device: DeviceLike = None) -> Callable:
    """HVU slot train step `step(state, batch, generator=None, draws=None,
    host_metrics=False) -> metrics` (`devias_tpu/train/step.py:315-389`):
    real action and scene labels, FAME-HVU, no teacher.

    `batch` is {"videos": [B, T, H, W, C], "labels" (or "action_labels"):
    [B], "scene_labels": [B]}, copied to `device` (`cuda` unless the
    caller asks for `cpu`), where the model and the optimizer's parameters
    must already be; B = update_freq x micro-batch. FAME, dropout and
    drop-path draw from `generator`, or the step's own (seed 0). `draws`
    fixes FAME-HVU's {"perm", "keep"}: one dict per micro-batch (a list),
    or one dict when update_freq is 1. `step_cfg.num_data_shards`,
    `device_normalize` and `wire_format` play no part, as in the JAX step.

    `dp_mesh` (`core/dist.py::make_mesh`) trains data-parallel: each rank
    passes its own rows of every micro-batch, FAME-HVU mixes the global
    micro-batch (`hvu_loss`), and the gradients and metrics are averaged
    over the data group. Every rank passes a generator in one state.
    Returns the seven loss and accuracy metrics, `grad_norm` and, with
    `lr_fn`, `lr`, as `make_slot_train_step` does."""
    _check_dp_mesh(dp_mesh)
    dev = resolve_device(device)
    require_on(model, dev)
    own_generator = _layout_generator(dp_mesh, dev)
    U = step_cfg.update_freq

    graph = StepGraph()

    def micro(x, sl, gen, d):
        return hvu_loss(model, x["videos"][sl], x["action"][sl], x["scene"][sl], loss_cfg, step_cfg, gen, d, dp_mesh)

    def step(state: TrainState, batch: Dict, generator: Optional[torch.Generator] = None,
             draws: Optional[Union[Dict, Sequence]] = None, host_metrics: bool = False):
        inputs = {"videos": to_device(batch["videos"], dev),
                  "action": to_device(batch["labels"] if "labels" in batch else batch["action_labels"], dev).long(),
                  "scene": to_device(batch["scene_labels"], dev).long()}
        return _run_step(state, optimizer, model, inputs, U, micro, own_generator if generator is None else generator,
                         draws, dp_mesh, METRIC_NAMES, lr_fn, host_metrics, graph)

    step.graph = graph
    return step


def classification_loss(model: nn.Module, videos: torch.Tensor, labels: torch.Tensor, criterion: Callable,
                        logits_key: str = "logits", mixup_cfg: Optional[MixupConfig] = None,
                        generator: Optional[torch.Generator] = None, draws=None,
                        dp_mesh: Optional[SPMesh] = None):
    """One micro-batch of the classification step up to its loss: mixup /
    CutMix when `mixup_cfg` is enabled (soft targets; over the data group's
    global micro-batch under `dp_mesh`, as `hvu_loss` runs FAME-HVU), the
    model in its own mode, `criterion(logits, targets).mean()` and the
    accuracy against the hard labels, or the soft targets' argmax. Returns
    (loss, {"loss", "class_acc"} detached)."""
    model_gen = mix_gen = generator
    if dp_mesh is not None:
        mix_gen, model_gen = mix_generators(generator, dp_mesh, videos.device)
    if mixup_cfg is not None and mixup_cfg.enabled:
        videos, labels = over_data_group(lambda v, lb: mixup_cutmix(v, lb, mixup_cfg, mix_gen, draws),
                                         (videos, labels), dp_mesh)
    logits = model(videos, generator=model_gen)[logits_key]
    loss = criterion(logits, labels).mean()
    hard = labels if labels.dim() == 1 else labels.argmax(dim=-1)
    acc = (logits.argmax(dim=-1) == hard).float().mean()
    return loss, {"loss": loss.detach(), "class_acc": acc}


def make_classification_train_step(model: nn.Module, optimizer: torch.optim.Optimizer,
                                   criterion: Callable = cross_entropy, update_freq: int = 1,
                                   lr_fn: Optional[Callable[[int], float]] = None, logits_key: str = "logits",
                                   mixup_cfg: Optional[MixupConfig] = None, dp_mesh: Optional[SPMesh] = None,
                                   device: DeviceLike = None) -> Callable:
    """Plain finetune step `step(state, batch, generator=None, draws=None,
    host_metrics=False) -> metrics` (`devias_tpu/train/step.py:392-456`):
    [mixup / CutMix ->] the model -> `criterion` on its `logits_key`
    output, mean over the micro-batch -> the optimizer. With mixup the
    criterion takes soft targets [B, num_classes] (soft-target
    cross-entropy in the CLI).

    `batch` is {"videos": [B, T, H, W, C], "labels": [B]}; device, update
    frequency, generator and `dp_mesh` as in `make_hvu_train_step`.
    `draws` fixes mixup's draws (`aug/mixup.py`), one dict per micro-batch
    or one dict when update_freq is 1; under `dp_mesh` they are the global
    micro-batch's. Returns `loss`, `class_acc`, `grad_norm` and, with
    `lr_fn`, `lr`."""
    _check_dp_mesh(dp_mesh)
    dev = resolve_device(device)
    require_on(model, dev)
    own_generator = _layout_generator(dp_mesh, dev)

    graph = StepGraph()

    def micro(x, sl, gen, d):
        return classification_loss(model, x["videos"][sl], x["labels"][sl], criterion, logits_key, mixup_cfg, gen, d,
                                   dp_mesh)

    def step(state: TrainState, batch: Dict, generator: Optional[torch.Generator] = None,
             draws: Optional[Union[Dict, Sequence]] = None, host_metrics: bool = False):
        inputs = {"videos": to_device(batch["videos"], dev), "labels": to_device(batch["labels"], dev).long()}
        return _run_step(state, optimizer, model, inputs, update_freq, micro,
                         own_generator if generator is None else generator, draws, dp_mesh,
                         CLASSIFICATION_METRIC_NAMES, lr_fn, host_metrics, graph)

    step.graph = graph
    return step


def multi_task_loss_of(model: nn.Module, teacher: nn.Module, videos: torch.Tensor, labels: torch.Tensor,
                       num_action_classes: int, logit_criterion: str = "KL", logit_criterion_weight: float = 1.0,
                       unified_head: bool = False, action_criterion: Callable = cross_entropy,
                       generator: Optional[torch.Generator] = None, dp_mesh: Optional[SPMesh] = None):
    """One micro-batch of the multi-task step up to its loss: the student in
    its own mode, the frozen teacher under `no_grad` on the same clips,
    `multi_task_loss`, and the accuracy over the first `num_action_classes`
    action logits. Under `dp_mesh` the student draws from this rank's
    folded stream, and a unified head's teacher pad takes the global
    micro-batch's minimum, as the JAX step does under jit. Returns (total
    loss, the four metrics detached)."""
    model_gen = generator
    if dp_mesh is not None:
        model_gen = mix_generators(generator, dp_mesh, videos.device)[1]
    student = model(videos, generator=model_gen)
    with span("train.teacher"), torch.no_grad():
        teacher_logits = teacher(videos)["logits"]
    teacher_min = None
    if unified_head and dp_mesh is not None:
        teacher_min = min_over_data(teacher_logits.float().min(), dp_mesh)
    total, action_logit, parts = multi_task_loss(student, teacher_logits, labels, num_action_classes,
                                                 logit_criterion, logit_criterion_weight, unified_head,
                                                 action_criterion, teacher_min)
    acc = (action_logit[:, :num_action_classes].argmax(dim=-1) == labels).float().mean()
    metrics = {k: v.detach() for k, v in parts.items()}
    return total, {**metrics, "loss": total.detach(), "class_acc": acc}


def make_multi_task_train_step(model: nn.Module, teacher: nn.Module, optimizer: torch.optim.Optimizer,
                               num_action_classes: int, logit_criterion: str = "KL",
                               logit_criterion_weight: float = 1.0, unified_head: bool = False,
                               action_criterion: Callable = cross_entropy, update_freq: int = 1,
                               lr_fn: Optional[Callable[[int], float]] = None, dp_mesh: Optional[SPMesh] = None,
                               device: DeviceLike = None) -> Callable:
    """Multi-task baseline step `step(state, batch, generator=None,
    host_metrics=False) -> metrics`
    (`devias_tpu/train/step.py:459-540`): per micro-batch the student
    (`MultiTaskViT`) in train mode, the frozen scene teacher under
    `no_grad` and `multi_task_loss` (`multi_task_loss_of`), the engine's
    accumulation over `update_freq` micro-batches, then the optimizer.

    `batch` is {"videos": [B, T, H, W, C], "labels": [B]}; device, update
    frequency, generator and `dp_mesh` as in `make_hvu_train_step`; the
    step has no batch op whose draws a caller could fix. Returns `loss`, `action_loss`, `logit_loss`,
    `class_acc`, `grad_norm` and, with `lr_fn`, `lr`."""
    _check_dp_mesh(dp_mesh)
    dev = resolve_device(device)
    require_on(model, dev)
    require_on(teacher, dev, "teacher")
    teacher.eval().requires_grad_(False)
    own_generator = _layout_generator(dp_mesh, dev)

    graph = StepGraph()

    def micro(x, sl, gen, _):
        return multi_task_loss_of(model, teacher, x["videos"][sl], x["labels"][sl], num_action_classes,
                                  logit_criterion, logit_criterion_weight, unified_head, action_criterion, gen, dp_mesh)

    def step(state: TrainState, batch: Dict, generator: Optional[torch.Generator] = None,
             host_metrics: bool = False):
        inputs = {"videos": to_device(batch["videos"], dev), "labels": to_device(batch["labels"], dev).long()}
        return _run_step(state, optimizer, model, inputs, update_freq, micro,
                         own_generator if generator is None else generator, None, dp_mesh,
                         MULTI_TASK_METRIC_NAMES, lr_fn, host_metrics, graph)

    step.graph = graph
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
        with span("eval.forward"), torch.inference_mode():
            out = model(to_device(videos, dev))
        return out[output_key] if output_key else out

    return step
