"""HVU slot training of the port (port of
`devias_tpu/cli/run_slot_finetuning_hvu.py`, ref run_slot_finetuning_hvu.py
and engine/engine_for_slot_hvu.py): real action and scene labels,
FAME-HVU, no teacher.

    python -m devias_tpu_torch.cli.run_slot_finetuning_hvu [flags]

Flag-compatible with the JAX CLI (`cli/common.py` lists the differences).
The model is the slot ViT with a 739 + 248 head (HVU's action and scene
classes), 4 latents and 4 untied agg layers by default; on `cuda` it runs
K1 where `use_attention_kernel` allows it. Each epoch trains
(`make_hvu_train_step`) and validates action and scene top-1 over the full
unified head (`hvu_validation`); checkpoints and resume as in
`run_slot_finetuning`. Several processes train data-parallel (one data
row each), FAME-HVU mixing the global micro-batch. `main` returns the
per-epoch loop times and the best validation top-1.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from devias_tpu_torch.aug.fame import FAMEConfig
from devias_tpu_torch.cli.common import (
    JsonlLogger,
    attention_kernel_for,
    build_shared_parser,
    eval_fn,
    finetune_surgery,
    global_batch,
    make_data_config,
    make_eval_loader,
    make_optim_config,
    make_train_loader,
    reject_unported,
    resume,
    run_train_loop,
    tiny_overrides,
    world,
)
from devias_tpu_torch.core.dist import make_mesh, maybe_init_distributed
from devias_tpu_torch.data import build_dataset
from devias_tpu_torch.data.datasets import HVU_NUM_ACTION_CLASSES, HVU_NUM_SCENE_CLASSES
from devias_tpu_torch.device import resolve_device
from devias_tpu_torch.eval.protocols import _pad_batch, _pipelined
from devias_tpu_torch.losses import SlotLossConfig
from devias_tpu_torch.nn import create_model
from devias_tpu_torch.train import TrainState, TrainStepConfig, make_hvu_train_step, make_optimizer


def get_args(argv=None):
    parser = argparse.ArgumentParser("HVU slot training (PyTorch)", parents=[build_shared_parser("hvu")])
    parser.add_argument("--agg_weights_tie", default=False, action="store_true")
    parser.add_argument("--agg_depth", default=4, type=int)
    # the reference parser's defaults (ref run_slot_finetuning_hvu.py:43-73);
    # its mask_model default is '', which trains without the mask losses
    parser.add_argument("--mask_model", default="", choices=["FAME", ""], type=str)
    parser.add_argument("--beta", type=float, default=0.5)
    parser.add_argument("--prob_aug", type=float, default=0.5)
    parser.add_argument("--mask_distill_loss_weight", type=float, default=1.0)
    parser.add_argument("--mask_prediction_loss_weight", type=float, default=3.0)
    parser.add_argument("--scene_criterion", default="KL", choices=["KL", "CE"], type=str)
    parser.add_argument("--num_latents", type=int, default=4)
    parser.add_argument("--agg_block_scale", type=float, default=0.8)
    parser.add_argument("--head_type", type=str, default="linear")
    parser.add_argument("--slot_matching_method", type=str, default="matching")
    # accepted for command compatibility: defined by the reference parser
    # (run_slot_finetuning_hvu.py:49,57,178) and read nowhere in it
    parser.add_argument("--scene_model_path", default="", type=str)
    parser.add_argument("--nb_knn", default=[10, 20], nargs="+", type=int)
    parser.add_argument("--eval_data_path", default=None, type=str)
    parser.set_defaults(model="slot_vit_base_patch16_224", data_set="HVU")
    return parser.parse_args(argv)


def build_hvu_model(args, device: torch.device, num_action: int = HVU_NUM_ACTION_CLASSES,
                    num_scene: int = HVU_NUM_SCENE_CLASSES, dtype: torch.dtype = torch.bfloat16):
    """The HVU student (`--model`, a num_action + num_scene head) with
    --smoke_tiny's overrides, weights from `--seed`, on `device`; K1 where
    `use_attention_kernel` allows it."""
    return create_model(
        args.model, device=device, seed=args.seed, **tiny_overrides(args),
        num_classes=num_action, num_scene_classes=num_scene, tubelet_size=args.tubelet_size,
        img_size=args.input_size, fc_drop_rate=args.fc_drop_rate, drop_rate=args.drop,
        drop_path_rate=args.drop_path, attn_drop_rate=args.attn_drop_rate, init_scale=args.init_scale,
        num_latents=args.num_latents, head_type=args.head_type, slot_matching_method=args.slot_matching_method,
        agg_weights_tie=args.agg_weights_tie, agg_depth=args.agg_depth,
        fused_attention=attention_kernel_for(args, device), dtype=dtype,
    )


def load_hvu_weights(args, model) -> None:
    """--finetune into the HVU student, with the reference's surgery."""
    agg_unique = 1 if args.agg_weights_tie else args.agg_depth
    finetune_surgery(args, "slot", model, HVU_NUM_ACTION_CLASSES + HVU_NUM_SCENE_CLASSES,
                     agg_unique_layers=agg_unique)


def both_logits_fn(model, device: torch.device):
    """The student's (action logit, scene logit) over the full unified
    head, in eval mode."""
    return eval_fn(model, device, lambda o: (o["action_logit"], o["scene_logit"]))


def hvu_validation(loader, forward_fn, batch_size: int, num_action: int) -> dict:
    """Action and scene top-1 over the full unified head, scene targets
    shifted by the action count (ref engine_for_slot_hvu.py:156-200: the
    reference never slices the head here). `forward_fn(videos)` ->
    (action logits, scene logits)."""
    a1 = s1 = total = 0

    def dispatch(batch):
        videos, n = _pad_batch(batch["videos"], batch_size)
        return forward_fn(videos), (batch, n)

    for (action_logit, scene_logit), (batch, n) in _pipelined(loader, dispatch):
        a1 += int((action_logit[:n].argmax(-1) == np.asarray(batch["labels"])[:n]).sum())
        s1 += int((scene_logit[:n].argmax(-1) == np.asarray(batch["scene_labels"])[:n] + num_action).sum())
        total += n
    return {"acc1": a1 / max(total, 1) * 100, "scene_acc1": s1 / max(total, 1) * 100}


def main(args=None) -> dict:
    args = args or get_args()
    reject_unported(args)
    if args.sp_shards > 1:
        raise ValueError("--sp_shards: the HVU step has no sequence-parallel form (nor has the JAX package's)")
    dev = resolve_device(args.device)
    maybe_init_distributed(dev)
    rank, size = world()
    dp_mesh = make_mesh() if size > 1 else None
    # rank-offset seeding (ref run_slot_finetuning.py:261-265)
    np.random.seed(args.seed + rank)

    model = build_hvu_model(args, dev)
    load_hvu_weights(args, model)

    cfg = make_data_config(args)
    ds_train, (num_action, num_scene) = build_dataset(True, False, cfg)
    loader_train = make_train_loader(ds_train, args)
    ds_val, _ = build_dataset(False, False, cfg)
    loader_val = make_eval_loader(ds_val, args)

    steps_per_epoch = len(ds_train) // global_batch(args)
    if args.max_steps_per_epoch:
        steps_per_epoch = min(steps_per_epoch, args.max_steps_per_epoch)
    opt_cfg = make_optim_config(args, args.epochs * steps_per_epoch, steps_per_epoch,
                                agg_block_scale=args.agg_block_scale)
    opt, lr_fn = make_optimizer(model, opt_cfg, device=dev)
    state = TrainState.create(model, opt, use_ema=args.model_ema, ema_decay=args.model_ema_decay, device=dev)
    # the step's draws in one state on every rank; a layout's step splits
    # its streams from a host generator
    generator = torch.Generator(device="cpu" if dp_mesh is not None else dev).manual_seed(args.seed)
    start_epoch = resume(args, state, generator)

    loss_cfg = SlotLossConfig(
        num_action_classes=num_action,
        num_scene_classes=num_scene,
        slot_matching_method=args.slot_matching_method,
        scene_criterion=args.scene_criterion,
        mask_prediction_loss_weight=args.mask_prediction_loss_weight,
        mask_distill_loss_weight=args.mask_distill_loss_weight,
    )
    step_cfg = TrainStepConfig(
        update_freq=args.update_freq,
        use_fame=args.mask_model == "FAME",
        fame=FAMEConfig(beta=args.beta, prob_aug=args.prob_aug),
    )
    train_step = make_hvu_train_step(model, opt, loss_cfg, step_cfg, lr_fn, dp_mesh=dp_mesh, device=dev)
    logits_fn = both_logits_fn(model, dev)

    def validate(state):
        return hvu_validation(loader_val, logits_fn, args.batch_size, num_action)

    try:
        _, best, history = run_train_loop(
            args, state, train_step, loader_train, steps_per_epoch, device=dev, generator=generator,
            validate=validate, logger=JsonlLogger(args.output_dir, rank == 0), start_epoch=start_epoch, rank=rank,
            batch_keys=("videos", "labels", "scene_labels"),
        )
    finally:
        loader_train.close()
        loader_val.close()
    return {"epochs": history, "best_acc1": best}


if __name__ == "__main__":
    main()
