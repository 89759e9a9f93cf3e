"""Downstream transfer with slot fusion, the port's entry point (port of
`devias_tpu/cli/run_slot_downstream.py`, ref run_slot_downstream.py and
model/modeling_slot_fusion.py).

    python -m devias_tpu_torch.cli.run_slot_downstream [flags]

Flag-compatible with the JAX CLI (`cli/common.py` lists the differences).
The model is `slot_fusion_vit_base_patch16_224` (`nn/models.py::
SlotFusionViT`): a DEVIAS slot checkpoint, its unified head of
--nb_classes + 365 included, loads through `--finetune` with the
reference's surgery, and everything is fine-tuned with a new fusion head
of --downstream_nb_classes outputs (nothing frozen). On `cuda` the
backbone runs K1 where `use_attention_kernel` allows it. Training is the
classification step (`make_classification_train_step`) on the fusion
model's `logits`, with the label-smoothing cross-entropy when
--smoothing > 0 (else the cross-entropy), AdamW with layer decay and the
agg block's lr scale --agg_block_scale; validation each epoch, checkpoints
and resume, then the final test and merge. `--eval` runs the final test
alone on the data config of --nb_classes, as the JAX CLI does. Several
processes train data-parallel. `--device_normalize` normalises on the
device (the model is built with `input_norm`). `main` returns what it ran.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from devias_tpu_torch.cli.common import (
    SCENE_CLASSES,
    JsonlLogger,
    attention_kernel_for,
    build_shared_parser,
    eval_fn,
    finetune_surgery,
    global_batch,
    hard_label_criterion,
    make_data_config,
    make_eval_loader,
    make_optim_config,
    make_train_loader,
    reject_unported,
    resume,
    run_train_loop,
    test_and_merge,
    tiny_overrides,
    world,
)
from devias_tpu_torch.core.dist import make_mesh, maybe_init_distributed
from devias_tpu_torch.data import build_dataset
from devias_tpu_torch.device import resolve_device
from devias_tpu_torch.eval import validation_one_epoch
from devias_tpu_torch.nn import create_model
from devias_tpu_torch.train import TrainState, make_classification_train_step, make_optimizer


def get_args(argv=None):
    parser = argparse.ArgumentParser("Slot-fusion downstream transfer (PyTorch)",
                                     parents=[build_shared_parser("downstream")])
    parser.add_argument("--slot_fusion_method", default="concat", choices=["gap", "concat"])
    parser.add_argument("--downstream_nb_classes", default=400, type=int)
    parser.add_argument("--use_input_ln", action="store_true", default=False)
    parser.add_argument("--agg_weights_tie", default=False, action="store_true")
    parser.add_argument("--agg_depth", default=8, type=int)
    parser.add_argument("--num_latents", type=int, default=4)
    parser.add_argument("--head_type", type=str, default="linear")
    parser.add_argument("--agg_block_scale", type=float, default=0.8)
    # accepted for command compatibility: the reference parser defines the
    # mean-pooling toggles, the slot-fusion model never reads them
    parser.add_argument("--use_mean_pooling", action="store_true")
    parser.add_argument("--use_cls", action="store_false", dest="use_mean_pooling")
    parser.set_defaults(model="slot_fusion_vit_base_patch16_224", use_mean_pooling=True, num_workers=8)
    return parser.parse_args(argv)


def build_fusion_model(args, device: torch.device, dtype: torch.dtype = torch.bfloat16):
    """`--model` with the pretrained unified head (--nb_classes + 365) and a
    fusion head of --downstream_nb_classes, --smoke_tiny's overrides,
    weights from `--seed`, on `device`; K1 where `use_attention_kernel`
    allows it."""
    return create_model(
        args.model, device=device, seed=args.seed, **tiny_overrides(args),
        num_classes=args.nb_classes, num_scene_classes=SCENE_CLASSES,
        downstream_nb_classes=args.downstream_nb_classes, tubelet_size=args.tubelet_size,
        fc_drop_rate=args.fc_drop_rate, drop_rate=args.drop, drop_path_rate=args.drop_path,
        attn_drop_rate=args.attn_drop_rate, init_scale=args.init_scale, num_latents=args.num_latents,
        agg_depth=args.agg_depth, agg_weights_tie=args.agg_weights_tie, slot_fusion_method=args.slot_fusion_method,
        head_type=args.head_type, use_input_ln=args.use_input_ln, input_norm=args.device_normalize,
        fused_attention=attention_kernel_for(args, device), dtype=dtype,
    )


def main(args=None) -> dict:
    args = args or get_args()
    reject_unported(args)
    if args.sp_shards > 1:
        raise ValueError("--sp_shards: the downstream step has no sequence-parallel form (nor has the JAX package's)")
    dev = resolve_device(args.device)
    maybe_init_distributed(dev)
    rank, size = world()
    dp_mesh = make_mesh() if size > 1 else None
    # rank-offset seeding (ref run_slot_finetuning.py:261-265)
    np.random.seed(args.seed + rank)

    model = build_fusion_model(args, dev)
    # the slot checkpoint's unified head comes along; an untied agg block
    # reads its agg_depth layers
    agg_unique = 1 if args.agg_weights_tie else args.agg_depth
    finetune_surgery(args, "slot_fusion", model, args.nb_classes + SCENE_CLASSES, agg_unique_layers=agg_unique)
    logits_fn = eval_fn(model, dev, lambda o: o["logits"])
    ntasks = size if args.dist_eval else 1

    if args.eval:
        final = test_and_merge(args, make_data_config(args), logits_fn, dev, rank, ntasks)
        return {} if final is None else {"eval": {"top1": final[0], "top5": final[1]}}

    cfg = make_data_config(args, nb_classes=args.downstream_nb_classes)
    ds_train, _ = build_dataset(True, False, cfg)
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
    train_step = make_classification_train_step(model, opt, hard_label_criterion(args), args.update_freq, lr_fn,
                                                dp_mesh=dp_mesh, device=dev)

    def validate(state):
        return validation_one_epoch(loader_val, logits_fn, args.batch_size, device=dev)

    logger = JsonlLogger(args.output_dir, rank == 0)
    try:
        _, _, history = run_train_loop(
            args, state, train_step, loader_train, steps_per_epoch, device=dev, generator=generator,
            validate=validate, logger=logger, start_epoch=start_epoch, rank=rank,
        )
    finally:
        loader_train.close()
        loader_val.close()

    result = {"epochs": history}
    final = test_and_merge(args, cfg, logits_fn, dev, rank, ntasks)
    if final is not None:
        logger.write({"final_top1": final[0], "final_top5": final[1]})
        result.update(final_top1=final[0], final_top5=final[1])
    return result


if __name__ == "__main__":
    main()
