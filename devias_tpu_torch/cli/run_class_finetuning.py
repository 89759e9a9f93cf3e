"""Plain video-classification finetuning of the port (port of
`devias_tpu/cli/run_class_finetuning.py`, ref run_class_finetuning.py and
engine/engine_for_finetuning.py): the baseline action model, and with
`--use_cls --scene_labels_from` the scene-model architecture trained on a
frozen teacher's argmax labels (ref engine_for_finetuning_scene.py).

    python -m devias_tpu_torch.cli.run_class_finetuning [flags]

Flag-compatible with the JAX CLI (`cli/common.py` lists the differences).
The model is `--model` (`vit_base_patch16_224`): mean-pooled with
`fc_norm`, or the CLS token with the final norm under `--use_cls`; on
`cuda` it runs K1 where `use_attention_kernel` allows it. The criterion is
the soft-target cross-entropy under mixup / CutMix (`--mixup` or
`--cutmix` > 0, the default), else the label-smoothing cross-entropy when
`--smoothing` > 0, else the cross-entropy; `--opt` picks AdamW, Adam, SGD
(Nesterov) or heavy-ball momentum. Modes: training (validation each
epoch, checkpoints and resume, then the final test and merge), or
`--eval`, `--run_scuba` and `--hat_eval` on the model as built and
`--finetune`d. `--scene_labels_from CKPT` loads a reference-layout
`vit_base_patch16_224` CLS teacher with a 365-wide head and relabels each
batch with its argmax before the step. Several processes train
data-parallel, mixup mixing the global micro-batch. `main` returns what it
ran.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from devias_tpu_torch.aug.mixup import MixupConfig
from devias_tpu_torch.ckpt import load_reference_checkpoint
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
    make_hat_loader_factory,
    make_optim_config,
    make_scuba_loader,
    make_train_loader,
    resume,
    run_train_loop,
    test_and_merge,
    tiny_overrides,
    world,
)
from devias_tpu_torch.core.dist import make_mesh, maybe_init_distributed
from devias_tpu_torch.data import build_dataset
from devias_tpu_torch.device import resolve_device
from devias_tpu_torch.eval import hat_eval, run_scuba, validation_one_epoch
from devias_tpu_torch.losses import soft_target_cross_entropy
from devias_tpu_torch.nn import create_model
from devias_tpu_torch.train import TrainState, make_classification_train_step, make_optimizer
from devias_tpu_torch.train.step import to_device


def get_args(argv=None):
    parser = argparse.ArgumentParser("Plain ViT finetuning (PyTorch)", parents=[build_shared_parser("class")])
    parser.add_argument("--use_cls", action="store_true", default=False,
                        help="CLS-token head instead of mean pooling (ref :142-144)")
    parser.add_argument("--use_mean_pooling", action="store_true", default=True)
    parser.add_argument("--run_scuba", action="store_true", default=False)
    parser.add_argument("--hat_eval", action="store_true")
    parser.add_argument("--hat_split", default="1", choices=["1", "2", "3"], type=str)
    parser.add_argument("--hat_anno_path", default="", type=str)
    parser.add_argument("--scene_labels_from", default="", type=str,
                        help="scene-teacher ckpt: train against its argmax pseudo labels (engine_for_finetuning_scene)")
    parser.set_defaults(model="vit_base_patch16_224", num_workers=8)
    return parser.parse_args(argv)


def build_class_model(args, device: torch.device, dtype: torch.dtype = torch.bfloat16):
    """`--model` with --nb_classes outputs, mean-pooled or (--use_cls) the
    CLS token, --smoke_tiny's overrides, weights from `--seed`, on
    `device`; K1 where `use_attention_kernel` allows it."""
    return create_model(
        args.model, device=device, seed=args.seed, **tiny_overrides(args),
        num_classes=args.nb_classes, tubelet_size=args.tubelet_size, fc_drop_rate=args.fc_drop_rate,
        drop_rate=args.drop, drop_path_rate=args.drop_path, attn_drop_rate=args.attn_drop_rate,
        init_scale=args.init_scale, use_mean_pooling=not args.use_cls, input_norm=args.device_normalize,
        fused_attention=attention_kernel_for(args, device), remat=args.use_checkpoint, dtype=dtype,
    )


def build_scene_teacher(args, device: torch.device, dtype: torch.dtype = torch.bfloat16):
    """The frozen `vit_base_patch16_224` CLS teacher with a 365-wide head,
    --smoke_tiny's overrides, loaded from --scene_labels_from (a
    reference-layout checkpoint, `ckpt/torch_import.py`), in eval mode."""
    teacher = create_model(
        "vit_base_patch16_224", device=device, seed=args.seed + 1, **tiny_overrides(args),
        num_classes=SCENE_CLASSES, use_mean_pooling=False, input_norm=args.device_normalize,
        fused_attention=attention_kernel_for(args, device), dtype=dtype,
    )
    _, rep = load_reference_checkpoint(teacher, args.scene_labels_from, "plain", expected_head_out=SCENE_CLASSES)
    print(f"scene teacher load: {len(rep['loaded'])} tensors")
    return teacher.eval().requires_grad_(False)


def with_pseudo_labels(step, teacher, device: torch.device):
    """`step` on batches relabelled with the teacher's argmax (ref
    engine_for_finetuning_scene.py:59-63), computed under `no_grad` on the
    clips before the step."""

    def pseudo_step(state, batch, generator=None, draws=None, host_metrics=False):
        videos = to_device(batch["videos"], device)
        with torch.no_grad():
            labels = teacher(videos)["logits"].argmax(dim=-1)
        return step(state, {**batch, "videos": videos, "labels": labels}, generator=generator, draws=draws,
                    host_metrics=host_metrics)

    return pseudo_step


def make_criterion(args):
    """(criterion, mixup config or None): the soft-target cross-entropy
    under mixup / CutMix, else the label-smoothing cross-entropy when
    --smoothing > 0, else the cross-entropy (ref run_class_finetuning.py)."""
    if args.mixup > 0 or args.cutmix > 0:
        mixup_cfg = MixupConfig(
            mixup_alpha=args.mixup, cutmix_alpha=args.cutmix, prob=args.mixup_prob,
            switch_prob=args.mixup_switch_prob, label_smoothing=args.smoothing, num_classes=args.nb_classes,
            mode=args.mixup_mode, cutmix_minmax=tuple(args.cutmix_minmax) if args.cutmix_minmax else None,
        )
        return soft_target_cross_entropy, mixup_cfg
    return hard_label_criterion(args), None


def main(args=None) -> dict:
    args = args or get_args()
    if args.sp_shards > 1:
        raise ValueError("--sp_shards: the classification step has no sequence-parallel form "
                         "(nor has the JAX package's)")
    dev = resolve_device(args.device)
    maybe_init_distributed(dev)
    rank, size = world()
    dp_mesh = make_mesh() if size > 1 else None
    # rank-offset seeding (ref run_slot_finetuning.py:261-265)
    np.random.seed(args.seed + rank)

    model = build_class_model(args, dev)
    finetune_surgery(args, "plain", model, args.nb_classes)
    logits_fn = eval_fn(model, dev, lambda o: o["logits"])
    out_dir = args.output_dir or "."
    ntasks = size if args.dist_eval else 1

    if args.eval or args.hat_eval or args.run_scuba:
        results = {}
        if args.eval:
            final = test_and_merge(args, make_data_config(args), logits_fn, dev, rank, ntasks)
            if final is not None:
                results["eval"] = {"top1": final[0], "top5": final[1]}
        if args.run_scuba:
            results["scuba"] = run_scuba(lambda v: make_scuba_loader(args, v), logits_fn, args.batch_size, out_dir,
                                         num_tasks=ntasks, rank=rank, device=dev)
            print("SCUBA:", results["scuba"])
        if args.hat_eval:
            make_hat_loader, versions = make_hat_loader_factory(args)
            results["hat"] = hat_eval(make_hat_loader, logits_fn, args.batch_size, out_dir, versions=versions,
                                      num_tasks=ntasks, rank=rank, device=dev)
            print("HAT:", results["hat"])
        return results

    cfg = make_data_config(args)
    ds_train, _ = build_dataset(True, False, cfg)
    loader_train = make_train_loader(ds_train, args)
    ds_val, _ = build_dataset(False, False, cfg)
    loader_val = make_eval_loader(ds_val, args)

    steps_per_epoch = len(ds_train) // global_batch(args)
    if args.max_steps_per_epoch:
        steps_per_epoch = min(steps_per_epoch, args.max_steps_per_epoch)
    opt_cfg = make_optim_config(args, args.epochs * steps_per_epoch, steps_per_epoch)
    opt, lr_fn = make_optimizer(model, opt_cfg, device=dev)
    state = TrainState.create(model, opt, use_ema=args.model_ema, ema_decay=args.model_ema_decay, device=dev)
    # the step's draws in one state on every rank; a layout's step splits
    # its streams from a host generator
    generator = torch.Generator(device="cpu" if dp_mesh is not None else dev).manual_seed(args.seed)
    start_epoch = resume(args, state, generator)

    criterion, mixup_cfg = make_criterion(args)
    train_step = make_classification_train_step(model, opt, criterion, args.update_freq, lr_fn,
                                                mixup_cfg=mixup_cfg, dp_mesh=dp_mesh, device=dev)
    if args.scene_labels_from:
        train_step = with_pseudo_labels(train_step, build_scene_teacher(args, dev), dev)

    def validate(state):
        return validation_one_epoch(loader_val, logits_fn, args.batch_size, device=dev)

    logger = JsonlLogger(args.output_dir, rank == 0)
    try:
        _, _, history = run_train_loop(
            args, state, train_step, loader_train, steps_per_epoch, device=dev, generator=generator,
            validate=validate, logger=logger, start_epoch=start_epoch, rank=rank, layout=dp_mesh,
        )
    finally:
        loader_train.close()
        loader_val.close()

    result = {"epochs": history}
    final = test_and_merge(args, make_data_config(args), logits_fn, dev, rank, ntasks)
    if final is not None:
        logger.write({"final_top1": final[0], "final_top5": final[1]})
        result.update(final_top1=final[0], final_top5=final[1])
    return result


if __name__ == "__main__":
    main()
