"""The multi-task baseline (an action CLS token and a scene token), the
port's entry point (port of `devias_tpu/cli/run_multi_task_finetuning.py`,
ref run_multi_task_finetuning.py and engine/engine_for_multi_task.py).

    python -m devias_tpu_torch.cli.run_multi_task_finetuning [flags]

Flag-compatible with the JAX CLI (`cli/common.py` lists the differences).
The student is `disentangle_vit_base_patch16_224` (`nn/models.py::
MultiTaskViT`, 1570 tokens at 16x224x224) with separate heads or
`--unified_head`; the frozen scene teacher is the CLS
`vit_base_patch16_224` with a 365-wide head, loaded from
--scene_model_path through the `plain` import. On `cuda` both run K1
where `use_attention_kernel` allows it. Modes, in the reference's
exclusive order: `--hat_eval` (action, or the scene logits against the
teacher's labels with --eval_scene), else `--run_scuba` (the action test
and the scene test against the teacher's labels on every background),
else `--eval` / `--eval_scene` (the final test of the full-width action,
and of the full-width scene logits against the teacher's labels), else
`--run_knn` on the CLS and scene tokens, else training: the multi-task
step (`make_multi_task_train_step`: the action criterion, the
label-smoothing cross-entropy when --smoothing > 0, plus the scene
logits' KL to the teacher or CE to its argmax), validation each epoch,
checkpoints and resume, the final test and merge. Several processes train
data-parallel. `main` returns what it ran.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

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
    run_knn_protocol,
    run_train_loop,
    test_and_merge,
    tiny_overrides,
    world,
)
from devias_tpu_torch.core.dist import make_mesh, maybe_init_distributed
from devias_tpu_torch.data import build_dataset
from devias_tpu_torch.device import resolve_device
from devias_tpu_torch.eval import hat_eval, run_scuba, validation_one_epoch
from devias_tpu_torch.nn import create_model
from devias_tpu_torch.train import TrainState, make_multi_task_train_step, make_optimizer


def get_args(argv=None):
    parser = argparse.ArgumentParser("Multi-task ViT finetuning (PyTorch)",
                                     parents=[build_shared_parser("multi-task")])
    parser.add_argument("--unified_head", action="store_true", default=False)
    parser.add_argument("--logit_criterion", default="KL", choices=["KL", "CE"], type=str)
    parser.add_argument("--logit_criterion_weight", default=1.0, type=float)
    parser.add_argument("--scene_model_path", default="", type=str)
    parser.add_argument("--eval_scene", action="store_true")
    parser.add_argument("--run_knn", action="store_true", default=False)
    parser.add_argument("--run_scuba", action="store_true", default=False)
    parser.add_argument("--hat_eval", action="store_true", default=False)
    parser.add_argument("--hat_split", default="1", choices=["1", "2", "3"], type=str)
    parser.add_argument("--hat_anno_path", default="", type=str)
    parser.add_argument("--nb_knn", default=[10, 20], nargs="+", type=int)
    parser.add_argument("--temperature", default=0.07, type=float)
    parser.add_argument("--slicing", action="store_true", default=False,
                        help="accepted for command compatibility: the reference parser defines it, nothing reads it")
    parser.set_defaults(model="disentangle_vit_base_patch16_224")
    return parser.parse_args(argv)


def build_models(args, device: torch.device, dtype: torch.dtype = torch.bfloat16):
    """The student (`--model`, --nb_classes action classes, separate or
    --unified_head heads) and the frozen CLS scene teacher
    (`vit_base_patch16_224`, 365 classes), --smoke_tiny's overrides,
    weights from `--seed` and `--seed + 1`, on `device`; K1 where
    `use_attention_kernel` allows it."""
    tiny = tiny_overrides(args)
    fused = attention_kernel_for(args, device)
    model = create_model(
        args.model, device=device, seed=args.seed, **tiny,
        num_classes=args.nb_classes, num_scene_classes=SCENE_CLASSES, tubelet_size=args.tubelet_size,
        fc_drop_rate=args.fc_drop_rate, drop_rate=args.drop, drop_path_rate=args.drop_path,
        attn_drop_rate=args.attn_drop_rate, init_scale=args.init_scale, unified_head=args.unified_head,
        img_size=args.input_size, num_frames=args.num_frames, input_norm=args.device_normalize,
        fused_attention=fused, remat=args.use_checkpoint, dtype=dtype,
    )
    teacher = create_model(
        "vit_base_patch16_224", device=device, seed=args.seed + 1, **tiny,
        num_classes=SCENE_CLASSES, use_mean_pooling=False, tubelet_size=args.tubelet_size,
        input_norm=args.device_normalize, fused_attention=fused, dtype=dtype,
    )
    return model, teacher


def init_params(args, model, teacher) -> None:
    """--finetune into the student (the head width is --nb_classes, plus
    365 with --unified_head) and --scene_model_path into the teacher."""
    finetune_surgery(args, "multi_task", model, args.nb_classes + (SCENE_CLASSES if args.unified_head else 0))
    if args.scene_model_path:
        _, rep = load_reference_checkpoint(teacher, args.scene_model_path, "plain", expected_head_out=SCENE_CLASSES)
        print(f"scene teacher load: {len(rep['loaded'])} tensors")


def main(args=None) -> dict:
    args = args or get_args()
    if args.sp_shards > 1:
        raise ValueError("--sp_shards: the multi-task model has no sequence-parallel form (nor has the JAX "
                         "package's)")
    dev = resolve_device(args.device)
    maybe_init_distributed(dev)
    rank, size = world()
    dp_mesh = make_mesh() if size > 1 else None
    # rank-offset seeding (ref run_slot_finetuning.py:261-265)
    np.random.seed(args.seed + rank)

    model, teacher = build_models(args, dev)
    init_params(args, model, teacher)
    # both at full width: the reference ranks over the whole head (A + 365
    # when unified), and never slices the scene logits at its call sites
    # (`devias_tpu/cli/run_multi_task_finetuning.py:104-120`)
    action_logits_fn = eval_fn(model, dev, lambda o: o["action_logit"])
    scene_logits_fn = eval_fn(model, dev, lambda o: o["scene_logit"])
    teacher_logits_fn = eval_fn(teacher, dev, lambda o: o["logits"])
    out_dir = args.output_dir or "."
    ntasks = size if args.dist_eval else 1

    # the reference's exclusive dispatch order: hat, scuba, eval, knn
    if args.hat_eval:
        make_hat_loader, versions = make_hat_loader_factory(args)
        scene = {"scene_label_fn": teacher_logits_fn} if args.eval_scene else {}
        res = hat_eval(make_hat_loader, scene_logits_fn if args.eval_scene else action_logits_fn, args.batch_size,
                       out_dir, versions=versions, num_tasks=ntasks, rank=rank, device=dev, **scene)
        print("HAT:", res)
        return {"hat": res}
    if args.run_scuba:
        # both the FG (action) and BG (scene against the teacher) tests
        res = run_scuba(lambda v: make_scuba_loader(args, v), action_logits_fn, args.batch_size, out_dir,
                        bg_forward_fn=scene_logits_fn, bg_scene_label_fn=teacher_logits_fn, num_tasks=ntasks,
                        rank=rank, device=dev)
        print("SCUBA:", res)
        return {"scuba": res}
    if args.eval or args.eval_scene:
        results = {}
        cfg = make_data_config(args)
        if args.eval:
            final = test_and_merge(args, cfg, action_logits_fn, dev, rank, ntasks)
            if final is not None:
                results["eval"] = {"top1": final[0], "top5": final[1]}
        if args.eval_scene:
            final = test_and_merge(args, cfg, scene_logits_fn, dev, rank, ntasks, name="scene_test",
                                   scene_label_fn=teacher_logits_fn, label="Scene")
            if final is not None:
                results["eval_scene"] = {"top1": final[0], "top5": final[1]}
        return results
    if args.run_knn:
        feature_fn = eval_fn(model, dev, lambda o: (o["action_token"], o["scene_token"]))
        res = run_knn_protocol(args, feature_fn, teacher_logits_fn, rank)
        print("kNN:", res)
        return {"knn": res}

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
    train_step = make_multi_task_train_step(
        model, teacher, opt, args.nb_classes, args.logit_criterion, args.logit_criterion_weight, args.unified_head,
        hard_label_criterion(args), args.update_freq, lr_fn, dp_mesh=dp_mesh, device=dev)

    def validate(state):
        return validation_one_epoch(loader_val, action_logits_fn, args.batch_size, device=dev)

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
    final = test_and_merge(args, cfg, action_logits_fn, dev, rank, ntasks)
    if final is not None:
        logger.write({"final_top1": final[0], "final_top5": final[1]})
        result.update(final_top1=final[0], final_top5=final[1])
    return result


if __name__ == "__main__":
    main()
