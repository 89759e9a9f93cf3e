"""DEVIAS slot training / evaluation entry point of the port (port of
`devias_tpu/cli/run_slot_finetuning.py`, ref run_slot_finetuning.py:250-740).

    python -m devias_tpu_torch.cli.run_slot_finetuning [flags]

Flag-compatible with the JAX CLI (`cli/common.py` lists the differences).
On `cuda` (the default) the student and the teacher run the hand-written
attention kernel (K1, `fused_attention=True`) when their head dim is the
one it takes (64; `use_attention_kernel`); otherwise, and on `cpu`, its
plain version.
Parameters are initialised from `torch.Generator`s seeded by `--seed`
(student) and `--seed + 1` (teacher). Modes: training (the slot train step
with FAME, or with `--mask_model Segformer` the frozen SegFormer's person
masks from the local HF checkpoint `--segformer_ckpt`, run in bfloat16;
validation each epoch with best-checkpoint tracking, final test
and merge), `--hat_eval` (alone, with action or `--eval_scene` targets),
else `--eval`, `--eval_scene`, `--run_scuba` and `--run_knn`, in the JAX
CLI's dispatch order. `main` returns what it ran: per-epoch loop times and
the final numbers, or the evaluations' results.

Several processes (torchrun, or DEVIAS_TPU_COORDINATOR/NUM_PROCS/PROC_ID)
train data-parallel, one data row per process; with `--sp_shards S`, S
processes form a row's seq group. Each row reads its own shard of the
training set, `--dist_eval` shards the test views over every process, and
rank 0 writes the log and the checkpoints.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from devias_tpu_torch.aug.fame import FAMEConfig
from devias_tpu_torch.ckpt import load_reference_checkpoint, save_checkpoint
from devias_tpu_torch.cli.common import (
    JsonlLogger,
    attention_kernel_for,
    build_shared_parser,
    eval_fn,
    finetune_surgery,
    global_batch,
    make_data_config,
    make_eval_loader,
    make_hat_loader_factory,
    make_optim_config,
    make_scuba_loader,
    make_train_loader,
    reject_unported,
    resume,
    run_knn_protocol,
    run_train_loop,
    test_and_merge,
    tiny_overrides,
    use_attention_kernel,
    world,
)
from devias_tpu_torch.core.dist import make_mesh, make_sp_mesh, maybe_init_distributed
from devias_tpu_torch.data import build_dataset
from devias_tpu_torch.device import resolve_device
from devias_tpu_torch.eval import hat_eval, run_scuba, validation_one_epoch
from devias_tpu_torch.losses import SlotLossConfig
from devias_tpu_torch.nn import create_model
from devias_tpu_torch.train import TrainState, TrainStepConfig, make_optimizer, make_slot_train_step


def get_args(argv=None):
    parser = argparse.ArgumentParser("DEVIAS slot training (PyTorch)", parents=[build_shared_parser("slot")])
    # slot-specific flags (ref run_slot_finetuning.py:43-73, 184-213)
    parser.add_argument("--run_knn", action="store_true", default=False)
    parser.add_argument("--run_scuba", action="store_true", default=False)
    parser.add_argument("--agg_weights_tie", default=False, action="store_true")
    parser.add_argument("--agg_depth", default=8, type=int)
    parser.add_argument("--scene_model_path", default="", type=str)
    parser.add_argument("--mask_model", default="", choices=["FAME", "Segformer", ""], type=str)
    parser.add_argument("--segformer_ckpt", default="", type=str,
                        help="local SegFormer-B3 checkpoint (HF snapshot dir / pytorch_model.bin / "
                             "model.safetensors) for --mask_model Segformer; the reference pulls "
                             "nvidia/segformer-b3-finetuned-cityscapes from the hub (ref run_slot_finetuning.py:425), "
                             "here the weights must be local")
    parser.add_argument("--segformer_variant", default="b3", choices=["b0", "b3"], type=str,
                        help="SegFormer geometry; the reference uses b3 (b0 exists for tests)")
    parser.add_argument("--beta", type=float, default=0.5)
    parser.add_argument("--prob_aug", type=float, default=0.5)
    parser.add_argument("--mask_distill_loss_weight", type=float, default=1)
    parser.add_argument("--mask_prediction_loss_weight", type=float, default=3)
    parser.add_argument("--scene_loss_weight", type=float, default=4000)
    parser.add_argument("--scene_criterion", default="KL", choices=["KL", "CE"], type=str)
    parser.add_argument("--nb_knn", default=[10, 20], nargs="+", type=int)
    parser.add_argument("--temperature", default=0.07, type=float)
    parser.add_argument("--num_latents", type=int, default=4)
    parser.add_argument("--agg_block_scale", type=float, default=0.8)
    parser.add_argument("--head_type", type=str, default="linear")
    parser.add_argument("--slot_matching_method", type=str, default="matching", choices=["hard_select", "matching"])
    parser.add_argument("--hat_split", default="1", choices=["1", "2", "3"], type=str)
    parser.add_argument("--hat_eval", action="store_true")
    parser.add_argument("--hat_anno_path", default="", type=str)
    parser.add_argument("--scuba_val", action="store_true")
    parser.add_argument("--eval_scene", action="store_true")
    parser.add_argument("--teacher_int8", action="store_true", default=False,
                        help="w8a8 int8 GEMMs in the frozen scene teacher's blocks (nn/quant.py); "
                             "not the parity path: it perturbs the teacher's logits, and on an H100 "
                             "the teacher runs slower than in bf16 (PERF.md)")
    parser.set_defaults(model="slot_vit_base_patch16_224")
    return parser.parse_args(argv)


def build_models(args, device: torch.device, dtype: torch.dtype = torch.bfloat16):
    """The student (`--model`, checkpointed with --use_checkpoint) and the
    frozen CLS scene teacher (`vit_base_patch16_224`, ref
    run_slot_finetuning.py:392-406; w8a8 with --teacher_int8), with
    `--smoke_tiny`'s overrides, weights from `--seed` and `--seed + 1`,
    on `device`; K1 where `use_attention_kernel` allows it, its plain
    version elsewhere (logged once)."""
    tiny = tiny_overrides(args)
    fused = attention_kernel_for(args, device)
    model = create_model(
        args.model, device=device, seed=args.seed, **tiny,
        num_classes=args.nb_classes, num_scene_classes=365, tubelet_size=args.tubelet_size,
        img_size=args.input_size, fc_drop_rate=args.fc_drop_rate, drop_rate=args.drop,
        drop_path_rate=args.drop_path, attn_drop_rate=args.attn_drop_rate, init_scale=args.init_scale,
        num_latents=args.num_latents, head_type=args.head_type, slot_matching_method=args.slot_matching_method,
        agg_weights_tie=args.agg_weights_tie, agg_depth=args.agg_depth, input_norm=args.device_normalize,
        remat=args.use_checkpoint, fused_attention=fused, dtype=dtype,
    )
    teacher = create_model(
        "vit_base_patch16_224", device=device, seed=args.seed + 1, **tiny,
        num_classes=365, tubelet_size=args.tubelet_size, use_mean_pooling=False,
        input_norm=args.device_normalize, int8_dense=args.teacher_int8, fused_attention=fused, dtype=dtype,
    )
    return model, teacher


def build_segformer(args, device: torch.device, dtype: torch.dtype = torch.bfloat16):
    """The frozen SegFormer person-mask model of `--mask_model Segformer`
    (ref run_slot_finetuning.py:423-427) with `--segformer_ckpt`'s weights,
    as a function of frames [N, H, W, 3] -> quarter-res logits; None for
    any other mask model."""
    if args.mask_model != "Segformer":
        return None
    if not args.segformer_ckpt:
        raise SystemExit(
            "--mask_model Segformer requires --segformer_ckpt pointing at a local "
            "nvidia/segformer-b3-finetuned-cityscapes-1024-1024 checkpoint (HF snapshot dir, pytorch_model.bin, or "
            "model.safetensors). Use FAME (the published DEVIAS recipe) if no weights are available.")
    from devias_tpu_torch.ckpt.segformer_import import load_segformer
    from devias_tpu_torch.nn.segformer import create_segformer, segformer_b0, segformer_b3

    cfg = {"b0": segformer_b0, "b3": segformer_b3}[args.segformer_variant]()
    return load_segformer(create_segformer(cfg, device=device, dtype=dtype), args.segformer_ckpt)


def init_params(args, model, teacher) -> None:
    """--finetune into the student and --scene_model_path into the teacher,
    with the reference's surgery (`ckpt/torch_import.py`)."""
    agg_unique = 1 if args.agg_weights_tie else args.agg_depth
    finetune_surgery(args, "slot", model, args.nb_classes + 365, agg_unique_layers=agg_unique)
    if args.scene_model_path:
        _, rep = load_reference_checkpoint(teacher, args.scene_model_path, "plain", expected_head_out=365)
        print(f"scene teacher load: {len(rep['loaded'])} tensors")


def main(args=None) -> dict:
    args = args or get_args()
    reject_unported(args)
    dev = resolve_device(args.device)
    if not maybe_init_distributed(dev) and args.sp_shards > 1:
        raise RuntimeError("--sp_shards needs a process group: launch one process per shard (torchrun, or "
                           "DEVIAS_TPU_COORDINATOR/NUM_PROCS/PROC_ID)")
    rank, size = world()
    # (data, seq) layout: seq groups of --sp_shards, or pure data parallelism
    sp_mesh = make_sp_mesh(args.sp_shards) if args.sp_shards > 1 else None
    dp_mesh = make_mesh() if sp_mesh is None and size > 1 else None
    # rank-offset seeding (ref run_slot_finetuning.py:261-265)
    np.random.seed(args.seed + rank)

    model, teacher = build_models(args, dev)
    init_params(args, model, teacher)

    action_logits_fn = eval_fn(model, dev, lambda o: o["action_logit"])
    scene_logits_fn = eval_fn(model, dev, lambda o: o["scene_logit"][:, args.nb_classes:])
    teacher_logits_fn = eval_fn(teacher, dev, lambda o: o["logits"])

    if args.eval or args.eval_scene or args.hat_eval or args.run_scuba or args.run_knn:
        return run_evaluations(args, model, dev, action_logits_fn, scene_logits_fn, teacher_logits_fn, rank, size)

    # ---- training --------------------------------------------------------
    cfg_train = make_data_config(args)
    ds_train, nb_classes = build_dataset(True, False, cfg_train)
    if isinstance(nb_classes, int) and nb_classes != args.nb_classes:
        print(f"WARNING: dataset reports {nb_classes} classes but --nb_classes is {args.nb_classes}; "
              f"using --nb_classes")
    loader_train = make_train_loader(ds_train, args)
    ds_val, _ = build_dataset(False, False, cfg_train)
    loader_val = make_eval_loader(ds_val, args)

    steps_per_epoch = len(ds_train) // global_batch(args)
    if args.max_steps_per_epoch:
        steps_per_epoch = min(steps_per_epoch, args.max_steps_per_epoch)
    total_steps = args.epochs * steps_per_epoch
    opt_cfg = make_optim_config(args, total_steps, steps_per_epoch, agg_block_scale=args.agg_block_scale)
    opt, lr_fn = make_optimizer(model, opt_cfg, device=dev)
    state = TrainState.create(model, opt, use_ema=args.model_ema, ema_decay=args.model_ema_decay, device=dev)
    # the step's draws (FAME, dropout, drop-path), in one state on every
    # rank; a layout's step splits its streams from a host generator, and
    # the checkpoint's one state resumes every rank
    layout = sp_mesh is not None or dp_mesh is not None
    generator = torch.Generator(device="cpu" if layout else dev).manual_seed(args.seed)

    start_epoch = resume(args, state, generator)

    loss_cfg = SlotLossConfig(
        num_action_classes=args.nb_classes,
        num_scene_classes=365,
        slot_matching_method=args.slot_matching_method,
        scene_criterion=args.scene_criterion,
        scene_loss_weight=args.scene_loss_weight,
        mask_prediction_loss_weight=args.mask_prediction_loss_weight,
        mask_distill_loss_weight=args.mask_distill_loss_weight,
    )
    step_cfg = TrainStepConfig(
        update_freq=args.update_freq,
        use_fame=args.mask_model == "FAME",
        fame=FAMEConfig(beta=args.beta, prob_aug=args.prob_aug),
        device_normalize=args.device_normalize,
    )
    train_step = make_slot_train_step(model, teacher, opt, loss_cfg, step_cfg, lr_fn,
                                      segformer_apply=build_segformer(args, dev), sp_mesh=sp_mesh, dp_mesh=dp_mesh,
                                      device=dev)

    logger = JsonlLogger(args.output_dir, rank == 0)
    best_scuba = [-1.0]
    ntasks = size if args.dist_eval else 1

    def validate(state):
        return validation_one_epoch(loader_val, action_logits_fn, args.batch_size, device=dev)

    def on_epoch_end(state, epoch, record):
        if not args.scuba_val:
            return None
        # periodic SCUBA validation with scuba-best tracking
        # (ref run_slot_finetuning.py:689-703)
        try:
            scuba = run_scuba(lambda variant: make_scuba_loader(args, variant), action_logits_fn,
                              args.batch_size, os.path.join(args.output_dir or ".", f"scuba_val_ep{epoch}"),
                              num_tasks=ntasks, rank=rank, device=dev)
        except FileNotFoundError as exc:
            print(f"scuba_val skipped: {exc}")
            return None
        mean_top1 = float(np.mean([v["acc1"] for v in scuba.values()])) if scuba else 0.0
        if mean_top1 > best_scuba[0] and args.output_dir and args.save_ckpt and rank == 0:
            best_scuba[0] = mean_top1
            save_checkpoint(os.path.join(args.output_dir, "ckpt_scuba_best"), epoch, state, generator)
        return {"scuba_val_top1": round(mean_top1, 3)}

    state, _, history = run_train_loop(
        args, state, train_step, loader_train, steps_per_epoch, device=dev, generator=generator,
        validate=validate, logger=logger, start_epoch=start_epoch, on_epoch_end=on_epoch_end, rank=rank,
    )

    # final test + merge (ref run_slot_finetuning.py:715-726)
    result = {"epochs": history}
    final = test_and_merge(args, make_data_config(args), action_logits_fn, dev, rank, ntasks)
    if final is not None:
        logger.write({"final_top1": final[0], "final_top5": final[1]})
        result.update(final_top1=final[0], final_top5=final[1])
    loader_train.close()
    loader_val.close()
    return result


def run_evaluations(args, model, device: torch.device, action_logits_fn, scene_logits_fn, teacher_logits_fn,
                    rank: int, size: int = 1) -> dict:
    """The JAX CLI's dispatch order: --hat_eval runs alone and returns
    (ref run_slot_finetuning.py:604-611 exits after it), so --hat_eval
    --eval_scene is the scene HAT only; otherwise --eval, --eval_scene,
    --run_scuba, --run_knn. Result files merge over every process under
    --dist_eval. Returns each one's result."""
    out_dir = args.output_dir or "."
    ntasks = size if args.dist_eval else 1
    results = {}

    if args.hat_eval:
        make_hat_loader, versions = make_hat_loader_factory(args)
        if args.eval_scene:
            # scene HAT: scene logits against the teacher's argmax (ref
            # run_slot_finetuning.py:606-609, hat_eval.py:61)
            res = hat_eval(make_hat_loader, scene_logits_fn, args.batch_size, out_dir, versions=versions,
                           num_tasks=ntasks, rank=rank, scene_label_fn=teacher_logits_fn, device=device)
        else:
            res = hat_eval(make_hat_loader, action_logits_fn, args.batch_size, out_dir, versions=versions,
                           num_tasks=ntasks, rank=rank, device=device)
        print("HAT:", res)
        return {"hat": res}

    if args.eval:
        final = test_and_merge(args, make_data_config(args), action_logits_fn, device, rank, ntasks)
        if final is not None:
            results["eval"] = {"top1": final[0], "top5": final[1]}

    if args.eval_scene:
        final = test_and_merge(args, make_data_config(args), scene_logits_fn, device, rank, ntasks,
                               name="scene_test", scene_label_fn=teacher_logits_fn, label="Scene")
        if final is not None:
            results["eval_scene"] = {"top1": final[0], "top5": final[1]}

    if args.run_scuba:
        # forced 2x3 views (ref run_scuba.py:19)
        res = run_scuba(lambda v: make_scuba_loader(args, v), action_logits_fn, args.batch_size, out_dir,
                        num_tasks=ntasks, rank=rank, device=device)
        print("SCUBA:", res)
        results["scuba"] = res

    if args.run_knn:
        feature_fn = eval_fn(model, device, lambda o: (o["action_feat"], o["scene_feat"]))
        res = run_knn_protocol(args, feature_fn, teacher_logits_fn, rank)
        print("kNN:", res)
        results["knn"] = res
    return results


if __name__ == "__main__":
    main()
