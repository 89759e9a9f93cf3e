"""Shared CLI plumbing (port of `devias_tpu/cli/common.py`): the
reference's flag surface, names and defaults kept so published commands
run unchanged (ref run_slot_finetuning.py:37-247), the one epoch loop, and
the helpers the entry points share: `run_slot_finetuning`,
`run_slot_finetuning_hvu`, `eval_slot_finetuning_hvu`,
`run_class_finetuning`, `run_slot_downstream` and
`run_multi_task_finetuning`.

Differences from the JAX parser: `--device` defaults to `cuda` (the JAX
one to `tpu`), and `--profile_dir` captures a `torch.profiler` trace.
Flags whose path is not ported are accepted by the parser and raise
`NotImplementedError` naming their `ROADMAP.md` item when a run asks for
them (`reject_unported`).
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import time
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from devias_tpu_torch.ckpt import auto_resume, load_reference_checkpoint, save_checkpoint
from devias_tpu_torch.data import DataConfig, DataLoader, device_prefetch
from devias_tpu_torch.kernels.attention import HEAD_DIM
from devias_tpu_torch.train import OptimConfig
from devias_tpu_torch.train.step import to_device
from devias_tpu_torch.utils import MetricLogger, TensorLogger

PRINT_FREQ = 50  # steps between the loop's synchronising metric reads
SCENE_CLASSES = 365  # the Places-365 scene teacher's head, and the unified heads' scene block


def build_shared_parser(description: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description, add_help=False)
    # schedule / batch (ref :39-42)
    p.add_argument("--batch_size", default=64, type=int)
    p.add_argument("--epochs", default=30, type=int)
    p.add_argument("--update_freq", default=1, type=int)
    p.add_argument("--save_ckpt_freq", default=100, type=int)
    # model (ref :68-83)
    p.add_argument("--model", default="vit_base_patch16_224", type=str)
    p.add_argument("--tubelet_size", type=int, default=2)
    p.add_argument("--input_size", default=224, type=int)
    p.add_argument("--fc_drop_rate", type=float, default=0.0)
    p.add_argument("--drop", type=float, default=0.0)
    p.add_argument("--attn_drop_rate", type=float, default=0.0)
    p.add_argument("--drop_path", type=float, default=0.1)
    p.add_argument("--disable_eval_during_finetuning", action="store_true", default=False)
    p.add_argument("--model_ema", action="store_true", default=False)
    p.add_argument("--model_ema_decay", type=float, default=0.9999)
    # optimizer (ref :91-119)
    p.add_argument("--opt", default="adamw", type=str)
    p.add_argument("--opt_eps", default=1e-8, type=float)
    p.add_argument("--opt_betas", default=None, type=float, nargs="+")
    p.add_argument("--clip_grad", type=float, default=None)
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--weight_decay", type=float, default=0.05)
    p.add_argument("--weight_decay_end", type=float, default=None)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--layer_decay", type=float, default=0.75)
    p.add_argument("--warmup_lr", type=float, default=1e-6)
    p.add_argument("--min_lr", type=float, default=1e-6)
    p.add_argument("--warmup_epochs", type=int, default=5)
    p.add_argument("--warmup_steps", type=int, default=-1)
    # augmentation (ref :122-161)
    p.add_argument("--color_jitter", type=float, default=0.4)
    p.add_argument("--num_sample", type=int, default=2)
    p.add_argument("--aa", type=str, default="rand-m7-n4-mstd0.5-inc1")
    p.add_argument("--smoothing", type=float, default=0.1)
    p.add_argument("--train_interpolation", type=str, default="bicubic")
    p.add_argument("--crop_pct", type=float, default=None)
    p.add_argument("--short_side_size", type=int, default=224)
    p.add_argument("--test_num_segment", type=int, default=5)
    p.add_argument("--test_num_crop", type=int, default=3)
    p.add_argument("--reprob", type=float, default=0.25)
    p.add_argument("--remode", type=str, default="pixel")
    p.add_argument("--recount", type=int, default=1)
    p.add_argument("--resplit", action="store_true", default=False)
    p.add_argument("--mixup", type=float, default=0.8)
    p.add_argument("--cutmix", type=float, default=1.0)
    p.add_argument("--cutmix_minmax", type=float, nargs="+", default=None)
    p.add_argument("--mixup_prob", type=float, default=1.0)
    p.add_argument("--mixup_switch_prob", type=float, default=0.5)
    p.add_argument("--mixup_mode", type=str, default="batch")
    # finetune / init (ref :164-168)
    p.add_argument("--finetune", default="")
    p.add_argument("--model_key", default="model|module", type=str)
    p.add_argument("--model_prefix", default="", type=str)
    p.add_argument("--init_scale", default=0.001, type=float)
    p.add_argument("--use_checkpoint", action="store_true")
    # data (ref :172-189)
    p.add_argument("--data_path", default="./filelist/k400", type=str)
    p.add_argument("--data_prefix", default="", type=str)
    p.add_argument("--anno_path", default="", type=str)
    p.add_argument("--nb_classes", default=400, type=int)
    p.add_argument("--imagenet_default_mean_and_std", default=True, action="store_true")
    p.add_argument("--num_segments", type=int, default=1)
    p.add_argument("--num_frames", type=int, default=16)
    p.add_argument("--sampling_rate", type=int, default=4)
    p.add_argument("--data_set", default="Kinetics-400", type=str)
    p.add_argument("--synthetic_data", action="store_true", default=False,
                   help="extension: random frames, no video files needed")
    # run control (ref :191-228)
    p.add_argument("--output_dir", default="")
    p.add_argument("--log_dir", default=None)
    p.add_argument("--device", default="cuda",
                   help="cuda (the default) or cpu; the port never falls back from one to the other")
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--resume", default="")
    p.add_argument("--auto_resume", action="store_true", default=True)
    p.add_argument("--no_auto_resume", action="store_false", dest="auto_resume")
    p.add_argument("--save_ckpt", action="store_true", default=True)
    p.add_argument("--no_save_ckpt", action="store_false", dest="save_ckpt")
    p.add_argument("--start_epoch", default=0, type=int)
    p.add_argument("--eval", action="store_true")
    p.add_argument("--dist_eval", action="store_true", default=False)
    p.add_argument("--num_workers", default=10, type=int)
    p.add_argument("--pin_mem", action="store_true", default=True)
    p.add_argument("--no_pin_mem", action="store_false", dest="pin_mem")
    p.add_argument("--world_size", default=1, type=int)
    p.add_argument("--enable_deepspeed", action="store_true", default=False,
                   help="accepted for command compatibility; bf16 needs no engine")
    # torch-launcher compatibility no-ops, as in the JAX package
    # (ref run_slot_finetuning.py:87-88,222-228)
    p.add_argument("--model_ema_force_cpu", action="store_true", default=False,
                   help="accepted for command compatibility (the EMA lives on the device)")
    p.add_argument("--local_rank", "--local-rank", default=-1, type=int,
                   help="accepted for command compatibility (torchrun's LOCAL_RANK is read from the environment)")
    p.add_argument("--dist_on_itp", action="store_true",
                   help="accepted for command compatibility (no-op)")
    p.add_argument("--dist_url", default="env://",
                   help="accepted for command compatibility (no-op)")
    # extensions
    p.add_argument("--zero1", action="store_true", default=False,
                   help="extension: shard AdamW moments over the data axis (not ported yet)")
    p.add_argument("--fsdp", action="store_true", default=False,
                   help="extension: shard params, EMA and AdamW moments over the data axis (not ported yet)")
    p.add_argument("--pp_stages", default=1, type=int,
                   help="extension: pipeline-parallel stages (not ported yet)")
    p.add_argument("--pp_microbatches", default=4, type=int,
                   help="extension: GPipe microbatches per micro-step under --pp_stages")
    p.add_argument("--tp_size", default=1, type=int,
                   help="extension: tensor-parallel size (not ported yet)")
    p.add_argument("--sp_shards", default=1, type=int,
                   help="extension: sequence-parallel shards over seq groups of that many processes "
                        "(world / sp_shards data rows)")
    p.add_argument("--profile_dir", default="", type=str,
                   help="extension: write a torch.profiler trace of steps 5-10 of the first epoch here")
    p.add_argument("--max_steps_per_epoch", default=0, type=int,
                   help="extension: cap steps/epoch (smoke runs)")
    p.add_argument("--smoke_tiny", action="store_true", default=False,
                   help="extension: 2-layer 64-dim model for smoke tests")
    p.add_argument("--device_normalize", action="store_true", default=False,
                   help="extension: ship uint8 clips, normalize on the device (requires reprob=0)")
    return p


def reject_unported(args) -> None:
    """Raise `NotImplementedError` for a flag whose path the port does not
    have yet, naming its `ROADMAP.md` item."""
    item17 = "ROADMAP.md queue 1, item 17 (parallel modes)"
    checks = (
        (getattr(args, "pp_stages", 1) > 1, f"--pp_stages: {item17}"),
        (getattr(args, "tp_size", 1) > 1, f"--tp_size: {item17}"),
        (getattr(args, "zero1", False), f"--zero1: {item17}"),
        (getattr(args, "fsdp", False), f"--fsdp: {item17}"),
    )
    for hit, what in checks:
        if hit:
            raise NotImplementedError(f"{what} is not ported yet")


def tiny_overrides(args) -> dict:
    """Model kwargs for --smoke_tiny (CI / CPU smoke runs)."""
    if not getattr(args, "smoke_tiny", False):
        return {}
    return {"depth": 2, "embed_dim": 64, "num_heads": 4}


# width and heads of the registry models unless --smoke_tiny overrides them
_WIDTH = {"embed_dim": 768, "num_heads": 12}


def use_attention_kernel(device: torch.device, embed_dim: int, num_heads: int) -> bool:
    """Whether a model of this width runs K1 (`fused_attention`): on `cuda`
    at the head dim the kernel takes (HEAD_DIM), and nowhere else. The
    kernel's wrapper refuses any other head dim on the card, so the choice
    is made here, once, as the reference CLI leaves `fused_attention` at
    its default."""
    return device.type == "cuda" and embed_dim // num_heads == HEAD_DIM


def attention_kernel_for(args, device: torch.device) -> bool:
    """`use_attention_kernel` at the width of the CLI's models (the
    registry's, or --smoke_tiny's); logs once on `cuda` when it declines."""
    tiny = tiny_overrides(args)
    width = {**_WIDTH, **{k: v for k, v in tiny.items() if k in _WIDTH}}
    fused = use_attention_kernel(device, **width)
    if device.type == "cuda" and not fused:
        print(f"K1 off: head dim {width['embed_dim'] // width['num_heads']}")
    return fused


def eval_fn(model, device: torch.device, select):
    """A deterministic forward of `model` in eval mode: select(outputs)."""

    def fn(videos):
        model.eval()
        with torch.inference_mode():
            return select(model(to_device(videos, device)))

    return fn


def resume(args, state, generator: torch.Generator) -> int:
    """The epoch to start from: after the checkpoint of --resume (an
    explicit checkpoint dir, which must hold one), else, with
    --auto_resume, after the newest one under --output_dir/ckpt, else
    --start_epoch. Restores `state` and `generator` in place."""
    if args.resume:
        restored, epoch = auto_resume(args.resume, state, generator)
        if restored is None:
            raise FileNotFoundError(f"--resume {args.resume}: no checkpoint found")
        print(f"resumed from {args.resume} epoch {epoch}")
        return epoch + 1
    if args.auto_resume and args.output_dir:
        restored, epoch = auto_resume(os.path.join(args.output_dir, "ckpt"), state, generator)
        if restored is not None:
            print(f"auto-resumed from epoch {epoch}")
            return epoch + 1
    return args.start_epoch


def world() -> tuple:
    """(rank, world size) of the initialised process group, or (0, 1)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def data_axis(args) -> tuple:
    """(data rank, data size) of this process: the data row it belongs to
    and the number of rows, `--sp_shards` ranks to a row. Each row reads
    its own shard of the training set; the seq ranks of a row read the
    same one."""
    rank, size = world()
    return rank // args.sp_shards, size // args.sp_shards


def run_train_loop(
    args,
    state,
    train_step: Callable,
    loader_train,
    steps_per_epoch: int,
    *,
    device: torch.device,
    generator: torch.Generator,
    validate=None,
    logger: Optional["JsonlLogger"] = None,
    start_epoch: int = 0,
    on_epoch_end=None,
    rank: int = 0,
    batch_keys=("videos", "labels"),
):
    """The one shared epoch loop (ref engine train_one_epoch + the
    per-script loop at run_slot_finetuning.py:648-713): batches copied to
    the card ahead of the step (`data/loader.py::device_prefetch`), the
    train step with `generator`, a device-side running sum of the metrics
    read once per PRINT_FREQ steps and once per epoch, JSONL and scalar
    logging, validation with best-checkpoint tracking, periodic checkpoints
    (with the generator's state), and an optional `torch.profiler` capture.
    `batch_keys` are the batch entries the step takes (the HVU step adds
    "scene_labels").

    validate(state) -> metric dict (runs before checkpoint decisions).
    on_epoch_end(state, epoch, record) -> optional extra record entries.
    Returns (state, best_acc, epochs): per epoch, {"epoch", "n_steps",
    "loop_s", "first_step_s"}: the loop's host seconds up to its
    synchronising read, and up to the read after the first step (the first
    batch's load included)."""
    logger = logger or JsonlLogger(args.output_dir, rank == 0)
    tb = TensorLogger(args.log_dir or (os.path.join(args.output_dir, "tb") if args.output_dir else None))
    best_acc = -1.0
    profile_dir = getattr(args, "profile_dir", "") or ""
    history = []

    for epoch in range(start_epoch, args.epochs):
        loader_train.set_epoch(epoch)
        meters = MetricLogger()
        t0 = time.time()
        t_loop = time.perf_counter()
        last_print = t0
        batches = (
            {k: batch[k] for k in batch_keys}
            for batch in itertools.islice(iter(loader_train), steps_per_epoch)
        )
        it = -1
        first_s = None
        msum, mcount = None, 0
        prof = None
        for it, dev_batch in enumerate(device_prefetch(batches, device, size=2)):
            if profile_dir and epoch == start_epoch and it == 5:
                prof = _start_profile(device)
            metrics = train_step(state, dev_batch, generator=generator)
            # device-side running sum: every step enters the epoch average
            # (ref MetricLogger updates each iteration, utils.py:39-50)
            # without a host sync in the loop
            msum = metrics if msum is None else {k: msum[k] + metrics[k] for k in msum}
            mcount += 1
            if prof is not None and it == 10:
                prof = _stop_profile(prof, profile_dir)
            if it % PRINT_FREQ == 0:
                # the periodic read is the only host sync in the loop
                m = {k: float(v) for k, v in metrics.items()}
                meters.update(**m)
                now = time.time()
                iter_t = (now - last_print) / (PRINT_FREQ if it else 1)
                last_print = now
                print(f"epoch {epoch} it {it}/{steps_per_epoch} iter_time {iter_t:.3f}s  {meters}")
                if not np.isfinite(m["loss"]):
                    raise RuntimeError(f"Loss is {m['loss']}, stopping training")
                if it == 0:  # the first batch's load and step, up to that read
                    first_s = time.perf_counter() - t_loop
        if prof is not None:  # a short epoch ended inside the capture window
            prof = _stop_profile(prof, profile_dir)
        epoch_avg = {k: float(v) / mcount for k, v in msum.items()} if msum is not None else {}
        loop_s = time.perf_counter() - t_loop
        history.append({"epoch": epoch, "n_steps": it + 1, "loop_s": loop_s, "first_step_s": first_s})
        meters.synchronize_between_processes()

        record = {"epoch": epoch, "train_time_s": round(time.time() - t0, 1), "n_steps": it + 1}
        record.update({f"train_{k}": round(v, 6) for k, v in epoch_avg.items()})
        if validate is not None and not args.disable_eval_during_finetuning:
            val = validate(state)
            record.update({f"val_{k}": round(float(v), 3) for k, v in val.items()})
            if val.get("acc1", -1) > best_acc:
                best_acc = val["acc1"]
                if args.output_dir and args.save_ckpt and rank == 0:
                    save_checkpoint(os.path.join(args.output_dir, "ckpt_best"), epoch, state, generator)
        if on_epoch_end is not None:
            extra = on_epoch_end(state, epoch, record)
            if extra:
                record.update(extra)
        if args.output_dir and args.save_ckpt and rank == 0 and (
            (epoch + 1) % args.save_ckpt_freq == 0 or epoch + 1 == args.epochs
        ):
            save_checkpoint(os.path.join(args.output_dir, "ckpt"), epoch, state, generator)
        logger.write(record)
        # scalars under the train, val and perf heads (ref utils/utils.py:167-188)
        tb.update(head="train", step=epoch, **{k[6:]: v for k, v in record.items() if k.startswith("train_")})
        tb.update(head="val", step=epoch, **{k[4:]: v for k, v in record.items() if k.startswith("val_")})
        tb.update(head="perf", step=epoch, train_time_s=record["train_time_s"])
        tb.flush()
        print(record)
    return state, best_acc, history


def _start_profile(device: torch.device):
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    prof = profile(activities=activities)
    prof.__enter__()
    return prof


def _stop_profile(prof, profile_dir: str):
    prof.__exit__(None, None, None)
    os.makedirs(profile_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))
    return None


def global_batch(args) -> int:
    """Samples per optimizer step over all processes: the per-row batch
    times the data rows (the seq ranks of a row share its batch)."""
    return args.batch_size * args.update_freq * data_axis(args)[1]


def scaled_lr(args) -> float:
    """LR linearly scaled by total batch / 256 (ref run_slot_finetuning.py:521-525)."""
    return args.lr * global_batch(args) / 256.0


def make_data_config(args, **overrides) -> DataConfig:
    kw = dict(
        data_set=args.data_set,
        data_path=args.data_path,
        data_prefix=args.data_prefix,
        anno_path=getattr(args, "anno_path", ""),
        num_frames=args.num_frames,
        sampling_rate=args.sampling_rate,
        input_size=args.input_size,
        short_side_size=args.short_side_size,
        test_num_segment=args.test_num_segment,
        test_num_crop=args.test_num_crop,
        aa=args.aa,
        train_interpolation=args.train_interpolation,
        reprob=args.reprob,
        num_sample=args.num_sample,
        nb_classes=args.nb_classes,
        synthetic=getattr(args, "synthetic_data", False),
        host_normalize=not getattr(args, "device_normalize", False),
    )
    kw.update(overrides)
    return DataConfig(**kw)


def hard_label_criterion(args):
    """The criterion on integer labels: the label-smoothing cross-entropy
    when --smoothing > 0, else the cross-entropy (ref
    run_class_finetuning.py, run_slot_downstream.py:127-131)."""
    from devias_tpu_torch.losses import cross_entropy, label_smoothing_cross_entropy

    if args.smoothing > 0:
        return lambda logits, labels: label_smoothing_cross_entropy(logits, labels, args.smoothing)
    return cross_entropy


def make_optim_config(args, total_steps: int, steps_per_epoch: int,
                      agg_block_scale: float = 1.0, num_layers: int = 12) -> OptimConfig:
    warmup = args.warmup_steps if args.warmup_steps > 0 else args.warmup_epochs * steps_per_epoch
    return OptimConfig(
        lr=scaled_lr(args),
        min_lr=args.min_lr,
        warmup_lr=args.warmup_lr,
        weight_decay=args.weight_decay,
        weight_decay_end=args.weight_decay_end,
        beta1=args.opt_betas[0] if args.opt_betas else 0.9,
        beta2=args.opt_betas[1] if args.opt_betas else 0.999,
        eps=args.opt_eps,
        layer_decay=args.layer_decay,
        agg_block_scale=agg_block_scale,
        num_layers=num_layers,
        total_steps=total_steps,
        warmup_steps=warmup,
        clip_grad=args.clip_grad,
        opt=args.opt,
        momentum=args.momentum,
    )


def make_train_loader(dataset, args) -> DataLoader:
    """This data row's padded shard of the shuffled training set."""
    shard, num_shards = data_axis(args)
    return DataLoader(
        dataset,
        batch_size=args.batch_size * args.update_freq,
        shuffle=True,
        drop_last=True,
        num_workers=args.num_workers,
        seed=args.seed,
        shard=shard,
        num_shards=num_shards,
    )


def make_eval_loader(dataset, args, batch_size: Optional[int] = None, all_hosts: bool = False) -> DataLoader:
    """Evaluation loader. Default: shard across processes only under
    --dist_eval, unpadded (per-rank result files record exactly their
    shard; merge dedups). all_hosts=True shards across processes
    unconditionally with padded (equal-length) shards, as the k-NN banks
    need (the reference's DistributedSampler pads the same way, ref
    run_knn.py:28-42)."""
    rank, size = world()
    multi = all_hosts and size > 1
    sharded = multi or args.dist_eval
    return DataLoader(dataset, batch_size=batch_size or args.batch_size, shuffle=False, drop_last=False,
                      num_workers=args.num_workers, shard=rank if sharded else 0,
                      num_shards=size if sharded else 1, pad_shards=multi)


class JsonlLogger:
    """Epoch log.txt writer (ref run_slot_finetuning.py:709-713)."""

    def __init__(self, output_dir: str, enabled: bool = True):
        self.path = os.path.join(output_dir, "log.txt") if output_dir else None
        self.enabled = enabled and bool(output_dir)
        if self.enabled:
            os.makedirs(output_dir, exist_ok=True)

    def write(self, record: dict):
        if self.enabled:
            with open(self.path, "a") as f:
                f.write(json.dumps(record) + "\n")


def test_and_merge(args, cfg: DataConfig, logits_fn, device: torch.device, rank: int, ntasks: int,
                   name: str = "test", scene_label_fn=None, label: str = "Final"):
    """`final_test` over `cfg`'s test split into --output_dir/`name`
    (targets from `scene_label_fn` when given), then on rank 0 the merge
    over `ntasks` result files, printed: (top1, top5), or None on the
    other ranks."""
    from devias_tpu_torch.data import build_dataset
    from devias_tpu_torch.eval import final_test, merge_results

    path = os.path.join(args.output_dir or ".", name)
    ds_test, _ = build_dataset(False, True, cfg)
    loader = make_eval_loader(ds_test, args)
    try:
        final_test(loader, logits_fn, args.batch_size, path, rank=rank, scene_label_fn=scene_label_fn, device=device)
    finally:
        loader.close()
    if rank != 0:
        return None
    top1, top5 = merge_results(path, ntasks)
    print(f"{label} top-1 {top1:.2f} top-5 {top5:.2f}")
    return top1, top5


def finetune_surgery(args, model_kind: str, model, num_classes_total: int, agg_unique_layers: int = 1):
    """--finetune checkpoint load with the reference's surgery (ref
    run_slot_finetuning.py:438-499) into `model` (of any kind of
    `ckpt/torch_import.py::MODEL_KINDS`) in place. Returns the load
    report, or None without --finetune."""
    if not args.finetune:
        return None
    agg = getattr(model, "agg_block", None)
    _, report = load_reference_checkpoint(
        model, args.finetune, model_kind, args.model_key, args.model_prefix,
        agg_depth=agg.depth if agg is not None else 0, agg_unique_layers=agg_unique_layers,
        expected_head_out=num_classes_total,
        # target geometry of the pos-embed interpolation (ref :471-497)
        dst_spatial=args.input_size // 16, frames_tokens=args.num_frames // 2,
    )
    print(f"finetune load: {len(report['loaded'])} tensors; {len(report['unused_in_ckpt'])} ckpt keys unused")
    return report


def run_knn_protocol(args, feature_fn, teacher_logits_fn, rank: int) -> dict:
    """The k-NN disentanglement probe (ref utils/eval/run_knn.py:166-273):
    for HMDB51 / UCF101 / Diving-48, extract (action, scene) features on
    train+test splits, dump the banks, and run the 4-way feature/label
    cross matrix at k in --nb_knn, T=--temperature. A dataset whose
    filelists are missing is skipped, as in the JAX package.

    feature_fn(videos) -> (action_feat, scene_feat)."""
    from devias_tpu_torch.data import knn_build_dataset
    from devias_tpu_torch.data.loader import shard_indices
    from devias_tpu_torch.eval.knn import (
        extract_slot_features,
        gather_features_across_hosts,
        run_knn_matrix,
        save_knn_features,
    )

    results = {}
    for data_set in ("HMDB51", "UCF101", "Diving-48"):
        try:
            cfg = make_data_config(args, data_set=data_set)
            # BOTH splits use deterministic validation transforms
            # (ref dataset/datasets.py:474,504 mode='validation')
            tr, _ = knn_build_dataset(True, cfg)
            te, _ = knn_build_dataset(False, cfg)
        except (FileNotFoundError, ValueError):
            continue
        banks = []
        for ds in (tr, te):
            # padded shards over all processes, scattered back into dataset
            # order, where the padding's duplicate rows collapse as the
            # reference's index_copy_ bank does (ref run_knn.py:72-119)
            loader = make_eval_loader(ds, args, all_hosts=True)
            try:
                feats = extract_slot_features(loader, feature_fn, args.batch_size, scene_label_fn=teacher_logits_fn)
            finally:
                loader.close()
            banks.append(gather_features_across_hosts(
                *feats, n_total=len(ds),
                local_indices=shard_indices(len(ds), loader.shard, loader.num_shards, False, 0, 0, True)))
        (tra, trs, tral, trsl), (tea, tes, teal, tesl) = banks
        if rank == 0 and args.output_dir:
            # feature dump (ref run_knn.py:230-237 file naming)
            save_knn_features(args.output_dir, data_set, {
                "train_action_features": tra, "train_scene_features": trs,
                "test_action_features": tea, "test_scene_features": tes,
                "train_action_labels": tral, "test_action_labels": teal,
                "train_scene_labels": trsl, "test_scene_labels": tesl,
            })
        results[data_set] = run_knn_matrix(
            tra, trs, tral, trsl, tea, tes, teal, tesl,
            nb_knn=args.nb_knn, temperature=args.temperature,
            num_action_classes=max(int(tral.max()) + 1, 1),
            num_scene_classes=365,
        )
    return results


def make_scuba_loader(args, variant: str):
    """SCUBA test loader for one background variant, forced 2x3 views
    (ref utils/eval/run_scuba.py:10-19: the harness rewrites data_path to
    filelist/scuba/<k400|ucf101> and pins test_num_segment/crop)."""
    from devias_tpu_torch.data import build_dataset

    ds_key = {"Kinetics-400": "k400", "UCF101": "ucf101"}.get(args.data_set, "ucf101")
    cfg = make_data_config(
        args, data_set="SCUBA",
        anno_path=os.path.join("filelist/scuba", ds_key, f"{variant}.csv"),
        test_num_segment=2, test_num_crop=3,
    )
    ds, _ = build_dataset(False, True, cfg)
    return make_eval_loader(ds, args)


def make_hat_loader_factory(args):
    """-> (make_loader(version, split) -> test DataLoader, versions tuple),
    the reference harness's path conventions (ref
    utils/eval/hat_eval.py:8-34):
    - the HAT flavour comes from --hat_anno_path ('kinetics' in the path:
      Kinetics-HAT, 'ucf101': UCF101-HAT), else from --data_set;
    - when the path's last component is a version dir (far, rand or
      close), only that version's three splits run;
    - otherwise all three versions run, each split read from
      <anno>/<ver>/actionswap_<ver>_<split>.pickle, or from a flat
      <anno>/actionswap_<ver>_<split>.pickle."""
    from devias_tpu_torch.data import build_dataset

    anno = args.hat_anno_path.rstrip("/")
    low = anno.lower()
    if "kinetics" in low:
        data_set = "Kinetics-HAT"
    elif "ucf101" in low:
        data_set = "UCF101-HAT"
    elif args.data_set.endswith("-HAT"):
        data_set = args.data_set
    else:
        data_set = {"Kinetics-400": "Kinetics-HAT"}.get(args.data_set, "UCF101-HAT")

    base = os.path.basename(anno)
    versioned = base in ("far", "rand", "close")
    versions = (base,) if versioned else ("far", "rand", "close")

    def make_hat_loader(ver, split):
        candidates = [os.path.join(anno, f"actionswap_{ver}_{split}.pickle")]
        if not versioned:
            candidates.insert(0, os.path.join(anno, ver, f"actionswap_{ver}_{split}.pickle"))
        path = next((c for c in candidates if os.path.exists(c)), candidates[0])
        cfg = make_data_config(args, data_set=data_set, anno_path=path, test_num_segment=2, test_num_crop=3)
        ds, _ = build_dataset(False, True, cfg)
        return make_eval_loader(ds, args)

    return make_hat_loader, versions
