"""Checkpoint conversion between reference PyTorch `.pth` files and port
checkpoints (port of `devias_tpu/cli/convert_checkpoint.py`, whose
orbax side the port replaces with its own torch checkpoints).

    # reference -> port (a VideoMAE/DEVIAS checkpoint, also DeepSpeed's
    # {'module': ...} layout), written as OUTPUT/checkpoint-0.pth
    python -m devias_tpu_torch.cli.convert_checkpoint to_port \\
        --input devias_k400.pth --output /ckpts/devias_k400 \\
        --model_kind slot --nb_classes 400 --num_latents 2 --agg_depth 8 --agg_weights_tie

    # port -> reference ({'model': state_dict, 'epoch': e}, for the
    # reference's evaluators); --input is a checkpoint file or a directory
    # of them (the newest epoch)
    python -m devias_tpu_torch.cli.convert_checkpoint to_reference \\
        --input /out/ckpt --output exported.pth --model_kind slot ...

`to_port` reads the reference checkpoint through `ckpt/torch_import.py`
(container unwrap, prefix strip, a tied agg block's one layer to every
round index), merges it into a template model built from the flags (what
the checkpoint lacks keeps the template's seeded values), prints the
loaded / unused report and writes a weights-only port checkpoint, which
the port's CLIs load with `--finetune`. `to_reference` loads a port
checkpoint into the template with `strict=True` and writes its
reference-layout state dict (`ckpt/torch_export.py`). Both run on the CPU.
"""

from __future__ import annotations

import argparse
import os

import torch

_KIND_TO_NAME = {
    "slot": "slot_vit_base_patch16_224",
    "plain": "vit_base_patch16_224",
    "multi_task": "disentangle_vit_base_patch16_224",
    "slot_fusion": "slot_fusion_vit_base_patch16_224",
}


def get_args(argv=None):
    p = argparse.ArgumentParser("checkpoint conversion (PyTorch)")
    p.add_argument("direction", choices=["to_port", "to_reference"])
    p.add_argument("--input", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--model_kind", default="slot", choices=list(_KIND_TO_NAME))
    p.add_argument("--nb_classes", type=int, default=400)
    p.add_argument("--num_scene_classes", type=int, default=365)
    p.add_argument("--num_latents", type=int, default=2)
    p.add_argument("--agg_depth", type=int, default=8)
    p.add_argument("--agg_weights_tie", action="store_true", default=False)
    p.add_argument("--depth", type=int, default=12)
    p.add_argument("--embed_dim", type=int, default=768)
    p.add_argument("--num_heads", type=int, default=12)
    p.add_argument("--num_frames", type=int, default=16)
    p.add_argument("--input_size", type=int, default=224)
    return p.parse_args(argv)


def build_template(args) -> torch.nn.Module:
    """The model the flags describe, on the CPU, in float32, seed 0."""
    from devias_tpu_torch.nn import create_model

    kw = dict(num_classes=args.nb_classes, depth=args.depth, embed_dim=args.embed_dim, num_heads=args.num_heads)
    if args.model_kind != "plain":
        kw["num_scene_classes"] = args.num_scene_classes
    if args.model_kind in ("slot", "slot_fusion"):
        kw.update(num_latents=args.num_latents, agg_depth=args.agg_depth, agg_weights_tie=args.agg_weights_tie)
    if args.model_kind == "slot":
        kw["img_size"] = args.input_size
    if args.model_kind == "multi_task":
        kw.update(img_size=args.input_size, num_frames=args.num_frames)
    return create_model(_KIND_TO_NAME[args.model_kind], device="cpu", **kw)


def _port_checkpoint(path: str) -> str:
    """`path`, or the newest checkpoint-N.pth under the directory `path`."""
    from devias_tpu_torch.ckpt.io import checkpoint_path, latest_checkpoint_step

    if not os.path.isdir(path):
        return path
    epoch = latest_checkpoint_step(path)
    if epoch is None:
        raise FileNotFoundError(f"no checkpoint under {path}")
    return checkpoint_path(path, epoch)


def main(argv=None) -> dict:
    """Returns {"path": what it wrote} and, for `to_port`, the report."""
    args = get_args(argv)
    model = build_template(args)
    if args.direction == "to_port":
        from devias_tpu_torch.ckpt import (import_torch_state_dict, load_torch_checkpoint_file, merge_params,
                                           save_weights)

        sd = load_torch_checkpoint_file(args.input)
        imported = import_torch_state_dict(sd, args.model_kind, agg_depth=args.agg_depth,
                                           agg_unique_layers=1 if args.agg_weights_tie else args.agg_depth)
        report = merge_params(model, imported)
        print(f"loaded {len(report['loaded'])} tensors; {len(report['unused_in_ckpt'])} ckpt keys unused")
        path = save_weights(args.output, 0, model.state_dict())
        print(f"wrote port checkpoint {path}")
        return {"path": path, "report": report}
    from devias_tpu_torch.ckpt import save_reference_checkpoint

    src = _port_checkpoint(args.input)
    obj = torch.load(src, map_location="cpu", weights_only=True)
    model.load_state_dict(obj["model"], strict=True)
    save_reference_checkpoint(args.output, model, args.model_kind, epoch=obj.get("epoch", 0))
    print(f"wrote reference checkpoint {args.output} from {src}")
    return {"path": args.output}


if __name__ == "__main__":
    main()
