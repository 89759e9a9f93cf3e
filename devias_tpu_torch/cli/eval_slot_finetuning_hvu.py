"""HVU seen/unseen evaluation of the port (port of
`devias_tpu/cli/eval_slot_finetuning_hvu.py`, ref eval_slot_finetuning_hvu.py
and engine_for_slot_hvu.py:203-280): four metric blocks, action and scene
on the SEEN and the UNSEEN filelist, each with top-1 and top-5 ranked over
the full unified head; one pass over each filelist gives both of its
blocks.

    python -m devias_tpu_torch.cli.eval_slot_finetuning_hvu \\
        --anno_path SEEN.csv UNSEEN.csv --finetune CKPT [flags]

`main` prints the four blocks and returns them.
"""

from __future__ import annotations

import argparse

import numpy as np

from devias_tpu_torch.cli.common import build_shared_parser, make_data_config, make_eval_loader, reject_unported
from devias_tpu_torch.cli.run_slot_finetuning_hvu import both_logits_fn, build_hvu_model, load_hvu_weights
from devias_tpu_torch.core.dist import maybe_init_distributed
from devias_tpu_torch.data import build_dataset
from devias_tpu_torch.device import resolve_device
from devias_tpu_torch.eval.merge import accuracy_topk
from devias_tpu_torch.eval.protocols import _pad_batch, _pipelined


def get_args(argv=None):
    parser = argparse.ArgumentParser("HVU seen/unseen evaluation (PyTorch)", parents=[build_shared_parser("hvu-eval")],
                                     conflict_handler="resolve")
    # the SEEN and UNSEEN filelists as two tokens (--anno_path SEEN UNSEEN,
    # nargs='+', ref eval_slot_finetuning_hvu.py:40-41, docs/EVAL.md:82)
    parser.add_argument("--anno_path", default=[], nargs="+", type=str)
    parser.add_argument("--agg_weights_tie", default=False, action="store_true")
    parser.add_argument("--agg_depth", default=4, type=int)
    parser.add_argument("--num_latents", type=int, default=4)
    parser.add_argument("--head_type", type=str, default="linear")
    parser.add_argument("--slot_matching_method", type=str, default="matching")
    # accepted for command compatibility: training flags the reference
    # eval parser inherits (eval_slot_finetuning_hvu.py:44-62,170) and never
    # reads at eval time
    parser.add_argument("--nb_knn", default=[10, 20], nargs="+", type=int)
    parser.add_argument("--agg_block_scale", type=float, default=0.8)
    parser.add_argument("--mask_model", default="", choices=["FAME", ""], type=str)
    parser.add_argument("--beta", type=float, default=0.5)
    parser.add_argument("--prob_aug", type=float, default=0.5)
    parser.add_argument("--mask_distill_loss_weight", type=float, default=1.0)
    parser.add_argument("--mask_prediction_loss_weight", type=float, default=3.0)
    parser.add_argument("--eval_data_path", default=None, type=str)
    parser.set_defaults(model="slot_vit_base_patch16_224", data_set="HVU-EVAL")
    return parser.parse_args(argv)


def validation_blocks(loader, forward_fn, batch_size: int, num_action: int) -> dict:
    """The action and the scene block of one filelist, from one pass over
    it: {"action": the full-width action logits against the action
    labels, "scene": the full-width scene logits against the scene labels
    shifted by `num_action`}, each {"acc1", "acc5"} ranked over the whole
    unified head. The JAX CLI passes over the filelist once per block
    (`validation_block`); the forward is deterministic, so the numbers are
    the same."""
    action, scene, action_labels, scene_labels = [], [], [], []

    def dispatch(batch):
        videos, n = _pad_batch(batch["videos"], batch_size)
        return forward_fn(videos), (batch, n)

    for (action_logit, scene_logit), (batch, n) in _pipelined(loader, dispatch):
        action.append(action_logit[:n])
        scene.append(scene_logit[:n])
        action_labels.append(np.asarray(batch["labels"])[:n])
        scene_labels.append(np.asarray(batch["scene_labels"])[:n] + num_action)
    out = {}
    for which, logits, labels in (("action", action, action_labels), ("scene", scene, scene_labels)):
        t1, t5 = accuracy_topk(np.concatenate(logits), np.concatenate(labels))
        out[which] = {"acc1": t1, "acc5": t5}
    return out


def main(args=None) -> dict:
    args = args or get_args()
    # the SEEN/UNSEEN pair in the factory's space-joined form (a single
    # quoted "SEEN UNSEEN" token works too)
    if isinstance(args.anno_path, (list, tuple)):
        args.anno_path = " ".join(args.anno_path)
    reject_unported(args)
    dev = resolve_device(args.device)
    maybe_init_distributed(dev)
    model = build_hvu_model(args, dev)
    load_hvu_weights(args, model)
    forward_fn = both_logits_fn(model, dev)

    datasets, (num_action, _) = build_dataset(False, False, make_data_config(args))
    seen_ds, unseen_ds = datasets
    results = {}
    for name, ds in (("seen", seen_ds), ("unseen", unseen_ds)):
        loader = make_eval_loader(ds, args)
        try:
            blocks = validation_blocks(loader, forward_fn, args.batch_size, num_action)
        finally:
            loader.close()
        results.update({f"{which}_{name}": blocks[which] for which in ("action", "scene")})
    for k, v in results.items():  # the four metric blocks (ref :337-340)
        print(f"{k}: top-1 {v['acc1']:.2f} top-5 {v['acc5']:.2f}")
    return results


if __name__ == "__main__":
    main()
