"""Full-scale training health probe on the card (port of
`scripts/full_scale_overfit.py`).

200 AdamW steps of the flagship configuration (ViT-B/16 slot student,
frozen ViT-B teacher with the CLS token, Hungarian matching loss, bf16, K1
in every block of both, FusedAdamW with layer decay) memorising 12 fixed
structured clips. It catches integration faults across the whole step
that unit and parity tests cannot: optimizer x kernel x precision
interactions over many steps. The asserts are the JAX script's: the loss
ends below 0.7 of its first value, train accuracy at 0.9 or more.

    python -m devias_tpu_torch.scripts.full_scale_overfit [--device cpu]

`train_overfit` takes the model's widths and the clip geometry as keyword
arguments, so the tests run it tiny on the CPU; `main` runs the full size
and asserts.
"""

from __future__ import annotations

import argparse
import time
from typing import Optional

import numpy as np
import torch

from devias_tpu_torch.device import DeviceLike, resolve_device
from devias_tpu_torch.losses import SlotLossConfig
from devias_tpu_torch.nn import create_model
from devias_tpu_torch.train import OptimConfig, TrainState, TrainStepConfig, make_optimizer, make_slot_train_step

B = 12
STEPS = 200
LOG_EVERY = 20
RES, T = 224, 16


def overfit_clips(batch: int, frames: int = T, res: int = RES):
    """The 12 structured clips of the JAX script (`:40-50`), bit for bit: a
    noise background per clip and a class-specific block moving across it.
    Returns (videos [batch, frames, res, res, 3] float32, labels
    arange(batch) % 10)."""
    rng = np.random.default_rng(0)
    vids = np.zeros((batch, frames, res, res, 3), np.float32)
    for i in range(batch):
        base = rng.normal(size=(res, res, 3)) * 0.3
        for t in range(frames):
            f = base.copy()
            x0 = (t * 9 + i * 17) % 180
            f[60:120, x0:x0+40] = 2.0 - 0.3 * i  # class-specific moving block
            vids[i, t] = f
    return vids, np.arange(batch) % 10


def train_overfit(steps: int = STEPS, frames: int = T, res: int = RES, device: DeviceLike = None,
                  widths: Optional[dict] = None) -> dict:
    """Train the flagship slot step on `overfit_clips(B)` for `steps`
    steps, the step's generator re-seeded to 0 before each (the JAX script
    passes PRNGKey(0) at every step). `widths` (depth, embed_dim,
    num_heads) shrink both models for a test. Metrics come to the host only
    at steps 0, 20, ..., and the last; the accuracy of every step stays on
    the device until the end. Returns {"history": [(step, metrics)],
    "acc_per_step", "first_full_acc_step", "wall_s", "ms_per_step"} (ms
    per step from step 1 on)."""
    dev = resolve_device(device)
    widths = dict(widths or {})
    model = create_model("slot_vit_base_patch16_224", device=dev, seed=0, num_classes=10, num_scene_classes=365,
                         num_latents=2, agg_depth=8, agg_weights_tie=True, dtype=torch.bfloat16,
                         fused_attention=True, img_size=res, **widths)
    teacher = create_model("vit_base_patch16_224", device=dev, seed=1, num_classes=365, use_mean_pooling=False,
                           dtype=torch.bfloat16, fused_attention=True, **widths)
    opt, lr_fn = make_optimizer(model, OptimConfig(lr=3e-4, layer_decay=0.75, agg_block_scale=0.1, total_steps=220,
                                                   warmup_steps=20, num_layers=len(model.blocks)), device=dev)
    state = TrainState.create(model, opt, device=dev)
    step = make_slot_train_step(model, teacher, opt, SlotLossConfig(num_action_classes=10, num_scene_classes=365),
                                TrainStepConfig(use_fame=False), lr_fn, device=dev)
    vids, labels = overfit_clips(B, frames, res)
    data = {"videos": torch.from_numpy(vids).to(dev), "labels": torch.from_numpy(labels).to(dev)}
    gen = torch.Generator(device=dev)

    t0 = time.time()
    hist, accs = [], []
    for s in range(steps):
        logged = s % LOG_EVERY == 0 or s == steps - 1
        m = step(state, data, generator=gen.manual_seed(0), host_metrics=logged)
        accs.append(m["class_acc"])
        if logged:
            hist.append((s, m))
            print(f"step {s:3d} loss {m['loss']:8.3f} acc {m['class_acc']:.3f} "
                  f"action {m['action_loss']:.3f} scene {m['scene_loss']:.3f} "
                  f"gnorm {m['grad_norm']:.2f}", flush=True)
        if s == 0:
            t1 = time.time()
    end = time.time()
    accs = [float(a) for a in accs]
    full = [s for s, a in enumerate(accs) if a == 1.0]
    return {"history": hist, "acc_per_step": accs, "first_full_acc_step": full[0] if full else None,
            "wall_s": end - t0, "ms_per_step": (end - t1) / (steps - 1) * 1e3 if steps > 1 else None}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="200 steps of the flagship slot step memorising 12 fixed clips")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    result = train_overfit(device=args.device)
    hist = [(s, m["loss"], m["class_acc"]) for s, m in result["history"]]
    print(f"wall {result['wall_s']:.0f}s")
    assert np.isfinite(hist[-1][1])
    assert hist[-1][1] < hist[0][1] * 0.7, (hist[0], hist[-1])
    assert hist[-1][2] >= 0.9, hist[-1]
    print("FULL-SCALE OVERFIT OK")
    return result


if __name__ == "__main__":
    main()
