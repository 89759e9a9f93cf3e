"""At-scale training-health probe with a slot-disentanglement assert (port
of `scripts/health_run.py`).

2000 AdamW steps of the flagship geometry (ViT-B slot student, 8 tied agg
rounds, K1, bf16, FusedAdamW) at the published recipe's stochastic
configuration: FAME-HVU with beta 0.5 and prob_aug 0.8 (the donor's scene
label swapped in), a cosine LR schedule with warm-up, EMA 0.999. The clips
are synthetic: the moving block's trajectory sets the action (motion)
label and the background grating sets the scene label, drawn
independently. It probes the composed system (FAME + Hungarian matching +
schedules + bf16 + kernels + EMA) staying healthy for thousands of steps:
loss-scale drift, slot-role collapse, EMA interactions. After training,
the action slot must read the motion and the scene slot the background,
each at 0.85 or more of the training pool; the cross readings (action slot
-> scene label and the reverse), the EMA's readings and held-out clips of
the same combinations are printed for the record.

It uses the HVU step (real scene labels, no teacher), since synthetic
backgrounds give exact scene labels. All 60 clips stay on the card (one
upload); each step draws its 12 clips on the card, so the host sends
nothing per step. The draws (clip indices, FAME, the model's) come from one
`torch.Generator` seeded 0: JAX's PRNG cannot be reproduced, so the
clips each step sees differ from the JAX script's. The run is judged by
its asserts, not step by step.

    python -m devias_tpu_torch.scripts.health_run [--steps 2000] [--per_combo 5] [--device cpu]

(--steps 2000 is the asserted tier; --steps 60 is a wiring smoke.)
`run_health` takes the model's widths and the clip geometry as keyword
arguments, so the tests run it tiny on the CPU; `main` asserts.
"""

from __future__ import annotations

import argparse
import copy
import time
from typing import Optional

import numpy as np
import torch
from torch import nn

from devias_tpu_torch.aug import FAMEConfig
from devias_tpu_torch.device import DeviceLike, resolve_device
from devias_tpu_torch.losses import SlotLossConfig
from devias_tpu_torch.nn import create_model
from devias_tpu_torch.train import (
    OptimConfig, TrainState, TrainStepConfig, make_eval_step, make_hvu_train_step, make_optimizer,
)

N_MOTION, N_SCENE = 4, 3
B = 12
RES, T = 224, 16


def make_clip(rng, motion: int, scene: int, res: int = RES, frames: int = T) -> np.ndarray:
    """One clip: scene = oriented grating background (texture only, no
    motion information), motion = the moving block's trajectory CLASS —
    {static, slow horizontal, fast horizontal, vertical}, with the
    direction sign randomized per instance so the class is encoded by
    speed/axis (temporal variance), not frame order. The block's
    appearance is identical across classes. The JAX script's function bit
    for bit (its numpy promotions included)."""
    yy, xx = np.mgrid[0:res, 0:res].astype(np.float32)
    theta = [0.0, np.pi / 3, 2 * np.pi / 3][scene]
    freq = [12.0, 20.0, 31.0][scene]
    phase = rng.uniform(0, 2 * np.pi)
    bg = 0.7 * np.sin(
        2 * np.pi * freq * (xx * np.cos(theta) + yy * np.sin(theta)) / res + phase
    )
    clip = np.empty((frames, res, res, 3), np.float32)
    x0, y0 = rng.integers(20, res - 60, size=2)
    sign = int(rng.integers(0, 2)) * 2 - 1
    vel = [(0, 0), (4 * sign, 0), (14 * sign, 0), (0, 9 * sign)][motion]
    for t in range(frames):
        f = np.repeat(bg[:, :, None], 3, axis=2).copy()
        f += rng.normal(scale=0.05, size=f.shape).astype(np.float32)
        cx = (x0 + vel[0] * t) % (res - 40)
        cy = (y0 + vel[1] * t) % (res - 40)
        f[cy : cy + 40, cx : cx + 40] = 1.8
        clip[t] = f
    return clip


def make_pool(rng, n_per_combo: int, res: int = RES, frames: int = T):
    """`n_per_combo` clips of each (motion, scene) combination: (videos,
    motion labels, scene labels)."""
    vids, am, sc = [], [], []
    for m in range(N_MOTION):
        for s in range(N_SCENE):
            for _ in range(n_per_combo):
                vids.append(make_clip(rng, m, s, res, frames))
                am.append(m)
                sc.append(s)
    return (
        np.stack(vids),
        np.asarray(am, np.int64),
        np.asarray(sc, np.int64),
    )


def slot_accuracies(model: nn.Module, videos, action: np.ndarray, scene: np.ndarray, num_motion: int,
                    batch: int = B) -> dict:
    """The disentanglement probe: `make_eval_step` over `videos` (a tensor
    on the model's device or a numpy array) in batches of `batch`; the
    action slot's logits over the first `num_motion` classes against the
    motion labels, the scene slot's over the rest against the scene labels,
    and the two cross readings (each slot probed for the other factor).
    Returns the four shares of the clips."""
    probe = make_eval_step(model, device=next(model.parameters()).device)
    n = len(action)
    a_hit = s_hit = a_x = s_x = 0
    for i in range(0, n, batch):
        out = probe(videos[i : i + batch])
        a_log, s_log = (out[k].float().cpu().numpy() for k in ("action_logit", "scene_logit"))
        al, sl = action[i : i + batch], scene[i : i + batch]
        a_hit += int((a_log[:, :num_motion].argmax(-1) == al).sum())
        s_hit += int((s_log[:, num_motion:].argmax(-1) == sl).sum())
        a_x += int((a_log[:, num_motion:].argmax(-1) == sl).sum())
        s_x += int((s_log[:, :num_motion].argmax(-1) == al).sum())
    return {"action_slot_motion": a_hit / n, "scene_slot_scene": s_hit / n,
            "action_slot_scene": a_x / n, "scene_slot_motion": s_x / n}


def ema_model(state: TrainState) -> nn.Module:
    """A copy of the state's model carrying its EMA parameters. The EMA
    holds named parameters only; the buffers are the model's."""
    model = copy.deepcopy(state.model)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(state.ema_params[name])
    return model


def _print_accs(tag: str, accs: dict) -> None:
    print(f"{tag}: action-slot/motion {accs['action_slot_motion']:.3f}  "
          f"scene-slot/scene {accs['scene_slot_scene']:.3f}  "
          f"[cross: action-slot/scene {accs['action_slot_scene']:.3f}, "
          f"scene-slot/motion {accs['scene_slot_motion']:.3f}]", flush=True)


def health_model(device: DeviceLike = None, res: int = RES, widths: Optional[dict] = None) -> nn.Module:
    """The student of the JAX script (`:108-111`) with its initial weights
    (seed 0): the slot ViT-B with 2 latents and 8 tied agg rounds, bf16,
    K1."""
    return create_model("slot_vit_base_patch16_224", device=device, seed=0, num_classes=N_MOTION,
                        num_scene_classes=N_SCENE, num_latents=2, agg_depth=8, agg_weights_tie=True,
                        dtype=torch.bfloat16, fused_attention=True, img_size=res, **dict(widths or {}))


def run_health(steps: int = 2000, per_combo: int = 5, res: int = RES, frames: int = T,
               device: DeviceLike = None, widths: Optional[dict] = None) -> dict:
    """Train `steps` HVU steps on a pool of `per_combo` clips per
    combination, then probe the parameters and the EMA on the pool and the
    parameters on 12 held-out clips (`default_rng(1234)`). `widths`
    (depth, embed_dim, num_heads) shrink the model for a test. Returns
    {"history": [(step, metrics)], "steps_per_s", "train", "ema",
    "held_out", "state"}."""
    dev = resolve_device(device)
    model = health_model(dev, res, widths)
    opt, lr_fn = make_optimizer(model, OptimConfig(
        lr=3e-4, min_lr=1e-6, warmup_lr=1e-7,
        warmup_steps=max(steps // 20, 10), total_steps=steps,
        layer_decay=0.75, agg_block_scale=0.1,  # published recipe scales
        num_layers=len(model.blocks),
    ), device=dev)
    state = TrainState.create(model, opt, use_ema=True, ema_decay=0.999, device=dev)
    step = make_hvu_train_step(
        model, opt,
        SlotLossConfig(num_action_classes=N_MOTION, num_scene_classes=N_SCENE),
        TrainStepConfig(use_fame=True, fame=FAMEConfig(beta=0.5, prob_aug=0.8)),
        lr_fn, device=dev,
    )

    rng = np.random.default_rng(0)
    print("generating pool...", flush=True)
    vids, am, sc = make_pool(rng, per_combo, res, frames)
    N = vids.shape[0]
    d_vids = torch.from_numpy(vids).to(dev)
    d_am, d_sc = torch.from_numpy(am).to(dev), torch.from_numpy(sc).to(dev)
    gen = torch.Generator(device=dev).manual_seed(0)

    t0 = time.time()
    hist = []
    for s in range(steps):
        idx = torch.randperm(N, generator=gen, device=dev)[:B]
        data = {"videos": d_vids.index_select(0, idx), "labels": d_am.index_select(0, idx),
                "scene_labels": d_sc.index_select(0, idx)}
        logged = s % 100 == 0 or s == steps - 1
        m = step(state, data, generator=gen, host_metrics=logged)
        if s == 0:
            hist.append((0, m))  # true initial loss for the trend assert
            t0 = time.time()
            print(f"step 0 loss {m['loss']:.3f}; timing from step 1", flush=True)
        if (s % 100 == 0 and s) or s == steps - 1:
            hist.append((s, m))
            print(
                f"step {s:5d} loss {m['loss']:8.3f} acc {m['class_acc']:.3f} "
                f"action {m['action_loss']:.3f} scene {m['scene_loss']:.3f} "
                f"cos {m['cosine_loss']:.4f} gnorm {m['grad_norm']:.2f} "
                f"lr {m.get('lr', 0):.2e} (+{time.time() - t0:.0f}s)",
                flush=True,
            )
            assert np.isfinite(m["loss"]), f"loss diverged at step {s}: {m}"
    wall = time.time() - t0
    steps_per_s = (steps - 1) / wall if steps > 1 else None
    print(f"train wall {wall:.0f}s after step 0 ({(steps - 1) / wall:.2f} steps/s)", flush=True)

    # ---- disentanglement probe: action slot -> motion, scene slot -> bg
    train = slot_accuracies(model, d_vids, am, sc, N_MOTION)
    _print_accs("train pool", train)
    ema = slot_accuracies(ema_model(state), d_vids, am, sc, N_MOTION)
    _print_accs("train pool (EMA)", ema)
    # held-out instances of the SAME combos (fresh rng): generalization,
    # printed for the record (the hard assert is the train-pool tier)
    ho_v, ho_a, ho_s = make_pool(np.random.default_rng(1234), 1, res, frames)
    held_out = slot_accuracies(model, ho_v, ho_a, ho_s, N_MOTION, len(ho_a))
    print(f"held-out instances: action {held_out['action_slot_motion']:.3f} "
          f"scene {held_out['scene_slot_scene']:.3f}", flush=True)
    return {"history": hist, "steps_per_s": steps_per_s, "train": train, "ema": ema, "held_out": held_out,
            "state": state}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="2000 HVU steps on synthetic clips, then the disentanglement probe")
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--per_combo", type=int, default=5)  # 12 combos x 5 = 60 clips
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    result = run_health(args.steps, args.per_combo, device=args.device)
    hist, state = result["history"], result["state"]
    a_acc, s_acc = result["train"]["action_slot_motion"], result["train"]["scene_slot_scene"]

    losses = [m["loss"] for _, m in hist]
    if len(losses) >= 2:
        assert losses[-1] < losses[0] * 0.5, (losses[0], losses[-1])
    if args.steps >= 1000:
        assert a_acc >= 0.85, f"action slot failed to learn motion: {a_acc}"
        assert s_acc >= 0.85, f"scene slot failed to learn background: {s_acc}"
        ema_finite = all(bool(torch.isfinite(p).all()) for p in state.ema_params.values())
        assert ema_finite
    print("HEALTH RUN OK")
    return result


if __name__ == "__main__":
    main()
