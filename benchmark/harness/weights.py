"""Seeded weights and inputs, made on the device in a few large draws.

Weights are a function of the seed and of the parameters' names and
shapes only, so the program and the reference, which share the names, get
the same values, and the reference can make them again after the program
is gone. Per leaf: N(0, 1) for the slot latents; 1 + 0.02 z for the
LayerNorm scales (1-D weights); 0.02 z for everything else, biases
included (the port's initial weights leave biases at 0 and the head 1000
times smaller; random non-degenerate values exercise every product).
"""

from __future__ import annotations

from typing import Dict, Iterable, Tuple

import torch

# distinct streams of one seed
WEIGHT_STREAM, CLIP_STREAM, DRAW_STREAM, DROP_STREAM = 1, 2, 3, 4


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator on `device` for one stream of `seed` (any integer up to
    2**62)."""
    return torch.Generator(device=device).manual_seed((int(seed) * 8 + stream) % (2 ** 63))


def make_weights(shapes: Dict[str, Dict[str, Tuple[int, ...]]], seed: int, device) -> Dict[str, Dict[str, torch.Tensor]]:
    """{model: {name: float32 tensor}} for {model: {name: shape}}, from one
    normal draw over every leaf of every model in name order."""
    leaves = sorted((m, n, tuple(s)) for m, named in shapes.items() for n, s in named.items())
    sizes = [torch.Size(s).numel() for _, _, s in leaves]
    flat = torch.randn(sum(sizes), generator=generator(seed, WEIGHT_STREAM, device), device=device)
    out: Dict[str, Dict[str, torch.Tensor]] = {m: {} for m in shapes}
    for (m, n, s), z in zip(leaves, torch.split(flat, sizes)):
        z = z.view(s)
        if n.endswith("latents"):
            w = z.clone()
        elif len(s) == 1 and n.endswith("weight"):
            w = 1.0 + 0.02 * z
        else:
            w = 0.02 * z
        out[m][n] = w
    return out


def shapes_of(named: Iterable[Tuple[str, torch.Tensor]]) -> Dict[str, Tuple[int, ...]]:
    return {n: tuple(p.shape) for n, p in named}


def load_into(model: torch.nn.Module, weights: Dict[str, torch.Tensor]) -> None:
    """Copy `weights` into `model`'s parameters, every one named."""
    params = dict(model.named_parameters())
    if set(params) != set(weights):
        raise ValueError(f"weights do not name the model's parameters: {sorted(set(params) ^ set(weights))[:6]}")
    with torch.no_grad():
        for n, p in params.items():
            p.copy_(weights[n])


def make_pool(traffic: dict, cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The traffic mix's pool of batches, from the seed: clips [P, B, T, H,
    W, C] N(0, 1) float32 (every row different), action labels [P, B] and,
    where the traffic asks, scene labels [P, B]; where the configuration
    runs FAME, its donor permutation and keep per batch."""
    m = cfg["model"]
    P, B = traffic["pool"], traffic["batch"]
    g = generator(seed, CLIP_STREAM, device)
    pool = {"videos": torch.randn((P, B, m["num_frames"], m["img_size"], m["img_size"], 3), generator=g,
                                  device=device),
            "labels": torch.randint(0, m["num_classes"], (P, B), generator=g, device=device)}
    if traffic.get("scene_labels"):
        pool["scene_labels"] = torch.randint(0, m["num_scene_classes"], (P, B), generator=g, device=device)
    if cfg.get("fame"):
        d = generator(seed, DRAW_STREAM, device)
        pool["perm"] = torch.rand((P, B), generator=d, device=device).argsort(dim=1)
        keep = torch.rand((P, B), generator=d, device=device)
        prob = cfg["fame"]["prob_aug"]
        pool["keep"] = keep < prob if prob < 1 else torch.ones_like(keep, dtype=torch.bool)
    return pool
