"""Operations and bytes of the work the program does, and the chip's peaks
(frozen copies of `chip_smoke.py::vit_flops_per_clip`, with the MLP's width
as an argument, `_bound`, `attention_bound` and `attention_bwd_bound`, with
the batch and heads as arguments). A model's tokens and operations per
clip come from its file in `models/`, found by the model entry's name.

Published peaks of one NVIDIA H100 SXM at its 700 W limit (NVIDIA's data
sheet, dense): 989 TFLOP/s in bf16, 3.35 TB/s of HBM.
"""

from __future__ import annotations

from harness import spec

BF16_PEAK = 989e12
HBM_BYTES_PER_S = 3.35e12


def vit_flops_per_clip(N: int, C: int = 768, depth: int = 12, mlp_ratio: float = 4.0) -> float:
    """Forward operations of a ViT's blocks on one clip: qkv and proj (8 N
    C^2), the MLP of width Hm = int(C mlp_ratio) (4 N C Hm) and the two
    attention products (4 N^2 C) per block; at ratio 4, 24 N C^2 + 4 N^2 C.
    The patch embed, the agg block and the heads add about 1 %."""
    hidden = int(C * mlp_ratio)
    return depth * (8 * N * C * C + 4 * N * C * hidden + 4 * N * N * C)


def patch_tokens(m: dict) -> int:
    """Patch tokens of a model entry's clips: tubelets x patches."""
    return (m["num_frames"] // m["tubelet_size"]) * (m["img_size"] // m.get("patch_size", 16)) ** 2


def bound_ms(flops: float, nbytes: float) -> float:
    """The least time the chip could take: operations over the bf16 peak
    or bytes over HBM bandwidth, whichever is larger."""
    return max(flops / BF16_PEAK, nbytes / HBM_BYTES_PER_S) * 1e3


def attention_bound_ms(B: int, H: int, N: int, D: int, stats: bool = False) -> float:
    """Forward: 4BHN^2D operations; q, k, v read and o (and m, l) written
    once, bf16."""
    return bound_ms(4 * B * H * N * N * D, (B * N * 3 * H * D + B * N * H * D) * 2 + (2 * B * H * N * 4 if stats else 0))


def attention_bwd_bound_ms(B: int, H: int, N: int, D: int) -> float:
    """Backward: five N x N x D products, 10BHN^2D operations; qkv, o, dO,
    m, l read once, dqkv written once."""
    return bound_ms(10 * B * H * N * N * D, (2 * B * N * 3 * H * D + 2 * B * N * H * D) * 2 + 2 * B * H * N * 4)


def tokens(m: dict) -> int:
    """Tokens of a model entry's clips, by its model file."""
    return spec.model(m["name"]).tokens(m)


def flops_per_clip(cfg: dict, train: bool) -> float:
    """Model operations per clip: the student's forward (and backward,
    twice the forward, in training) and the teacher's forward where the
    configuration has one. Recomputation is not counted."""
    m = cfg["model"]
    total = (3 if train else 1) * spec.model(m["name"]).flops_per_clip(m)
    t = cfg.get("teacher")
    if t:
        total += spec.model(t["name"]).flops_per_clip(t)
    return total
