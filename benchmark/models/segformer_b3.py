"""The frozen SegFormer person-mask model of `--mask_model Segformer`: the
port's `Segformer` and its plain float32 reference,
`reference/segformer.py::Segformer`, which share HF's parameter names.

A mask model is not a student or a teacher: the step runs it on the even
frames of each clip (8 of 16) at the clips' own size, so its counts take
the frames and their size. Operations are those the program runs: the
decode head fuses each stage's block of `linear_fuse` on the stage's own
grid (2.80 GMAC a 224^2 frame at B3) where HF's order fuses the
concatenated maps at a quarter of the input (7.74)."""

import torch

from harness import roofline
from reference import segformer as ref_segformer

# the frames of a 16-frame clip the step masks, and their size
FRAMES, SIZE = 8, 224


def _config(m):
    from devias_tpu_torch.nn.segformer import SegformerConfig

    keys = ("num_labels", "hidden_sizes", "depths", "num_heads", "sr_ratios", "patch_sizes", "strides",
            "mlp_ratio", "decoder_hidden_size", "layer_norm_eps", "bn_eps")
    return SegformerConfig(**{k: tuple(m[k]) if isinstance(m[k], list) else m[k] for k in keys if k in m})


def program(m, device):
    """`create_segformer` of the configuration's geometry in its compute
    type: what the CLI's `build_segformer` builds, its checkpoint aside."""
    from devias_tpu_torch.nn.segformer import create_segformer

    return create_segformer(_config(m), device=device, dtype=getattr(torch, m["dtype"]))


def reference(m):
    return ref_segformer.Segformer(m)


def _grid(n, kernel, stride):
    return (n + 2 * (kernel // 2) - kernel) // stride + 1


def _stages(m, size):
    """Per stage (tokens, width, keys, kernel, stride, input width)."""
    out, h, c_in = [], size, 3
    for s in range(4):
        p, st, C, r = m["patch_sizes"][s], m["strides"][s], m["hidden_sizes"][s], m["sr_ratios"][s]
        h = _grid(h, p, st)
        out.append((h * h, C, (h // r) ** 2 if r > 1 else h * h, p, st, c_in, r))
        c_in = C
    return out


def tokens(m, size=SIZE):
    """Tokens of the first stage's map of one frame."""
    return _stages(m, size)[0][0]


def flops_per_frame(m, size=SIZE):
    """Forward operations on one size x size frame (2 per multiply-add):
    per stage the patch embed; per block q and the output projection
    (2NC^2), k and v on the M reduced keys (2MC^2), the reduction conv
    (MC^2 sr^2), the two attention products (2NMC), the Mix-FFN's denses
    (2NC Hm) and depthwise conv (9N Hm); the decode head's projections to
    its width D and each stage's block of the fuse on its own grid
    (N C D + N D^2), and the classifier at the first stage's grid."""
    macs = 0
    stages = _stages(m, size)
    D = m["decoder_hidden_size"]
    for s, (N, C, M, p, _, c_in, r) in enumerate(stages):
        hidden = C * m["mlp_ratio"]
        block = 2 * N * C * C + 2 * M * C * C + (M * C * C * r * r if r > 1 else 0) + 2 * N * M * C
        block += 2 * N * C * hidden + 9 * N * hidden
        macs += N * C * c_in * p * p + m["depths"][s] * block + N * C * D + N * D * D
    macs += stages[0][0] * D * m["num_labels"]
    return 2 * macs


def flops_per_clip(m, frames=FRAMES, size=SIZE):
    """The operations on the masked frames of one clip."""
    return frames * flops_per_frame(m, size)


def parameters(m):
    with torch.device("meta"):
        return sum(p.numel() for p in reference(m).parameters())


def bound_ms(m, frames, size=SIZE):
    """The least time of the mask model on `frames` frames: its operations
    at the bf16 peak, or its least bytes at HBM bandwidth, whichever is
    larger. Least bytes: the frames read in float32, the float32 weights
    read once, the bf16 logits written."""
    quarter = tokens(m, size)
    nbytes = frames * size * size * 3 * 4 + parameters(m) * 4 + frames * quarter * m["num_labels"] * 2
    return roofline.bound_ms(frames * flops_per_frame(m, size), nbytes)
