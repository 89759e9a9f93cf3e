"""w8a8 int8 products for frozen-model inference (port of
`devias_tpu/nn/quant.py`), opt-in through `int8_dense=True` and the slot
CLI's `--teacher_int8`.

`int8_dot` quantises the activation per row and the weight per output
channel (symmetric, amax / 127, `round` half to even as in JAX), multiplies
int8 x int8 -> int32 with `torch._int_mm`, and dequantises as
acc * s_x * s_w. The JAX package computes that product with
`lax.dot_general` outside any Pallas kernel, so the port takes the
library's int8 GEMM (cuBLASLt on the card), as it takes `F.linear` for the
other dense layers. On the card `_int_mm` wants more than 16 rows and K
and N multiples of 8; the ViT-B teacher's products (18828 x 768 x {2304,
768, 3072} at 12 clips) meet that. A frozen layer quantises its weight
once (`nn/vit.py::Linear`) and calls `int8_dot_quantized`.

This is not the parity path: quantisation perturbs the logits. Nor is it
faster on an H100 than the bf16 teacher (`PERF.md`): the per-row
activation quantisation and the dequantisation are passes of their own
over every product's input and output. `round` has a zero gradient, so
these layers serve frozen weights only (the scene teacher under
`no_grad`), as in JAX.
"""

from __future__ import annotations

from typing import Tuple

import torch

INT8_MAX = 127.0
_MIN_SCALE = 1e-12


def quantize(x: torch.Tensor, dim: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int8 values, float32 scales) of x, symmetric per slice along `dim`,
    as JAX computes them on x cast to float32 (the amax and the division
    below give the same values on a bfloat16 x). The amax is divided by a
    0-dim tensor on x's device, not by a Python number: on the card PyTorch
    turns a division by a host scalar into a product with its reciprocal,
    which rounds some scales differently from the CPU's (and JAX's)
    division."""
    int8_max = torch.full((), INT8_MAX, device=x.device)
    scale = (x.abs().amax(dim=dim, keepdim=True).float() / int8_max).clamp_min(_MIN_SCALE)
    return torch.div(x, scale).round_().to(torch.int8), scale


def int8_dot_quantized(x: torch.Tensor, wq: torch.Tensor, sw: torch.Tensor) -> torch.Tensor:
    """x [..., K] times the quantised weight (`quantize(weight, 1)`: wq
    [N, K] int8, sw [N, 1] float32) through int8, dequantised to float32
    [..., N]."""
    xq, sx = quantize(x, -1)
    acc = torch._int_mm(xq.reshape(-1, x.shape[-1]), wq.t())
    return acc.float().reshape(*x.shape[:-1], wq.shape[0]).mul_(sx).mul_(sw.reshape(-1))


def int8_dot(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """x [..., K] times `weight` [N, K] (the `nn.Linear` layout) through
    int8, dequantised to float32 [..., N]. JAX's per-column scale of its
    [K, N] kernel is the per-row amax of `weight` here."""
    return int8_dot_quantized(x, *quantize(weight.float(), 1))
