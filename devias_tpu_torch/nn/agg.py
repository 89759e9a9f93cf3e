"""Slot-attention aggregation block, forward only (port of
`devias_tpu/nn/agg.py`).

`depth` rounds of cross-attention from `num_latents` learned slot queries
onto the patch tokens, with the softmax over the SLOT axis followed by a
renormalisation over keys, a pre-norm feed-forward, optional weight tying
across rounds and a final LayerNorm. Returns (slots [B, S, D], P_last
[B, heads, S, N]), P_last being the last round's slot softmax before the
key renormalisation.

The context never changes across rounds, so its LayerNorm and the K/V
projections run once per unique layer. Module names follow the reference
layout `agg_block.layers.{i}.{0,2}...`; a tied block registers the same
layer object at every index, so `state_dict()` lists every index as the
reference's cache_fn tying stores it.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from devias_tpu_torch.nn.vit import Linear

# torch nn.LayerNorm's default eps: the agg block's norms use it, unlike the
# backbone's 1e-6
TORCH_LN_EPS = 1e-5
# the reference's agg block geometry (agg_block/agg_block.py:83)
HEADS, DIM_HEAD, FF_MULT = 4, 512, 4
_SQRT2 = 1.4142135623730951


def _ln_f(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float) -> torch.Tensor:
    """Two-pass LayerNorm in float32 with scale and bias already in the
    compute dtype, output in x's dtype (`devias_tpu/nn/agg.py:115-121`)."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps) * scale.float() + bias.float()
    return y.to(x.dtype)


def _gelu_exact(x: torch.Tensor) -> torch.Tensor:
    """Exact erf GELU computed in float32, in every compute dtype."""
    xf = x.float()
    return (0.5 * xf * (1.0 + torch.erf(xf / _SQRT2))).to(x.dtype)


class LayerNorm(nn.Module):
    """flax `nn.LayerNorm` forward: float32 statistics in the fast-variance
    form (clamped at 0), float32 scale and bias, output in `dtype`. Also the
    parameter holder for the rounds' norms, whose math is `_ln_f`."""

    def __init__(self, dim: int, eps: float = TORCH_LN_EPS, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def init_own_params(self, generator: torch.Generator) -> None:
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = ((xf * xf).mean(dim=-1, keepdim=True) - mean * mean).clamp_min(0.0)
        y = (xf - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias
        return y.to(self.dtype)


class SlotCrossAttention(nn.Module):
    """Projections of one slot cross-attention (reference `fn` of
    `layers.{i}.0`): to_q, to_k, to_v without bias, to_out with bias."""

    def __init__(self, dim: int):
        super().__init__()
        inner = HEADS * DIM_HEAD
        self.to_q = Linear(dim, inner, bias=False)
        self.to_k = Linear(dim, inner, bias=False)
        self.to_v = Linear(dim, inner, bias=False)
        self.to_out = nn.Sequential(Linear(inner, dim), nn.Dropout(0.0))


class _PreNormAttn(nn.Module):
    def __init__(self, dim: int, dtype: torch.dtype):
        super().__init__()
        self.norm = LayerNorm(dim, TORCH_LN_EPS, dtype)
        self.norm_context = LayerNorm(dim, TORCH_LN_EPS, dtype)
        self.fn = SlotCrossAttention(dim)


class _FeedForward(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        # only net.0 and net.3 hold weights; `AggLayer.round` applies them
        # with its own exact GELU
        self.net = nn.Sequential(Linear(dim, dim * FF_MULT), nn.GELU(), nn.Dropout(0.0), Linear(dim * FF_MULT, dim))


class _PreNormFF(nn.Module):
    def __init__(self, dim: int, dtype: torch.dtype):
        super().__init__()
        self.norm = LayerNorm(dim, TORCH_LN_EPS, dtype)
        self.fn = _FeedForward(dim)


class AggLayer(nn.ModuleList):
    """One round's weights in the reference layout: [0] is the pre-norm
    cross-attention, [2] the pre-norm feed-forward; [1] holds no weights."""

    def __init__(self, dim: int, dtype: torch.dtype):
        super().__init__([_PreNormAttn(dim, dtype), nn.Identity(), _PreNormFF(dim, dtype)])
        self.dtype = dtype

    def project_kv(self, context: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Context LayerNorm and K/V projections, head-major [B, h, N, dh]."""
        attn = self[0]
        ctx = attn.norm_context(context)
        B, N, _ = ctx.shape

        def heads(t):
            return t.reshape(B, N, HEADS, DIM_HEAD).transpose(1, 2).contiguous()

        return heads(attn.fn.to_k(ctx)), heads(attn.fn.to_v(ctx))

    def weights(self):
        """The round's weights cast to the compute dtype, LayerNorm scales
        and biases included: (nq_s, nq_b, wq, wo, bo, nf_s, nf_b, w1, b1, w2, b2)."""
        attn, ff = self[0], self[2]
        fc1, fc2 = ff.fn.net[0], ff.fn.net[3]
        ws = (attn.norm.weight, attn.norm.bias, attn.fn.to_q.weight.t(), attn.fn.to_out[0].weight.t(),
              attn.fn.to_out[0].bias, ff.norm.weight, ff.norm.bias, fc1.weight.t(), fc1.bias,
              fc2.weight.t(), fc2.bias)
        return tuple(w.to(self.dtype) for w in ws)

    def round(self, x, k, v, w) -> Tuple[torch.Tensor, torch.Tensor]:
        """One round: PreNorm(slot cross-attention) + residual, PreNorm(FF)
        + residual. Returns (x, P) with P the pre-renorm slot softmax."""
        (nq_s, nq_b, wq, wo, bo, nf_s, nf_b, w1, b1, w2, b2) = w
        B, S, _ = x.shape
        xn = _ln_f(x, nq_s, nq_b, TORCH_LN_EPS)
        q = (xn @ wq).reshape(B, S, HEADS, DIM_HEAD).transpose(1, 2)
        sim = (q @ k.transpose(-1, -2)) * DIM_HEAD ** -0.5  # [B, h, S, N]
        P = sim.float().softmax(dim=2)  # softmax over the slot axis
        A = (P / (P.sum(dim=-1, keepdim=True) + 1e-7)).to(x.dtype)
        o = (A @ v).transpose(1, 2).reshape(B, S, HEADS * DIM_HEAD)
        x1 = (o @ wo + bo) + x
        yn = _ln_f(x1, nf_s, nf_b, TORCH_LN_EPS)
        x2 = _gelu_exact(yn @ w1 + b1) @ w2 + b2 + x1
        return x2, P


class AggregationBlock(nn.Module):
    """`depth` slot cross-attention rounds over learned queries; with
    `weight_tie` one layer's weights serve every round."""

    def __init__(self, num_latents: int = 2, latent_dim: int = 768, depth: int = 4,
                 weight_tie: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.depth = depth
        self.weight_tie = weight_tie
        self.dtype = dtype
        self.latents = nn.Parameter(torch.zeros(num_latents, latent_dim))
        if weight_tie:
            self.layers = nn.ModuleList([AggLayer(latent_dim, dtype)] * depth)
        else:
            self.layers = nn.ModuleList([AggLayer(latent_dim, dtype) for _ in range(depth)])
        self.last_layer = nn.Sequential(LayerNorm(latent_dim, TORCH_LN_EPS, dtype))

    def init_own_params(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.latents.normal_(0.0, 1.0, generator=generator)

    def forward(self, context: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        unique = self.layers[:1] if self.weight_tie else self.layers
        kvw = [(*layer.project_kv(context), layer.weights()) for layer in unique]
        x = self.latents.to(self.dtype)[None].expand(context.shape[0], -1, -1)
        P = None
        for i in range(self.depth):
            layer = self.layers[i]
            k, v, w = kvw[0 if self.weight_tie else i]
            x, P = layer.round(x, k, v, w)
        return self.last_layer(x), P

