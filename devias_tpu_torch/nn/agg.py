"""Slot-attention aggregation block (port of `devias_tpu/nn/agg.py`).

`depth` rounds of cross-attention from `num_latents` learned slot queries
onto the patch tokens, `heads` x `dim_head` wide, with the softmax over
the SLOT axis followed by a renormalisation over keys, a pre-norm
feed-forward (`ff_mult` x wide), optional weight tying across rounds and a
final LayerNorm (`last_ln`). Returns (slots [B, S, D], P_last [B, heads,
S, N]), P_last being the last round's slot softmax before the key
renormalisation. In training `attn_dropout` drops the cross-attention's
output and `ff_dropout` the feed-forward's GELU output, drawn from the
generator passed to `forward` (`devias_tpu/nn/agg.py:449, 510`);
`pos_enc_type='sine1d'` adds `nn/pos_encoding.py::sine_1d` to the normed
context on the keys only, before `to_k` (`:430-441`). The gradients are
autograd's of this forward; JAX's hand-written VJPs of the tied stack
compute the same function (held in `tests/test_torch_grads.py`).

The context never changes across rounds, so its LayerNorm and the K/V
projections run once per unique layer. Module names follow the reference
layout `agg_block.layers.{i}.{0,2}...`; a tied block registers the same
layer object at every index, so `state_dict()` lists every index as the
reference's cache_fn tying stores it.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from devias_tpu_torch.nn.pos_encoding import build_position_encoding
from devias_tpu_torch.nn.vit import Linear, dropout

# torch nn.LayerNorm's default eps: the agg block's norms use it, unlike the
# backbone's 1e-6
TORCH_LN_EPS = 1e-5
# the reference's agg block geometry (agg_block/agg_block.py:83), the defaults
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
    `layers.{i}.0`): to_q, to_k, to_v without bias, to_out with bias. The
    `nn.Dropout` at `to_out.1` only keeps the reference layout;
    `AggLayer.round` applies the dropout with its generator."""

    def __init__(self, dim: int, heads: int = HEADS, dim_head: int = DIM_HEAD):
        super().__init__()
        inner = heads * dim_head
        self.to_q = Linear(dim, inner, bias=False)
        self.to_k = Linear(dim, inner, bias=False)
        self.to_v = Linear(dim, inner, bias=False)
        self.to_out = nn.Sequential(Linear(inner, dim), nn.Dropout(0.0))


class _PreNormAttn(nn.Module):
    def __init__(self, dim: int, dtype: torch.dtype, heads: int, dim_head: int):
        super().__init__()
        self.norm = LayerNorm(dim, TORCH_LN_EPS, dtype)
        self.norm_context = LayerNorm(dim, TORCH_LN_EPS, dtype)
        self.fn = SlotCrossAttention(dim, heads, dim_head)


class _FeedForward(nn.Module):
    def __init__(self, dim: int, ff_mult: int):
        super().__init__()
        # only net.0 and net.3 hold weights; `AggLayer.round` applies them
        # with its own exact GELU and dropout
        self.net = nn.Sequential(Linear(dim, dim * ff_mult), nn.GELU(), nn.Dropout(0.0), Linear(dim * ff_mult, dim))


class _PreNormFF(nn.Module):
    def __init__(self, dim: int, dtype: torch.dtype, ff_mult: int):
        super().__init__()
        self.norm = LayerNorm(dim, TORCH_LN_EPS, dtype)
        self.fn = _FeedForward(dim, ff_mult)


class AggLayer(nn.ModuleList):
    """One round's weights in the reference layout: [0] is the pre-norm
    cross-attention, [2] the pre-norm feed-forward; [1] holds no weights."""

    def __init__(self, dim: int, dtype: torch.dtype, heads: int = HEADS, dim_head: int = DIM_HEAD,
                 ff_mult: int = FF_MULT, attn_dropout: float = 0.0, ff_dropout: float = 0.0):
        super().__init__([_PreNormAttn(dim, dtype, heads, dim_head), nn.Identity(), _PreNormFF(dim, dtype, ff_mult)])
        self.dtype = dtype
        self.heads, self.dim_head = heads, dim_head
        self.attn_dropout, self.ff_dropout = attn_dropout, ff_dropout

    def project_kv(self, context: torch.Tensor, k_pos: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Context LayerNorm and K/V projections, head-major [B, h, N, dh];
        `k_pos` [N, D] is added to the normed context of the keys only."""
        attn = self[0]
        ctx = attn.norm_context(context)
        B, N, _ = ctx.shape
        k_in = ctx if k_pos is None else ctx + k_pos.to(ctx.dtype)

        def heads(t):
            return t.reshape(B, N, self.heads, self.dim_head).transpose(1, 2).contiguous()

        return heads(attn.fn.to_k(k_in)), heads(attn.fn.to_v(ctx))

    def weights(self):
        """The round's weights cast to the compute dtype, LayerNorm scales
        and biases included: (nq_s, nq_b, wq, wo, bo, nf_s, nf_b, w1, b1, w2, b2)."""
        attn, ff = self[0], self[2]
        fc1, fc2 = ff.fn.net[0], ff.fn.net[3]
        ws = (attn.norm.weight, attn.norm.bias, attn.fn.to_q.weight.t(), attn.fn.to_out[0].weight.t(),
              attn.fn.to_out[0].bias, ff.norm.weight, ff.norm.bias, fc1.weight.t(), fc1.bias,
              fc2.weight.t(), fc2.bias)
        return tuple(w.to(self.dtype) for w in ws)

    def round(self, x, k, v, w, generator: Optional[torch.Generator] = None,
              training: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        """One round: PreNorm(slot cross-attention) + residual, PreNorm(FF)
        + residual, with the dropouts in `training`. Returns (x, P) with P
        the pre-renorm slot softmax."""
        (nq_s, nq_b, wq, wo, bo, nf_s, nf_b, w1, b1, w2, b2) = w
        B, S, _ = x.shape
        h, dh = self.heads, self.dim_head
        xn = _ln_f(x, nq_s, nq_b, TORCH_LN_EPS)
        q = (xn @ wq).reshape(B, S, h, dh).transpose(1, 2)
        sim = (q @ k.transpose(-1, -2)) * dh ** -0.5  # [B, h, S, N]
        P = sim.float().softmax(dim=2)  # softmax over the slot axis
        A = (P / (P.sum(dim=-1, keepdim=True) + 1e-7)).to(x.dtype)
        o = (A @ v).transpose(1, 2).reshape(B, S, h * dh)
        x1 = dropout(o @ wo + bo, self.attn_dropout, training, generator) + x
        yn = _ln_f(x1, nf_s, nf_b, TORCH_LN_EPS)
        x2 = dropout(_gelu_exact(yn @ w1 + b1), self.ff_dropout, training, generator) @ w2 + b2 + x1
        return x2, P


class AggregationBlock(nn.Module):
    """`depth` slot cross-attention rounds over learned queries; with
    `weight_tie` one layer's weights serve every round. The other fields
    are the JAX block's (`devias_tpu/nn/agg.py:551-557`; module
    docstring); `last_ln=False` leaves out `last_layer`, and
    `pos_enc_type` is 'none' or 'sine1d' ('sine2d' needs a patch grid
    that no caller of the block has, and raises, as in JAX)."""

    def __init__(self, num_latents: int = 2, latent_dim: int = 768, depth: int = 4,
                 weight_tie: bool = True, dtype: torch.dtype = torch.float32, heads: int = HEADS,
                 dim_head: int = DIM_HEAD, ff_mult: int = FF_MULT, attn_dropout: float = 0.0,
                 ff_dropout: float = 0.0, last_ln: bool = True, pos_enc_type: Optional[str] = "none"):
        super().__init__()
        self.depth = depth
        self.weight_tie = weight_tie
        self.dtype = dtype
        self.pos_enc_type = pos_enc_type
        self.latents = nn.Parameter(torch.zeros(num_latents, latent_dim))

        def layer():
            return AggLayer(latent_dim, dtype, heads, dim_head, ff_mult, attn_dropout, ff_dropout)

        if weight_tie:
            self.layers = nn.ModuleList([layer()] * depth)
        else:
            self.layers = nn.ModuleList([layer() for _ in range(depth)])
        self.last_layer = nn.Sequential(LayerNorm(latent_dim, TORCH_LN_EPS, dtype)) if last_ln else None
        self._pos_cache: Dict[Tuple[int, int, torch.device], Optional[torch.Tensor]] = {}

    def init_own_params(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.latents.normal_(0.0, 1.0, generator=generator)

    def _k_pos(self, context: torch.Tensor) -> Optional[torch.Tensor]:
        key = (context.shape[1], context.shape[2], context.device)
        if key not in self._pos_cache:
            self._pos_cache[key] = build_position_encoding(self.pos_enc_type, key[0], key[1], device=key[2])
        return self._pos_cache[key]

    def forward(self, context: torch.Tensor, generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        k_pos = self._k_pos(context)
        unique = self.layers[:1] if self.weight_tie else self.layers
        kvw = [(*layer.project_kv(context, k_pos), layer.weights()) for layer in unique]
        x = self.latents.to(self.dtype)[None].expand(context.shape[0], -1, -1)
        P = None
        for i in range(self.depth):
            layer = self.layers[i]
            k, v, w = kvw[0 if self.weight_tie else i]
            x, P = layer.round(x, k, v, w, generator, self.training)
        return (x if self.last_layer is None else self.last_layer(x)), P

