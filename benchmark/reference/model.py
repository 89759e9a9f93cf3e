"""Plain float32 models the benchmark holds the program against.

A frozen copy, in plain PyTorch, of the arithmetic of the port's slot ViT
(backbone, slot aggregation block, unified head, mask predictor) and of its
CLS scene teacher: the same functions, with no kernel, no bfloat16 and no
cache. The parameter names are the port's, so one set of seeded weights
(`harness/weights.py`) serves both sides. What the configuration fixes is
kept as the program computes it in its stated precision: the tanh GELU of
the blocks when the compute type is bfloat16, the fast-variance LayerNorms,
the slot softmax over the slot axis and its renormalisation over keys.

`quant="fp8"` is the control of the correctness check, float8 training as
it is run on this card: every dense product (patch embed, the blocks', the
agg block's and the heads') takes its input per row and its weight per
output channel rounded to float8 e4m3, and its backward products take the
output's gradient per row rounded to float8 e5m2, each slice scaled so its
largest magnitude is the format's largest. Attention products and
everything else stay float32.

Drop-path draws are handed in (`drop_masks`: per block and branch a [B]
boolean keep, or None), so the caller decides where they come from.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

LN_EPS_BLOCK = 1e-6
LN_EPS_AGG = 1e-5
AGG_HEADS, AGG_DIM_HEAD, AGG_FF_MULT = 4, 512, 4
_SQRT2 = 1.4142135623730951


FP8 = {torch.float8_e4m3fn: 448.0, torch.float8_e5m2: 57344.0}


def _fp8(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """x rounded to `dtype` per last-axis slice, each scaled so that its
    largest magnitude is the format's largest, back in float32."""
    scale = (x.abs().amax(dim=-1, keepdim=True) / FP8[dtype]).clamp_min(1e-30)
    return (x / scale).to(dtype).float() * scale


class _Fp8Dense(torch.autograd.Function):
    """x @ w^T + b with e4m3 operands forward and an e5m2 output gradient
    in the two backward products."""

    @staticmethod
    def forward(ctx, x, w, b):
        xq, wq = _fp8(x, torch.float8_e4m3fn), _fp8(w, torch.float8_e4m3fn)
        ctx.save_for_backward(xq, wq)
        ctx.has_bias = b is not None
        return F.linear(xq, wq, b)

    @staticmethod
    def backward(ctx, gy):
        xq, wq = ctx.saved_tensors
        gq = _fp8(gy, torch.float8_e5m2)
        gx = gq @ wq
        gw = gq.reshape(-1, gq.shape[-1]).t() @ xq.reshape(-1, xq.shape[-1])
        gb = gy.reshape(-1, gy.shape[-1]).sum(0) if ctx.has_bias else None
        return gx, gw, gb


def dense(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor], quant: Optional[str]) -> torch.Tensor:
    """x @ weight^T + bias in float32; float8 products under `quant`."""
    if quant == "fp8":
        return _Fp8Dense.apply(x, weight, bias)
    if quant is not None:
        raise ValueError(f"unknown quant {quant!r}")
    return F.linear(x, weight, bias)


class Linear(nn.Module):
    def __init__(self, din: int, dout: int, bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(dout, din))
        self.bias = nn.Parameter(torch.empty(dout)) if bias else None
        self.quant: Optional[str] = None

    def forward(self, x):
        return dense(x, self.weight, self.bias, self.quant)


class LayerNorm(nn.Module):
    """E[x^2] - E[x]^2 variance, clamped at 0 (both of the port's forms
    agree with it in float32 to rounding)."""

    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(dim))
        self.bias = nn.Parameter(torch.empty(dim))

    def forward(self, x):
        mean = x.mean(dim=-1, keepdim=True)
        var = ((x * x).mean(dim=-1, keepdim=True) - mean * mean).clamp_min(0.0)
        return (x - mean) * torch.rsqrt(var + self.eps) * self.weight + self.bias


def sinusoid_table(n: int, d: int) -> torch.Tensor:
    pos = np.arange(n, dtype=np.float64)[:, None]
    j = np.arange(d, dtype=np.float64)[None, :]
    angle = pos / np.power(10000.0, 2.0 * (j // 2) / d)
    table = np.zeros((n, d))
    table[:, 0::2] = np.sin(angle[:, 0::2])
    table[:, 1::2] = np.cos(angle[:, 1::2])
    return torch.from_numpy(table.astype(np.float32))


class Attention(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.scale = (dim // heads) ** -0.5
        self.qkv = Linear(dim, 3 * dim, bias=False)
        self.q_bias = nn.Parameter(torch.empty(dim))
        self.v_bias = nn.Parameter(torch.empty(dim))
        self.proj = Linear(dim, dim)

    def forward(self, x):
        B, N, C = x.shape
        qkv = self.qkv(x) + torch.cat([self.q_bias, torch.zeros_like(self.q_bias), self.v_bias])
        q, k, v = qkv.reshape(B, N, 3, self.heads, C // self.heads).permute(2, 0, 3, 1, 4)
        p = ((q * self.scale) @ k.transpose(-1, -2)).softmax(dim=-1)
        return self.proj((p @ v).transpose(1, 2).reshape(B, N, C))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, tanh_gelu: bool):
        super().__init__()
        self.fc1 = Linear(dim, hidden)
        self.fc2 = Linear(hidden, dim)
        self.approx = "tanh" if tanh_gelu else "none"

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x), approximate=self.approx))


def drop_path(x: torch.Tensor, keep_mask: Optional[torch.Tensor], rate: float) -> torch.Tensor:
    if keep_mask is None or rate == 0.0:
        return x
    keep = 1.0 - rate
    return torch.where(keep_mask.view(-1, *([1] * (x.dim() - 1))), x / keep, torch.zeros_like(x))


class Block(nn.Module):
    def __init__(self, dim: int, heads: int, mlp_ratio: float, tanh_gelu: bool, drop_path_rate: float):
        super().__init__()
        self.rate = drop_path_rate
        self.norm1 = LayerNorm(dim, LN_EPS_BLOCK)
        self.attn = Attention(dim, heads)
        self.norm2 = LayerNorm(dim, LN_EPS_BLOCK)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), tanh_gelu)

    def forward(self, x, masks=(None, None)):
        x = x + drop_path(self.attn(self.norm1(x)), masks[0], self.rate)
        return x + drop_path(self.mlp(self.norm2(x)), masks[1], self.rate)


class PatchEmbed(nn.Module):
    """Tubelet embedding as patchify + one product, weights in the Conv3d
    layout [D, C, t, p, p] under `proj`."""

    def __init__(self, dim: int, tubelet: int, patch: int):
        super().__init__()
        self.tubelet, self.patch = tubelet, patch
        self.proj = nn.Module()
        self.proj.weight = nn.Parameter(torch.empty(dim, 3, tubelet, patch, patch))
        self.proj.bias = nn.Parameter(torch.empty(dim))
        self.quant: Optional[str] = None

    def forward(self, x):
        B, T, H, W, C = x.shape
        t, p = self.tubelet, self.patch
        x = x.reshape(B, T // t, t, H // p, p, W // p, p, C).permute(0, 1, 3, 5, 2, 4, 6, 7)
        x = x.reshape(B, (T // t) * (H // p) * (W // p), t * p * p * C)
        w = self.proj.weight.permute(0, 2, 3, 4, 1).reshape(self.proj.weight.shape[0], -1)
        return dense(x, w, self.proj.bias, self.quant)


class Backbone(nn.Module):
    def __init__(self, m: dict, cls_token: bool):
        super().__init__()
        dim, depth = m["embed_dim"], m["depth"]
        self.patch_embed = PatchEmbed(dim, m["tubelet_size"], m.get("patch_size", 16))
        self.cls_token = nn.Parameter(torch.empty(1, 1, dim)) if cls_token else None
        tanh = m["dtype"] == "bfloat16" and not m.get("exact_gelu", False)
        rates = np.linspace(0.0, m.get("drop_path_rate", 0.0), depth)
        self.blocks = nn.ModuleList([Block(dim, m["num_heads"], m.get("mlp_ratio", 4.0), tanh, float(rates[i]))
                                     for i in range(depth)])
        self.norm = LayerNorm(dim, LN_EPS_BLOCK)

    def features(self, x, drop_masks=None):
        x = self.patch_embed(x)
        if self.cls_token is not None:
            x = torch.cat([self.cls_token.expand(x.shape[0], -1, -1), x], dim=1)
        x = x + sinusoid_table(x.shape[1], x.shape[2]).to(x.device)[None]
        for i, blk in enumerate(self.blocks):
            masks = None if drop_masks is None else drop_masks[i]
            x = blk(x, (None, None) if masks is None else masks)
        return self.norm(x)


def _ln(x, norm: LayerNorm):
    """The agg block's two-pass LayerNorm."""
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + norm.eps) * norm.weight + norm.bias


class _PreNormAttn(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        inner = AGG_HEADS * AGG_DIM_HEAD
        self.norm = LayerNorm(dim, LN_EPS_AGG)
        self.norm_context = LayerNorm(dim, LN_EPS_AGG)
        self.fn = nn.Module()
        self.fn.to_q = Linear(dim, inner, bias=False)
        self.fn.to_k = Linear(dim, inner, bias=False)
        self.fn.to_v = Linear(dim, inner, bias=False)
        self.fn.to_out = nn.Sequential(Linear(inner, dim))


class _PreNormFF(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.norm = LayerNorm(dim, LN_EPS_AGG)
        self.fn = nn.Module()
        self.fn.net = nn.ModuleDict({"0": Linear(dim, dim * AGG_FF_MULT), "3": Linear(dim * AGG_FF_MULT, dim)})


class AggLayer(nn.ModuleList):
    def __init__(self, dim: int):
        super().__init__([_PreNormAttn(dim), nn.Identity(), _PreNormFF(dim)])

    def kv(self, context):
        attn = self[0]
        B, N, _ = context.shape
        ctx = attn.norm_context(context)

        def heads(t):
            return t.reshape(B, N, AGG_HEADS, AGG_DIM_HEAD).transpose(1, 2)

        return heads(attn.fn.to_k(ctx)), heads(attn.fn.to_v(ctx))

    def round(self, x, k, v):
        attn, ff = self[0], self[2]
        B, S, _ = x.shape
        q = attn.fn.to_q(_ln(x, attn.norm)).reshape(B, S, AGG_HEADS, AGG_DIM_HEAD).transpose(1, 2)
        P = ((q @ k.transpose(-1, -2)) * AGG_DIM_HEAD ** -0.5).softmax(dim=2)
        A = P / (P.sum(dim=-1, keepdim=True) + 1e-7)
        o = (A @ v).transpose(1, 2).reshape(B, S, AGG_HEADS * AGG_DIM_HEAD)
        x1 = attn.fn.to_out[0](o) + x
        y = ff.fn.net["0"](_ln(x1, ff.norm))
        y = 0.5 * y * (1.0 + torch.erf(y / _SQRT2))
        return ff.fn.net["3"](y) + x1, P


class AggregationBlock(nn.Module):
    def __init__(self, num_latents: int, dim: int, depth: int, tie: bool):
        super().__init__()
        self.depth, self.tie = depth, tie
        self.latents = nn.Parameter(torch.empty(num_latents, dim))
        self.layers = nn.ModuleList([AggLayer(dim)] * depth if tie else [AggLayer(dim) for _ in range(depth)])
        self.last_layer = nn.Sequential(LayerNorm(dim, LN_EPS_AGG))

    def forward(self, context):
        kvs = [layer.kv(context) for layer in (self.layers[:1] if self.tie else self.layers)]
        x = self.latents[None].expand(context.shape[0], -1, -1)
        P = None
        for i in range(self.depth):
            k, v = kvs[0 if self.tie else i]
            x, P = self.layers[i].round(x, k, v)
        return self.last_layer(x), P


class SlotViT(Backbone):
    """Output dict: slots, slots_head, mask_predictions, attn (the last
    round's slot softmax [B, heads, S, N])."""

    def __init__(self, m: dict):
        super().__init__(m, cls_token=False)
        dim = m["embed_dim"]
        self.agg_block = AggregationBlock(m["num_latents"], dim, m["agg_depth"], m["agg_weights_tie"])
        self.head = Linear(dim, m["num_classes"] + m["num_scene_classes"])
        n_patch = (m["img_size"] // m.get("patch_size", 16)) ** 2
        self.mask_predictor = nn.Module()
        self.mask_predictor.decoder = nn.Sequential(Linear(dim, 512), nn.ReLU(), Linear(512, 256), nn.ReLU(),
                                                    Linear(256, n_patch))

    def forward(self, x, drop_masks=None) -> Dict[str, torch.Tensor]:
        slots, attn = self.agg_block(self.features(x, drop_masks))
        return {"slots": slots, "slots_head": self.head(slots),
                "mask_predictions": torch.sigmoid(self.mask_predictor.decoder(slots)), "attn": attn}


class PlainViT(Backbone):
    """The CLS teacher: the final norm's CLS token through `head`."""

    def __init__(self, m: dict):
        super().__init__(m, cls_token=True)
        self.head = Linear(m["embed_dim"], m["num_classes"])

    def forward(self, x) -> torch.Tensor:
        return self.head(self.features(x)[:, 0])


def set_quant(model: nn.Module, quant: Optional[str]) -> None:
    for mod in model.modules():
        if hasattr(mod, "quant"):
            mod.quant = quant


def scene_criterion(slots_head: torch.Tensor, num_classes: int) -> torch.Tensor:
    """Per slot, the highest scene-class probability [B, S]: the port
    selects the scene slot as its first maximum."""
    return slots_head.softmax(dim=-1)[..., num_classes:].amax(dim=-1)


def drop_keep_shapes(m: dict) -> List[Tuple[int, float]]:
    """(block, rate) of each block whose drop-path rate is above 0, in
    order: each draws one keep for its attention branch, then one for its
    MLP branch, per sample."""
    rates = np.linspace(0.0, m.get("drop_path_rate", 0.0), m["depth"])
    return [(i, float(r)) for i, r in enumerate(rates) if r > 0.0]
