"""SegFormer (MiT encoder + all-MLP decode head), the frozen person-mask
model of slot training (port of `devias_tpu/nn/segformer.py`).

The reference runs HuggingFace's `SegformerForSemanticSegmentation` with
`nvidia/segformer-b3-finetuned-cityscapes-1024-1024` (ref
run_slot_finetuning.py:423-427, engine/engine_for_slot.py:108-118). The
modules carry HF's key layout (`segformer.encoder.patch_embeddings.{s}.proj`,
`segformer.encoder.block.{s}.{i}.attention.self.query`, ...,
`decode_head.classifier`), so an HF state dict loads with `strict=True`
(`ckpt/segformer_import.py`). The arithmetic is the JAX module's, in
channels-last [B, H, W, C], with the compute dtype `dtype` (bfloat16 on
the card, float32 for parity tests; weights stay float32 and are cast at
use):
  * overlapping patch embeddings (convs 7/4/3, then 3/2/1, padding p//2)
    and a LayerNorm (float32 statistics, eps 1e-6)
  * efficient self-attention: K/V from a VALID sr x sr strided conv and a
    LayerNorm; the scores in `dtype`, the softmax in float32 cast back
    (an einsum and a softmax, as in JAX: no attention kernel)
  * Mix-FFN: dense -> 3x3 depthwise conv -> GELU (tanh in bfloat16,
    exact erf in float32) -> dense
  * the decode head in the JAX order sum_s resize(p_s @ W_s), W_s the
    reversed-concat block of `linear_fuse` (stage s -> input channels
    (3-s)D:(4-s)D), bilinear upsampling in float32 with half-pixel
    centres, then the frozen BatchNorm as x * scale/sqrt(var+eps) +
    (bias - mean*scale/sqrt(var+eps)), ReLU and the classifier.
Inference only: no dropout or drop-path.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from devias_tpu_torch.device import DeviceLike, resolve_device
from devias_tpu_torch.nn.vit import FastLayerNorm, Linear, init_weights, trunc_normal_

# Cityscapes trainId 11 == 'person' (ref engine_for_slot.py:114 `== 11`)
CITYSCAPES_PERSON_CLASS = 11


@dataclasses.dataclass(frozen=True)
class SegformerConfig:
    num_labels: int = 19
    hidden_sizes: Tuple[int, ...] = (64, 128, 320, 512)
    depths: Tuple[int, ...] = (3, 4, 18, 3)
    num_heads: Tuple[int, ...] = (1, 2, 5, 8)
    sr_ratios: Tuple[int, ...] = (8, 4, 2, 1)
    patch_sizes: Tuple[int, ...] = (7, 3, 3, 3)
    strides: Tuple[int, ...] = (4, 2, 2, 2)
    mlp_ratio: int = 4
    decoder_hidden_size: int = 768
    layer_norm_eps: float = 1e-6
    bn_eps: float = 1e-5


def segformer_b0(num_labels: int = 19) -> SegformerConfig:
    return SegformerConfig(num_labels=num_labels, hidden_sizes=(32, 64, 160, 256), depths=(2, 2, 2, 2),
                           decoder_hidden_size=256)


def segformer_b3(num_labels: int = 19) -> SegformerConfig:
    """nvidia/segformer-b3-* geometry (the reference's mask model)."""
    return SegformerConfig(num_labels=num_labels)


class _Conv(nn.Conv2d):
    """Conv2d on channels-last [B, H, W, C] input, its float32 weights cast
    to the input's dtype at use."""

    def init_own_params(self, generator: torch.Generator) -> None:
        trunc_normal_(self.weight, 0.02, generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        y = F.conv2d(x.permute(0, 3, 1, 2), self.weight.to(x.dtype), bias, self.stride, self.padding,
                     groups=self.groups)
        return y.permute(0, 2, 3, 1)


class _PatchEmbeddings(nn.Module):
    def __init__(self, c_in: int, c_out: int, patch: int, stride: int, eps: float, dtype: torch.dtype):
        super().__init__()
        self.proj = _Conv(c_in, c_out, patch, stride=stride, padding=patch // 2)
        self.layer_norm = FastLayerNorm(c_out, dtype, eps)


class _SelfAttention(nn.Module):
    """HF SegformerEfficientSelfAttention: K/V from the sr-reduced map."""

    def __init__(self, dim: int, heads: int, sr_ratio: int, eps: float, dtype: torch.dtype):
        super().__init__()
        self.heads = heads
        self.query, self.key, self.value = Linear(dim, dim), Linear(dim, dim), Linear(dim, dim)
        if sr_ratio > 1:
            self.sr = _Conv(dim, dim, sr_ratio, stride=sr_ratio)
            self.layer_norm = FastLayerNorm(dim, dtype, eps)

    def forward(self, x: torch.Tensor, H: int, W: int) -> torch.Tensor:
        B, N, C = x.shape
        hd = C // self.heads
        q = self.query(x)
        kv = x
        if hasattr(self, "sr"):
            kv = self.layer_norm(self.sr(x.reshape(B, H, W, C)).reshape(B, -1, C))
        k, v = self.key(kv), self.value(kv)
        M = kv.shape[1]
        q = q.reshape(B, N, self.heads, hd).transpose(1, 2)
        k = k.reshape(B, M, self.heads, hd).transpose(1, 2)
        v = v.reshape(B, M, self.heads, hd).transpose(1, 2)
        s = torch.matmul(q, k.transpose(-1, -2)) / torch.tensor(float(hd)).sqrt().to(q.dtype)
        a = torch.softmax(s.float(), dim=-1).to(s.dtype)
        return torch.matmul(a, v).transpose(1, 2).reshape(B, N, C)


class _SelfOutput(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.dense = Linear(dim, dim)


class _Attention(nn.Module):
    def __init__(self, dim: int, heads: int, sr_ratio: int, eps: float, dtype: torch.dtype):
        super().__init__()
        self.self = _SelfAttention(dim, heads, sr_ratio, eps, dtype)
        self.output = _SelfOutput(dim)

    def forward(self, x: torch.Tensor, H: int, W: int) -> torch.Tensor:
        return self.output.dense(self.self(x, H, W))


class _DWConv(nn.Module):
    def __init__(self, hidden: int):
        super().__init__()
        self.dwconv = _Conv(hidden, hidden, 3, padding=1, groups=hidden)


class _MixFFN(nn.Module):
    def __init__(self, dim: int, hidden: int, dtype: torch.dtype):
        super().__init__()
        self.dense1 = Linear(dim, hidden)
        self.dwconv = _DWConv(hidden)
        self.dense2 = Linear(hidden, dim)
        self.approx = dtype == torch.bfloat16

    def forward(self, x: torch.Tensor, H: int, W: int) -> torch.Tensor:
        B, N, _ = x.shape
        h = self.dense1(x)
        h = self.dwconv.dwconv(h.reshape(B, H, W, -1)).reshape(B, N, -1)
        return self.dense2(F.gelu(h, approximate="tanh" if self.approx else "none"))


class _Layer(nn.Module):
    def __init__(self, dim: int, heads: int, sr_ratio: int, mlp_ratio: int, eps: float, dtype: torch.dtype):
        super().__init__()
        self.layer_norm_1 = FastLayerNorm(dim, dtype, eps)
        self.attention = _Attention(dim, heads, sr_ratio, eps, dtype)
        self.layer_norm_2 = FastLayerNorm(dim, dtype, eps)
        self.mlp = _MixFFN(dim, dim * mlp_ratio, dtype)

    def forward(self, x: torch.Tensor, H: int, W: int) -> torch.Tensor:
        x = x + self.attention(self.layer_norm_1(x), H, W)
        return x + self.mlp(self.layer_norm_2(x), H, W)


class _Encoder(nn.Module):
    def __init__(self, cfg: SegformerConfig, dtype: torch.dtype):
        super().__init__()
        eps = cfg.layer_norm_eps
        c_in = (3,) + tuple(cfg.hidden_sizes[:-1])
        self.patch_embeddings = nn.ModuleList(
            _PatchEmbeddings(c_in[s], cfg.hidden_sizes[s], cfg.patch_sizes[s], cfg.strides[s], eps, dtype)
            for s in range(4))
        self.block = nn.ModuleList(
            nn.ModuleList(_Layer(cfg.hidden_sizes[s], cfg.num_heads[s], cfg.sr_ratios[s], cfg.mlp_ratio, eps, dtype)
                          for _ in range(cfg.depths[s]))
            for s in range(4))
        self.layer_norm = nn.ModuleList(FastLayerNorm(cfg.hidden_sizes[s], dtype, eps) for s in range(4))


class _Backbone(nn.Module):
    def __init__(self, cfg: SegformerConfig, dtype: torch.dtype):
        super().__init__()
        self.encoder = _Encoder(cfg, dtype)


class _MLP(nn.Module):
    def __init__(self, c_in: int, c_out: int):
        super().__init__()
        self.proj = Linear(c_in, c_out)


class FrozenBatchNorm(nn.Module):
    """BatchNorm with imported running statistics (inference only), under
    BatchNorm2d's names, computed as the JAX module computes it."""

    def __init__(self, features: int, eps: float):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.register_buffer("num_batches_tracked", torch.tensor(0, dtype=torch.long))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        root = torch.sqrt(self.running_var + self.eps)
        return x * (self.weight / root).to(x.dtype) + (self.bias - self.running_mean * self.weight / root).to(x.dtype)


class _DecodeHead(nn.Module):
    def __init__(self, cfg: SegformerConfig):
        super().__init__()
        D = cfg.decoder_hidden_size
        self.linear_c = nn.ModuleList(_MLP(cfg.hidden_sizes[s], D) for s in range(4))
        self.linear_fuse = _Conv(4 * D, D, 1, bias=False)
        self.batch_norm = FrozenBatchNorm(D, cfg.bn_eps)
        self.classifier = _Conv(D, cfg.num_labels, 1)

    def forward(self, feats) -> torch.Tensor:
        # fuse(concat(resize(p_s))) == sum_s resize(p_s @ W_s): a 1x1 conv
        # mixes channels per pixel and a bilinear resize mixes pixels per
        # channel, so they commute; each stage's block of the fuse kernel
        # runs on its own grid, as in the JAX module
        h0, w0 = feats[0].shape[1:3]
        D = self.linear_fuse.out_channels
        w_fuse = self.linear_fuse.weight[:, :, 0, 0]
        fused = None
        for s, f in enumerate(feats):
            q = F.linear(self.linear_c[s].proj(f), w_fuse[:, (3 - s) * D:(4 - s) * D].to(f.dtype))
            if q.shape[1:3] != (h0, w0):
                q = F.interpolate(q.permute(0, 3, 1, 2).float(), size=(h0, w0), mode="bilinear",
                                  align_corners=False, antialias=False).permute(0, 2, 3, 1).to(f.dtype)
            fused = q if fused is None else fused + q
        return self.classifier(torch.relu(self.batch_norm(fused)))


class Segformer(nn.Module):
    """Semantic segmentation: [B, H, W, 3] -> logits [B, H/4, W/4,
    num_labels] (channels-last; HF's quarter-resolution output before the
    engine's x4 upsample, ref engine_for_slot.py:112-113)."""

    def __init__(self, config: SegformerConfig = SegformerConfig(), dtype: torch.dtype = torch.float32):
        super().__init__()
        self.config = config
        self.dtype = dtype
        self.segformer = _Backbone(config, dtype)
        self.decode_head = _DecodeHead(config)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        enc = self.segformer.encoder
        x = x.to(self.dtype)
        feats = []
        for s in range(4):
            pe = enc.patch_embeddings[s]
            x = pe.proj(x)
            B, H, W, C = x.shape
            t = pe.layer_norm(x.reshape(B, H * W, C))
            for layer in enc.block[s]:
                t = layer(t, H, W)
            x = enc.layer_norm[s](t).reshape(B, H, W, C)
            feats.append(x)
        return self.decode_head(feats)


def create_segformer(config: SegformerConfig, device: DeviceLike = None, seed: int = 0,
                     dtype: torch.dtype = torch.float32) -> Segformer:
    """A Segformer with weights drawn from `seed` (normal(0, 0.02)
    truncated, zero biases, unit norms and BatchNorm statistics), frozen,
    in eval mode on `device` (`cuda` unless the caller asks for `cpu`)."""
    dev = resolve_device(device)
    model = Segformer(config, dtype)
    init_weights(model, torch.Generator().manual_seed(seed))
    return model.to(dev).eval().requires_grad_(False)


def person_masks(logits: torch.Tensor, out_hw: Tuple[int, int],
                 person_class: int = CITYSCAPES_PERSON_CLASS) -> torch.Tensor:
    """Quarter-res logits [B, H/4, W/4, L] -> boolean person mask [B, H, W]
    (ref engine_for_slot.py:112-114): the class maps upsampled bilinearly
    in float32 (align_corners=False, the half-pixel centres
    `jax.image.resize` uses; every resize here is an upsample, so no
    antialiasing), then the first argmax == person."""
    up = F.interpolate(logits.permute(0, 3, 1, 2).float(), size=tuple(out_hw), mode="bilinear",
                       align_corners=False, antialias=False)
    return up.argmax(dim=1) == person_class
