"""A plain float32 SegFormer (arXiv:2105.15203): the MiT encoder and the
all-MLP decode head, as HuggingFace's `SegformerForSemanticSegmentation`
lays them out, so the port's weights load by name
(`segformer.encoder.patch_embeddings.{s}.proj`,
`segformer.encoder.block.{s}.{i}.attention.self.query`, ...,
`decode_head.classifier`). Plain PyTorch in NCHW; nothing of the program.

Per stage: an overlapping patch embedding (a conv of kernel p, stride s,
padding p // 2) and a LayerNorm; blocks of efficient self-attention (K
and V from the map reduced by an sr x sr conv of stride sr and a
LayerNorm, where sr > 1) and a Mix-FFN (dense, 3 x 3 depthwise conv,
GELU, dense), each pre-normed with a residual; a closing LayerNorm. The
decode head projects each stage's map to the decoder's width, upsamples
each bilinearly to the first stage's grid (half-pixel centres), concatenates
them deepest first, fuses them with a 1 x 1 conv, then BatchNorm with its
running statistics, ReLU and the 1 x 1 classifier: HF's order.

Where it departs from HF's module, it follows what the configuration fixes
as the program computes it:
- every LayerNorm takes the configuration's `layer_norm_eps` (1e-6, the
  published config's value; HF's modules build theirs at torch's default
  1e-5) and the variance E[x^2] - E[x]^2 (`reference/model.py::LayerNorm`);
- the Mix-FFN's GELU is the tanh form where the compute type is bfloat16,
  the exact one otherwise;
- the input is channels-last [N, H, W, 3] and the logits come out
  channels-last [N, H/4, W/4, L], the program's layout;
- the program fuses each stage's block of `linear_fuse` on the stage's own
  grid before upsampling; upsampling then fusing is the same function in
  real arithmetic (a 1 x 1 conv mixes channels, a bilinear resize mixes
  pixels), and this module keeps HF's order.

`quant="fp8"` is the control of the correctness check: every dense and
conv product takes its input per pixel and its weight per output channel
rounded to float8 e4m3 (`reference/model.py::_fp8`); the attention
products and everything else stay float32.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from reference.model import LayerNorm, Linear, _fp8


class Conv(nn.Conv2d):
    """nn.Conv2d, with e4m3 operands under `quant`."""

    quant: Optional[str] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight
        if self.quant == "fp8":
            x = _fp8(x.permute(0, 2, 3, 1), torch.float8_e4m3fn).permute(0, 3, 1, 2)
            w = _fp8(w.reshape(w.shape[0], -1), torch.float8_e4m3fn).reshape(w.shape)
        elif self.quant is not None:
            raise ValueError(f"unknown quant {self.quant!r}")
        return self._conv_forward(x, w, self.bias)


def _tokens_ln(x: torch.Tensor, norm: LayerNorm) -> torch.Tensor:
    """LayerNorm over the channels of an NCHW map, returned as tokens [N, HW, C]."""
    return norm(x.flatten(2).transpose(1, 2))


class PatchEmbeddings(nn.Module):
    def __init__(self, c_in: int, c_out: int, patch: int, stride: int, eps: float):
        super().__init__()
        self.proj = Conv(c_in, c_out, patch, stride=stride, padding=patch // 2)
        self.layer_norm = LayerNorm(c_out, eps)

    def forward(self, x):
        x = self.proj(x)
        return _tokens_ln(x, self.layer_norm), x.shape[2], x.shape[3]


class SelfAttention(nn.Module):
    def __init__(self, dim: int, heads: int, sr: int, eps: float):
        super().__init__()
        self.heads = heads
        self.query, self.key, self.value = Linear(dim, dim), Linear(dim, dim), Linear(dim, dim)
        if sr > 1:
            self.sr = Conv(dim, dim, sr, stride=sr)
            self.layer_norm = LayerNorm(dim, eps)

    def forward(self, x, H: int, W: int):
        B, N, C = x.shape
        hd = C // self.heads
        kv = x
        if hasattr(self, "sr"):
            kv = _tokens_ln(self.sr(x.transpose(1, 2).reshape(B, C, H, W)), self.layer_norm)

        def heads(t):
            return t.reshape(B, -1, self.heads, hd).transpose(1, 2)

        q, k, v = heads(self.query(x)), heads(self.key(kv)), heads(self.value(kv))
        a = torch.softmax(q @ k.transpose(-1, -2) / hd ** 0.5, dim=-1)
        return (a @ v).transpose(1, 2).reshape(B, N, C)


class SelfOutput(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.dense = Linear(dim, dim)


class Attention(nn.Module):
    def __init__(self, dim: int, heads: int, sr: int, eps: float):
        super().__init__()
        self.self = SelfAttention(dim, heads, sr, eps)
        self.output = SelfOutput(dim)

    def forward(self, x, H: int, W: int):
        return self.output.dense(self.self(x, H, W))


class DWConv(nn.Module):
    def __init__(self, hidden: int):
        super().__init__()
        self.dwconv = Conv(hidden, hidden, 3, padding=1, groups=hidden)


class MixFFN(nn.Module):
    def __init__(self, dim: int, hidden: int, tanh_gelu: bool):
        super().__init__()
        self.dense1 = Linear(dim, hidden)
        self.dwconv = DWConv(hidden)
        self.dense2 = Linear(hidden, dim)
        self.approximate = "tanh" if tanh_gelu else "none"

    def forward(self, x, H: int, W: int):
        B, N, _ = x.shape
        h = self.dense1(x)
        h = self.dwconv.dwconv(h.transpose(1, 2).reshape(B, -1, H, W)).flatten(2).transpose(1, 2)
        return self.dense2(F.gelu(h, approximate=self.approximate))


class Layer(nn.Module):
    def __init__(self, dim: int, heads: int, sr: int, mlp_ratio: int, eps: float, tanh_gelu: bool):
        super().__init__()
        self.layer_norm_1 = LayerNorm(dim, eps)
        self.attention = Attention(dim, heads, sr, eps)
        self.layer_norm_2 = LayerNorm(dim, eps)
        self.mlp = MixFFN(dim, dim * mlp_ratio, tanh_gelu)

    def forward(self, x, H: int, W: int):
        x = x + self.attention(self.layer_norm_1(x), H, W)
        return x + self.mlp(self.layer_norm_2(x), H, W)


class Encoder(nn.Module):
    def __init__(self, m: dict):
        super().__init__()
        eps, sizes = m.get("layer_norm_eps", 1e-6), m["hidden_sizes"]
        tanh_gelu = m["dtype"] == "bfloat16"
        c_in = [3] + list(sizes[:-1])
        self.patch_embeddings = nn.ModuleList(
            PatchEmbeddings(c_in[s], sizes[s], m["patch_sizes"][s], m["strides"][s], eps) for s in range(4))
        self.block = nn.ModuleList(
            nn.ModuleList(Layer(sizes[s], m["num_heads"][s], m["sr_ratios"][s], m["mlp_ratio"], eps, tanh_gelu)
                          for _ in range(m["depths"][s]))
            for s in range(4))
        self.layer_norm = nn.ModuleList(LayerNorm(sizes[s], eps) for s in range(4))

    def forward(self, x) -> List[torch.Tensor]:
        feats = []
        for s in range(4):
            t, H, W = self.patch_embeddings[s](x)
            for layer in self.block[s]:
                t = layer(t, H, W)
            t = self.layer_norm[s](t)
            x = t.transpose(1, 2).reshape(t.shape[0], -1, H, W)
            feats.append(x)
        return feats


class Backbone(nn.Module):
    def __init__(self, m: dict):
        super().__init__()
        self.encoder = Encoder(m)


class MLP(nn.Module):
    def __init__(self, c_in: int, c_out: int):
        super().__init__()
        self.proj = Linear(c_in, c_out)


class DecodeHead(nn.Module):
    def __init__(self, m: dict):
        super().__init__()
        D = m["decoder_hidden_size"]
        self.linear_c = nn.ModuleList(MLP(c, D) for c in m["hidden_sizes"])
        self.linear_fuse = Conv(4 * D, D, 1, bias=False)
        self.batch_norm = nn.BatchNorm2d(D, eps=m.get("bn_eps", 1e-5))
        self.classifier = Conv(D, m["num_labels"], 1)

    def forward(self, feats: List[torch.Tensor]) -> torch.Tensor:
        size = feats[0].shape[2:]
        maps = []
        for f, mlp in zip(feats, self.linear_c):
            B, _, H, W = f.shape
            x = mlp.proj(f.flatten(2).transpose(1, 2)).transpose(1, 2).reshape(B, -1, H, W)
            maps.append(F.interpolate(x, size=size, mode="bilinear", align_corners=False))
        x = self.linear_fuse(torch.cat(maps[::-1], dim=1))
        return self.classifier(torch.relu(self.batch_norm(x)))


class Segformer(nn.Module):
    """Frames [N, H, W, 3] -> logits [N, H/4, W/4, num_labels], in float32."""

    def __init__(self, m: dict):
        super().__init__()
        self.segformer = Backbone(m)
        self.decode_head = DecodeHead(m)
        self.eval()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        logits = self.decode_head(self.segformer.encoder(x.permute(0, 3, 1, 2)))
        return logits.permute(0, 2, 3, 1)


def set_quant(model: nn.Module, quant: Optional[str]) -> None:
    for mod in model.modules():
        if isinstance(mod, (Conv, Linear)):
            mod.quant = quant


def person_margin(logits: torch.Tensor, out_hw, person: int) -> torch.Tensor:
    """Quarter-res logits [N, h, w, L] upsampled bilinearly in float32 to
    `out_hw` (half-pixel centres), then per pixel the person class's logit
    less the best other class's [N, H, W]: above 0 where the pixel's mask
    is person."""
    up = F.interpolate(logits.permute(0, 3, 1, 2).float(), size=tuple(out_hw), mode="bilinear", align_corners=False)
    others = torch.cat([up[:, :person], up[:, person + 1:]], dim=1).amax(dim=1)
    return up[:, person] - others
