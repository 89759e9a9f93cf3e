"""VideoMAE-style video ViT backbone (port of `devias_tpu/nn/vit.py`).

Channels-last clips [B, T, H, W, C] in, tokens [B, N, D] out. Parameters
are float32 and cast to the compute dtype where they are used, as the JAX
package does; LayerNorm scales and biases stay float32. The module tree
follows the reference key layout (`patch_embed.proj.weight`,
`blocks.{i}.attn.qkv.weight`, ...), so `load_state_dict(strict=True)`
takes what `ckpt/from_jax.py` produces.

Training mode (`module.train()`) enables dropout after the position
embedding, on the attention probabilities, after `proj` and after `fc2`,
and drop-path in timm semantics (a per-sample Bernoulli keep scaled by
1/keep, rates rising linearly over the blocks). Dropout draws from the
`torch.Generator` passed to `forward`, drop-path from `path_generator`
when one is given (sequence parallelism shares it across token shards)
and from the same generator otherwise; in `eval()` or at rate 0 they are
no-ops. `remat` recomputes each block's activations in the backward
(`torch.utils.checkpoint`) with the same draws; `int8_dense` runs the
blocks' four dense layers as w8a8 int8 products (`nn/quant.py`, frozen
inference only). Given `seq` (a
`core/dist.py::SPMesh`), the backbone runs sequence-parallel on this
rank's frames: attention gathers K/V over the seq group
(`devias_tpu/nn/vit.py:225-249`). Gradients reach the float32 master
weights through the casts at use; `FastLayerNorm`'s gradient is
autograd's of its forward, the same function as the JAX package's
hand-written VJP (which exists to save TPU memory).
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from devias_tpu_torch.core.dist import SPMesh, gather_kv
from devias_tpu_torch.kernels.attention import (
    attention_q_kv_reference,
    attention_qkv_reference,
    fused_attention_q_kv,
    fused_attention_qkv,
)
from devias_tpu_torch.nn.quant import int8_dot_quantized, quantize

PATCH_SIZE = 16
NORM_EPS = 1e-6
MLP_RATIO = 4
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
PATCH_EMBED_MODES = ("conv", "patchify", "dot")
# the VideoViT's own top-level modules; a model built on it adds others
BACKBONE_MODULES = ("patch_embed", "cls_token", "scene_token", "pos_embed", "blocks", "norm")


def sinusoid_position_table(n_position: int, d_hid: int) -> np.ndarray:
    """Fixed sine/cosine table: angle[p, j] = p / 10000^(2(j//2)/d), sin on
    even dims and cos on odd ones."""
    pos = np.arange(n_position, dtype=np.float64)[:, None]
    j = np.arange(d_hid, dtype=np.float64)[None, :]
    angle = pos / np.power(10000.0, 2.0 * (j // 2) / d_hid)
    table = np.zeros((n_position, d_hid), dtype=np.float64)
    table[:, 0::2] = np.sin(angle[:, 0::2])
    table[:, 1::2] = np.cos(angle[:, 1::2])
    return table.astype(np.float32)


def trunc_normal_(t: torch.Tensor, std: float, generator: torch.Generator) -> None:
    """Normal(0, std) truncated at two standard deviations; zeros at std 0."""
    with torch.no_grad():
        if std == 0.0:
            t.zero_()
        else:
            nn.init.trunc_normal_(t, std=std, a=-2.0 * std, b=2.0 * std, generator=generator)


def _keep_mask(shape, keep: float, generator: Optional[torch.Generator], device) -> torch.Tensor:
    if generator is None:
        raise ValueError("dropout and drop-path in training mode need a torch.Generator")
    return torch.rand(shape, generator=generator, device=device) < keep


def dropout(x: torch.Tensor, rate: float, training: bool, generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax `nn.Dropout`: keep each element with probability 1 - rate and
    scale kept ones by 1/(1 - rate); identity in eval or at rate 0."""
    if not training or rate == 0.0:
        return x
    keep = 1.0 - rate
    return torch.where(_keep_mask(x.shape, keep, generator, x.device), x / keep, torch.zeros_like(x))


def drop_path(x: torch.Tensor, rate: float, training: bool, generator: Optional[torch.Generator]) -> torch.Tensor:
    """Per-sample stochastic depth (`devias_tpu/nn/vit.py:46-58`, timm
    semantics): keep a whole sample with probability 1 - rate, scaled by
    1/(1 - rate); identity in eval or at rate 0."""
    if not training or rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = _keep_mask((x.shape[0],) + (1,) * (x.dim() - 1), keep, generator, x.device)
    return torch.where(mask, x / keep, torch.zeros_like(x))


def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """Initialise every parameter of `module` from `generator`: each
    submodule with an `init_own_params(generator)` sets its direct
    parameters."""
    for m in module.modules():
        own = getattr(m, "init_own_params", None)
        if own is not None:
            own(generator)


class Linear(nn.Linear):
    """nn.Linear whose float32 weights are cast to the input's dtype at use
    (flax `nn.Dense(dtype=...)` semantics). `init_std` is the truncated
    normal's std; biases start at zero. `int8_dense` computes the product
    with `int8_dot_quantized` and adds the bias in float32 before the cast
    to the input's dtype (`devias_tpu/nn/quant.py::Int8Dense`). That
    weight is frozen, so it is quantised once, and again only when its
    storage or version changes (a load, a move, an in-place update); JAX
    quantises it in every call, to the same values."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True, init_std: float = 0.02,
                 int8_dense: bool = False):
        super().__init__(in_features, out_features, bias=bias)
        self.init_std = init_std
        self.int8_dense = int8_dense
        self._int8_weight = None  # (the weight it came from, that weight's version, (wq, sw))

    def init_own_params(self, generator: torch.Generator) -> None:
        trunc_normal_(self.weight, self.init_std, generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def _quantized_weight(self) -> Tuple[torch.Tensor, torch.Tensor]:
        # the detached weight shares the parameter's storage and version
        # counter; holding it keeps that storage from being reused
        w = self.weight.detach()
        held = self._int8_weight
        if held is None or held[0].data_ptr() != w.data_ptr() or held[1] != w._version:
            held = self._int8_weight = (w, w._version, quantize(w.float(), 1))
        return held[2]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.int8_dense:
            y = int8_dot_quantized(x, *self._quantized_weight())
            return (y if self.bias is None else y.add_(self.bias)).to(x.dtype)
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), bias)


class FastLayerNorm(nn.Module):
    """LayerNorm with float32 statistics in the fast-variance form
    E[x^2] - E[x]^2 and float32 scale/bias, output in the compute dtype
    (`devias_tpu/nn/vit.py:89-138`, forward only)."""

    def __init__(self, dim: int, dtype: torch.dtype = torch.float32, eps: float = NORM_EPS):
        super().__init__()
        self.dtype = dtype
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def init_own_params(self, generator: torch.Generator) -> None:
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.to(self.dtype).float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = (xf * xf).mean(dim=-1, keepdim=True) - mean * mean
        y = (xf - mean) * torch.rsqrt(var + self.eps) * self.weight + self.bias
        return y.to(self.dtype)


class Mlp(nn.Module):
    """fc1 -> GELU -> fc2 -> dropout. GELU is the tanh form when compute is
    bf16 and exact erf otherwise; `gelu_approx` True/False overrides."""

    def __init__(self, dim: int, hidden_dim: int, gelu_approx: Optional[bool] = None,
                 dtype: torch.dtype = torch.float32, drop: float = 0.0, int8_dense: bool = False):
        super().__init__()
        self.drop = drop
        self.fc1 = Linear(dim, hidden_dim, int8_dense=int8_dense)
        self.fc2 = Linear(hidden_dim, dim, int8_dense=int8_dense)
        self.approx = dtype == torch.bfloat16 if gelu_approx is None else gelu_approx
        self.dtype = dtype

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = self.fc1(x.to(self.dtype))
        x = F.gelu(x, approximate="tanh" if self.approx else "none")
        return dropout(self.fc2(x), self.drop, self.training, generator)


def _attention_with_dropout(qkv: torch.Tensor, num_heads: int, scale: float, rate: float,
                            generator: Optional[torch.Generator]) -> torch.Tensor:
    """The JAX package's unfused training attention with probability
    dropout (`devias_tpu/nn/vit.py:261-266`): q scaled, q k^T and the
    softmax's input in qkv's dtype, the softmax in float32 cast back,
    dropout on the probabilities, then the product with v."""
    B, N, C3 = qkv.shape
    q, k, v = qkv.reshape(B, N, 3, num_heads, C3 // (3 * num_heads)).unbind(2)
    attn = torch.einsum("bnhd,bmhd->bhnm", q * scale, k)
    attn = dropout(attn.float().softmax(dim=-1).to(qkv.dtype), rate, True, generator)
    return torch.einsum("bhnm,bmhd->bnhd", attn, v).reshape(B, N, C3 // 3)


class Attention(nn.Module):
    """Multi-head self-attention with one qkv weight, learnable q and v
    biases and a zero k bias. `fused=True` calls K1 on the [B, N, 3C]
    projection with no head transposes; otherwise the plain einsum path.
    Given `seq`, q stays local and k | v is gathered over the seq group:
    K2 when fused, the plain einsum against the gathered kv otherwise.
    In training with `attn_drop > 0` the attention is the plain one with
    dropout on its probabilities, the JAX package's own dispatch (its
    kernel takes only `attn_drop == 0`); in eval, where that dropout is
    the identity, K1 stays on when fused. Under sequence parallelism any
    rate > 0 raises, as in the JAX package."""

    def __init__(self, dim: int, num_heads: int, fused: bool = False, dtype: torch.dtype = torch.float32,
                 attn_drop: float = 0.0, proj_drop: float = 0.0, int8_dense: bool = False):
        super().__init__()
        self.attn_drop = attn_drop
        self.proj_drop = proj_drop
        self.num_heads = num_heads
        self.scale = (dim // num_heads) ** -0.5
        self.fused = fused
        self.dtype = dtype
        self.qkv = Linear(dim, 3 * dim, bias=False, int8_dense=int8_dense)
        self.q_bias = nn.Parameter(torch.zeros(dim))
        self.v_bias = nn.Parameter(torch.zeros(dim))
        self.proj = Linear(dim, dim, int8_dense=int8_dense)

    def init_own_params(self, generator: torch.Generator) -> None:
        nn.init.zeros_(self.q_bias)
        nn.init.zeros_(self.v_bias)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
                seq: Optional[SPMesh] = None) -> torch.Tensor:
        bias = torch.cat([self.q_bias, torch.zeros_like(self.q_bias), self.v_bias])
        qkv = self.qkv(x.to(self.dtype)) + bias.to(self.dtype)
        if seq is not None:
            if self.attn_drop > 0.0:
                raise NotImplementedError("attn_drop > 0 under sequence parallelism")
            C = qkv.shape[-1] // 3
            attend = fused_attention_q_kv if self.fused else attention_q_kv_reference
            out = attend(qkv[..., :C].contiguous(), gather_kv(qkv[..., C:], seq), self.num_heads, self.scale)
            return dropout(self.proj(out), self.proj_drop, self.training, generator)
        if self.training and self.attn_drop > 0.0:
            out = _attention_with_dropout(qkv, self.num_heads, self.scale, self.attn_drop, generator)
        else:
            attend = fused_attention_qkv if self.fused else attention_qkv_reference
            out = attend(qkv, self.num_heads, self.scale)
        return dropout(self.proj(out), self.proj_drop, self.training, generator)


class Block(nn.Module):
    """Pre-norm transformer block."""

    def __init__(self, dim: int, num_heads: int, fused_attention: bool = False, exact_gelu: bool = False,
                 dtype: torch.dtype = torch.float32, drop: float = 0.0, attn_drop: float = 0.0,
                 drop_path_rate: float = 0.0, int8_dense: bool = False):
        super().__init__()
        self.drop_path_rate = drop_path_rate
        self.norm1 = FastLayerNorm(dim, dtype)
        self.attn = Attention(dim, num_heads, fused_attention, dtype, attn_drop, drop, int8_dense)
        self.norm2 = FastLayerNorm(dim, dtype)
        self.mlp = Mlp(dim, MLP_RATIO * dim, False if exact_gelu else None, dtype, drop, int8_dense)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
                path_generator: Optional[torch.Generator] = None, seq: Optional[SPMesh] = None) -> torch.Tensor:
        path_generator = generator if path_generator is None else path_generator
        y = self.attn(self.norm1(x), generator, seq)
        x = x + drop_path(y, self.drop_path_rate, self.training, path_generator)
        y = self.mlp(self.norm2(x), generator)
        return x + drop_path(y, self.drop_path_rate, self.training, path_generator)


class _ReplayGenerators:
    """The context of a checkpointed block's recompute: on entry each
    generator is set to its state from before the block's forward, on exit
    it gets back the state it had on entry. Reusable, for a second
    backward."""

    def __init__(self, gens, states):
        self.gens, self.states = gens, states

    def __enter__(self):
        self.now = [g.get_state() for g in self.gens]
        for g, state in zip(self.gens, self.states):
            g.set_state(state)

    def __exit__(self, *exc):
        for g, state in zip(self.gens, self.now):
            g.set_state(state)


def checkpointed_block(block: Block, x: torch.Tensor, generator: Optional[torch.Generator],
                       path_generator: Optional[torch.Generator], seq: Optional[SPMesh]) -> torch.Tensor:
    """`block(x, ...)` under `torch.utils.checkpoint` (non-reentrant): the
    block's activations are dropped after the forward and recomputed in the
    backward, the JAX package's `nn.remat` of each block
    (`devias_tpu/nn/vit.py:556-560`).

    The block draws dropout and drop-path from explicit generators, whose
    states `preserve_rng_state` does not save. So each generator's state is
    taken here, before the forward, and the recompute runs under
    `_ReplayGenerators`: it draws the forward's masks, and later draws are
    where they would be without checkpointing (as remat replays the same
    keys). Its exit also runs when autograd stops a recompute early."""
    gens = list({id(g): g for g in (generator, path_generator) if g is not None}.values())
    replay = _ReplayGenerators(gens, [g.get_state() for g in gens])
    return torch.utils.checkpoint.checkpoint(block, x, generator, path_generator, seq, use_reentrant=False,
                                             preserve_rng_state=False,
                                             context_fn=lambda: (contextlib.nullcontext(), replay))


def patchify_video(x: torch.Tensor, tubelet: int = 2, patch: int = PATCH_SIZE) -> torch.Tensor:
    """[B, T, H, W, C] -> [B, t*h*w, tubelet*p*p*C], patches flattened in
    (t, ph, pw, c) order and tokens in (t, h, w) order."""
    B, T, H, W, C = x.shape
    if H % patch or W % patch or T % tubelet:
        raise ValueError(f"input {tuple(x.shape)} not divisible by patch {tubelet}x{patch}x{patch}")
    t, h, w = T // tubelet, H // patch, W // patch
    x = x.reshape(B, t, tubelet, h, patch, w, patch, C).permute(0, 1, 3, 5, 2, 4, 6, 7)
    return x.reshape(B, t * h * w, tubelet * patch * patch * C)


class _Conv3dParams(nn.Module):
    """Holds the tubelet embedding in the reference's Conv3d layout
    [D, 3, tubelet, p, p] (key `patch_embed.proj.weight`); never run as a
    convolution."""

    def __init__(self, embed_dim: int, tubelet: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(embed_dim, 3, tubelet, PATCH_SIZE, PATCH_SIZE))
        self.bias = nn.Parameter(torch.zeros(embed_dim))

    def init_own_params(self, generator: torch.Generator) -> None:
        fan_in = self.weight[0].numel()
        trunc_normal_(self.weight, fan_in ** -0.5, generator)
        nn.init.zeros_(self.bias)


class PatchEmbed3D(nn.Module):
    """Tubelet patch embedding as patchify + one matmul. The JAX package's
    `conv`, `patchify` and `dot` modes are the same linear map, so every
    mode runs this one (a cuDNN Conv3d would run in TF32 by default)."""

    def __init__(self, embed_dim: int = 768, tubelet_size: int = 2, mode: Optional[str] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if mode is not None and mode not in PATCH_EMBED_MODES:
            raise ValueError(f"unknown patch-embed mode {mode!r}; have {PATCH_EMBED_MODES}")
        self.tubelet_size = tubelet_size
        self.dtype = dtype
        self.proj = _Conv3dParams(embed_dim, tubelet_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        patches = patchify_video(x.to(self.dtype), self.tubelet_size)
        w = self.proj.weight  # [D, C, t, p, p] -> [t*p*p*C, D] in (t, ph, pw, c) order
        kernel = w.permute(2, 3, 4, 1, 0).reshape(-1, w.shape[0]).to(self.dtype)
        return patches @ kernel + self.proj.bias.to(self.dtype)


class VideoViT(nn.Module):
    """ViT video backbone on 16x16 patches: patch embed, positions, `depth`
    blocks, final LayerNorm (skipped when `final_norm=False`).
    `use_cls_token` prepends a learned CLS token and
    `num_extra_suffix_tokens` appends learned tokens (`scene_token`, the
    multi-task scene token), both before the positions are added
    (`devias_tpu/nn/vit.py:533-551`). The positions are the fixed sinusoid
    table over all tokens, or with `use_learnable_pos_emb` a `pos_embed`
    parameter [1, n_tokens, D] for clips of `num_frames` x `img_size`^2.
    `input_norm` applies the ImageNet normalisation on the device (uint8 or
    [0, 1] clips). Block i's drop-path rate is linspace(0, drop_path_rate,
    depth)[i]; `drop_rate` also applies after the position embedding.
    `remat` (each block checkpointed while grad is enabled,
    `checkpointed_block`) and `int8_dense` (frozen inference) are the JAX
    fields of the same names.
    `forward_features(..., seq=mesh)` is the sequence-parallel backbone:
    this rank's frames, this rank's slice of the full sinusoid table, the
    final norm on the local tokens (`core/dist.py::seq_parallel_tokens`
    drives it and gathers the tokens); it has no form with extra tokens or
    learned positions, as in the JAX package."""

    def __init__(self, embed_dim: int = 768, depth: int = 12, num_heads: int = 12,
                 drop_rate: float = 0.0, attn_drop_rate: float = 0.0, drop_path_rate: float = 0.0,
                 tubelet_size: int = 2, use_cls_token: bool = False, num_extra_suffix_tokens: int = 0,
                 use_learnable_pos_emb: bool = False, img_size: int = 224, num_frames: int = 16,
                 final_norm: bool = True, fused_attention: bool = False, exact_gelu: bool = False,
                 patch_embed_mode: Optional[str] = None, input_norm: bool = False, remat: bool = False,
                 int8_dense: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.embed_dim = embed_dim
        self.remat = remat
        self.input_norm = input_norm
        self.dtype = dtype
        self.drop_rate = drop_rate
        self.patch_embed = PatchEmbed3D(embed_dim, tubelet_size, patch_embed_mode, dtype)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim)) if use_cls_token else None
        self.scene_token = (nn.Parameter(torch.zeros(1, num_extra_suffix_tokens, embed_dim))
                            if num_extra_suffix_tokens else None)
        n_tokens = (num_frames // tubelet_size) * (img_size // PATCH_SIZE) ** 2 + int(use_cls_token) \
            + num_extra_suffix_tokens
        self.pos_embed = nn.Parameter(torch.zeros(1, n_tokens, embed_dim)) if use_learnable_pos_emb else None
        dpr = np.linspace(0.0, drop_path_rate, depth)
        self.blocks = nn.ModuleList([
            Block(embed_dim, num_heads, fused_attention, exact_gelu, dtype, drop_rate, attn_drop_rate, float(dpr[i]),
                  int8_dense)
            for i in range(depth)])
        self.norm = FastLayerNorm(embed_dim, dtype) if final_norm else None
        self._pos_cache: Dict[Tuple[int, torch.device], torch.Tensor] = {}

    def init_own_params(self, generator: torch.Generator) -> None:
        for p in (self.cls_token, self.scene_token, self.pos_embed):
            if p is not None:
                trunc_normal_(p, 0.02, generator)

    def _pos(self, n: int, device: torch.device) -> torch.Tensor:
        key = (n, device)
        if key not in self._pos_cache:
            table = sinusoid_position_table(n, self.embed_dim)
            self._pos_cache[key] = torch.from_numpy(table).to(device=device, dtype=self.dtype)
        return self._pos_cache[key]

    def backbone_parameters(self):
        """The backbone's parameters (patch embed, extra tokens, positions,
        blocks, final norm), without what a subclass adds on top."""
        return [p for name, p in self.named_parameters() if name.split(".", 1)[0] in BACKBONE_MODULES]

    def forward_features(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
                         seq: Optional[SPMesh] = None,
                         path_generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if self.input_norm:
            if x.dtype == torch.uint8:
                x = x.to(self.dtype) / 255.0
            mean = torch.tensor(IMAGENET_MEAN, dtype=self.dtype, device=x.device)
            std = torch.tensor(IMAGENET_STD, dtype=self.dtype, device=x.device)
            x = (x - mean) / std
        x = self.patch_embed(x)
        if seq is not None:
            if self.cls_token is not None or self.scene_token is not None:
                raise NotImplementedError("sequence parallelism with a CLS or suffix token")
            if self.pos_embed is not None:
                raise NotImplementedError("a learnable pos-embed under sequence parallelism")
            n = x.shape[1]
            pos = self._pos(n * seq.seq_size, x.device)[seq.seq_rank * n:(seq.seq_rank + 1) * n][None]
        else:
            B = x.shape[0]
            if self.cls_token is not None:
                x = torch.cat([self.cls_token.to(self.dtype).expand(B, -1, -1), x], dim=1)
            if self.scene_token is not None:
                x = torch.cat([x, self.scene_token.to(self.dtype).expand(B, -1, -1)], dim=1)
            if self.pos_embed is not None:
                if self.pos_embed.shape[1] != x.shape[1]:
                    raise ValueError(f"pos_embed holds {self.pos_embed.shape[1]} tokens; the clips give {x.shape[1]}")
                pos = self.pos_embed.to(self.dtype)
            else:
                pos = self._pos(x.shape[1], x.device)[None]
        x = dropout(x + pos, self.drop_rate, self.training, generator)
        remat = self.remat and torch.is_grad_enabled()
        for blk in self.blocks:
            if remat:
                x = checkpointed_block(blk, x, generator, path_generator, seq)
            else:
                x = blk(x, generator, path_generator, seq)
        if self.norm is not None:
            x = self.norm(x)
        return x

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.forward_features(x, generator)
