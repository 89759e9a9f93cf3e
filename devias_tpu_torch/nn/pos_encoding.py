"""Position encodings for the aggregation block's context (port of
`devias_tpu/nn/pos_encoding.py`).

`sine_1d` and `sine_2d` build the fixed tables in numpy float64 and round
them to float32 once, as the JAX package does, so both packages give the
same bits. `Learned1D` and `Learned2D` hold learned tables drawn U(0, 1)
(`init_own_params`, from an explicit generator). `build_position_encoding`
is what `nn/agg.py`'s `pos_enc_type` reaches: 'none' gives None, 'sine1d'
the 1-D table over the context's tokens, 'sine2d' the 2-D table over a
patch grid `hw`. Every published DEVIAS configuration uses 'none'.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn


def sine_1d(n: int, dim: int, temperature: float = 10000.0, normalize: bool = True,
            scale: Optional[float] = None) -> np.ndarray:
    """[n, dim] float32: positions 1..n (normalised to (0, scale] by
    default), sin on the even channels and cos on the odd ones."""
    scale = scale if scale is not None else 2 * math.pi
    pos = np.arange(1, n + 1, dtype=np.float64)
    if normalize:
        pos = pos / (pos[-1] + 1e-6) * scale
    dim_t = temperature ** (2 * (np.arange(dim, dtype=np.float64) // 2) / dim)
    x = pos[:, None] / dim_t[None, :]
    out = np.empty((n, dim))
    out[:, 0::2] = np.sin(x[:, 0::2])
    out[:, 1::2] = np.cos(x[:, 1::2])
    return out.astype(np.float32)


def _interleave(p: np.ndarray) -> np.ndarray:
    out = np.empty_like(p)
    out[..., 0::2] = np.sin(p[..., 0::2])
    out[..., 1::2] = np.cos(p[..., 1::2])
    return out


def sine_2d(h: int, w: int, dim: int, temperature: float = 10000.0, normalize: bool = True,
            scale: Optional[float] = None) -> np.ndarray:
    """[h*w, dim] float32: the first half of the channels encodes the row,
    the second half the column, each as `sine_1d`'s interleave."""
    if dim % 2:
        raise ValueError(f"sine_2d needs an even dim; got {dim}")
    half = dim // 2
    scale = scale if scale is not None else 2 * math.pi
    ys = np.arange(1, h + 1, dtype=np.float64)[:, None] * np.ones((1, w))
    xs = np.ones((h, 1)) * np.arange(1, w + 1, dtype=np.float64)[None, :]
    if normalize:
        ys = ys / (ys[-1:, :] + 1e-6) * scale
        xs = xs / (xs[:, -1:] + 1e-6) * scale
    dim_t = temperature ** (2 * (np.arange(half, dtype=np.float64) // 2) / half)
    emb = np.concatenate([_interleave(ys[:, :, None] / dim_t), _interleave(xs[:, :, None] / dim_t)], axis=-1)
    return emb.reshape(h * w, dim).astype(np.float32)


class Learned1D(nn.Module):
    """A learned embedding per position: `embed` [max_len, dim]; forward(n)
    gives its first n rows."""

    def __init__(self, dim: int, max_len: int = 2048):
        super().__init__()
        self.embed = nn.Parameter(torch.empty(max_len, dim))

    def init_own_params(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.embed.uniform_(0.0, 1.0, generator=generator)

    def forward(self, n: int) -> torch.Tensor:
        return self.embed[:n]


class Learned2D(nn.Module):
    """Learned row and column embeddings, `row_embed` and `col_embed`
    [max_hw, dim/2]; forward(h, w) gives [h*w, dim], the column's half
    first, as the reference concatenates them."""

    def __init__(self, dim: int, max_hw: int = 64):
        super().__init__()
        self.row_embed = nn.Parameter(torch.empty(max_hw, dim // 2))
        self.col_embed = nn.Parameter(torch.empty(max_hw, dim // 2))

    def init_own_params(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.row_embed.uniform_(0.0, 1.0, generator=generator)
            self.col_embed.uniform_(0.0, 1.0, generator=generator)

    def forward(self, h: int, w: int) -> torch.Tensor:
        half = self.col_embed.shape[1]
        cols = self.col_embed[:w][None].expand(h, w, half)
        rows = self.row_embed[:h][:, None].expand(h, w, half)
        return torch.cat([cols, rows], dim=-1).reshape(h * w, 2 * half)


def build_position_encoding(pos_enc_type: Optional[str], n: int, dim: int, hw: Optional[Tuple[int, int]] = None,
                            device=None, dtype: torch.dtype = torch.float32) -> Optional[torch.Tensor]:
    """'none' (or '' or None) -> None; 'sine1d' -> `sine_1d(n, dim)`;
    'sine2d' -> `sine_2d(*hw, dim)`, which needs `hw`; as a tensor on
    `device` in `dtype`. Raises on any other type, and on 'sine2d' without
    `hw`, as the JAX function does."""
    if pos_enc_type in ("none", "", None):
        return None
    if pos_enc_type == "sine1d":
        table = sine_1d(n, dim)
    elif pos_enc_type == "sine2d":
        if hw is None:
            raise ValueError("pos_enc_type 'sine2d' needs the patch grid hw")
        table = sine_2d(hw[0], hw[1], dim)
    else:
        raise ValueError(f"unknown pos_enc_type {pos_enc_type}")
    return torch.from_numpy(table).to(device=device, dtype=dtype)
