"""K4: the fused slot cross-attention round (port of
`devias_tpu/kernels/slot_attention.py`).

`fused_slot_attention(x, ctx, wq, wk, wv, wo, bo, heads, dim_head)` returns
(out [B, S, D], sim [B, heads, S, N]): per head q = x wq_h, k = ctx wk_h,
v = ctx wv_h; the softmax over the slot axis for each key (`sim`, float32,
the map before the key renormalisation); o_h = (sim v) / (sim summed over
keys + 1e-7); out = sum_h o_h wo_h + bo. Weights are in the flax Dense
layout [in, out]. On a CUDA tensor the forward is the hand-written kernel
(`csrc/slot_attention.cu`: bf16 operands, f32 products and softmax); on a
CPU tensor it is `slot_attention_reference`. Either way the backward is
autograd of `slot_attention_reference` on the saved inputs, as the JAX
package's `_fsa_bwd` replays its XLA formulation: the TPU kernel has no
backward kernel, so the port has none. `fused_slot_attention.launches`
counts kernel calls (four launches each: q projection, the per-tile pass,
the reduction over tiles and the output projection).

Not on a path of the port or of the JAX package: `AggregationBlock` runs
its own formulation (`nn/agg.py`), as the JAX block ignores its `fused`
flag (`devias_tpu/nn/agg.py:558-560`).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from devias_tpu_torch.kernels import _build

MAX_SLOTS = 8
MAX_DIM = 1024


def slot_attention_reference(x: torch.Tensor, ctx: torch.Tensor, wq: torch.Tensor, wk: torch.Tensor,
                             wv: torch.Tensor, wo: torch.Tensor, bo: torch.Tensor, heads: int = 4,
                             dim_head: int = 512) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain K4 (`slot_attention_reference`, `slot_attention.py:33-46`):
    projections and products in the input dtype, the slot softmax in f32,
    the renormalised map cast back to x's dtype before its product with v.
    Returns (out [B, S, D], sim [B, heads, S, N] f32)."""
    B, S, _ = x.shape
    N = ctx.shape[1]
    scale = dim_head ** -0.5
    q = (x @ wq).reshape(B, S, heads, dim_head)
    k = (ctx @ wk).reshape(B, N, heads, dim_head)
    v = (ctx @ wv).reshape(B, N, heads, dim_head)
    sim = torch.einsum("bshd,bnhd->bhsn", q, k) * scale
    attn = sim.float().softmax(dim=2)
    sim_distill = attn
    attn = (attn / (attn.sum(dim=-1, keepdim=True) + 1e-7)).to(x.dtype)
    out = torch.einsum("bhsn,bnhd->bshd", attn, v).reshape(B, S, heads * dim_head)
    return out @ wo + bo, sim_distill


def _check(x, ctx, wq, wk, wv, wo, bo, heads: int, dim_head: int) -> None:
    if x.dim() != 3 or ctx.dim() != 3 or ctx.shape[0] != x.shape[0] or ctx.shape[2] != x.shape[2]:
        raise ValueError(f"x must be [B, S, D] and ctx [B, N, D]; got {tuple(x.shape)} and {tuple(ctx.shape)}")
    D, inner = x.shape[2], heads * dim_head
    for name, t, shape in (("wq", wq, (D, inner)), ("wk", wk, (D, inner)), ("wv", wv, (D, inner)),
                           ("wo", wo, (inner, D)), ("bo", bo, (D,))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape} for D={D}, heads={heads}, dim_head={dim_head}; "
                             f"got {tuple(t.shape)}")
    devices = {t.device.type for t in (x, ctx, wq, wk, wv, wo, bo)}
    if len(devices) != 1 or not devices <= {"cpu", "cuda"}:
        raise ValueError(f"no slot-attention path for tensors on {sorted(devices)}")


def _launch(x, ctx, wq, wk, wv, wo, bo, heads: int, dim_head: int) -> Tuple[torch.Tensor, torch.Tensor]:
    B, S, D = x.shape
    N = ctx.shape[1]
    if not 1 <= S <= MAX_SLOTS or D % 64 or D > MAX_DIM or dim_head % 64 or N < 1:
        raise ValueError(f"the K4 kernel takes 1 <= S <= {MAX_SLOTS}, D a multiple of 64 up to {MAX_DIM} and "
                         f"dim_head a multiple of 64; got S={S}, D={D}, dim_head={dim_head}, N={N}")
    for name, t in (("x", x), ("ctx", ctx), ("wq", wq), ("wk", wk), ("wv", wv), ("wo", wo), ("bo", bo)):
        if t.dtype != torch.bfloat16:
            raise ValueError(f"the K4 kernel takes {name} as torch.bfloat16; got {t.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"the K4 kernel takes a contiguous, 16-byte aligned {name}")
    inner = heads * dim_head
    n_tiles = -(-N // 64)
    dev = x.device
    q_ws = torch.empty((B, S, inner), dtype=torch.float32, device=dev)
    num_ws = torch.empty((B, heads, n_tiles, S, dim_head), dtype=torch.float32, device=dev)
    den_ws = torch.empty((B, heads, n_tiles, S), dtype=torch.float32, device=dev)
    o_ws = torch.empty((B, S, inner), dtype=torch.bfloat16, device=dev)
    out = torch.empty_like(x)
    sim = torch.empty((B, heads, S, N), dtype=torch.float32, device=dev)
    fn = _build.load("slot_attention").devias_slot_attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        rc = fn(x.data_ptr(), ctx.data_ptr(), wq.data_ptr(), wk.data_ptr(), wv.data_ptr(), wo.data_ptr(),
                bo.data_ptr(), q_ws.data_ptr(), num_ws.data_ptr(), den_ws.data_ptr(), o_ws.data_ptr(),
                out.data_ptr(), sim.data_ptr(), B, S, N, D, heads, dim_head, float(dim_head ** -0.5),
                torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"slot-attention kernel launch failed with CUDA error {rc}")
    fused_slot_attention.launches += 1
    return out, sim


class _FusedSlotAttention(torch.autograd.Function):
    """Forward: the kernel (CUDA) or the plain version (CPU). Backward:
    autograd of `slot_attention_reference` on the saved inputs (`_fsa_bwd`)."""

    @staticmethod
    def forward(ctx, x, context, wq, wk, wv, wo, bo, heads, dim_head):
        inputs = (x, context, wq, wk, wv, wo, bo)
        if x.device.type == "cpu":
            out, sim = slot_attention_reference(*inputs, heads, dim_head)
        else:
            out, sim = _launch(*inputs, heads, dim_head)
        ctx.save_for_backward(*inputs)
        ctx.heads, ctx.dim_head = heads, dim_head
        return out, sim

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, d_out, d_sim):
        inputs = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            out, sim = slot_attention_reference(*inputs, ctx.heads, ctx.dim_head)
        outs, cots = zip(*[(o, g) for o, g in ((out, d_out), (sim, d_sim)) if g is not None])
        grads = torch.autograd.grad(outs, inputs, cots, allow_unused=True)
        grads = [torch.zeros_like(t) if g is None else g for t, g in zip(inputs, grads)]
        return (*grads, None, None)


def fused_slot_attention(x: torch.Tensor, ctx: torch.Tensor, wq: torch.Tensor, wk: torch.Tensor,
                         wv: torch.Tensor, wo: torch.Tensor, bo: torch.Tensor, heads: int = 4,
                         dim_head: int = 512) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4: (out [B, S, D], sim [B, heads, S, N] f32) of one slot
    cross-attention round; differentiable (module docstring). CUDA tensors
    go through the kernel, which takes bf16 operands and raises on anything
    else it does not take; CPU tensors take the plain version."""
    _check(x, ctx, wq, wk, wv, wo, bo, heads, dim_head)
    return _FusedSlotAttention.apply(x, ctx, wq, wk, wv, wo, bo, heads, dim_head)


fused_slot_attention.launches = 0
