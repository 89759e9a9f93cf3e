"""K1: softmax attention on the fused qkv projection, forward and backward.

Replaces `devias_tpu/kernels/attention.py::fused_attention_qkv`, its
custom VJP and the Pallas kernels behind it:

| wrapper                    | kernel (csrc/)                    | replaces                          |
|----------------------------|-----------------------------------|-----------------------------------|
| `fused_attention_qkv`      | `attention_fwd.cu`, no stats      | `_fwd_call_qkv(with_stats=False)` |
| `attention_qkv_fwd_stats`  | `attention_fwd.cu`, with m and l  | `_fwd_call_qkv` via `_fa_qkv_fwd` |
| `attention_qkv_bwd`        | `attention_bwd.cu`                | `_bwd_call_qkv` (`_bwd_kernel_mh`)|

`fused_attention_qkv` takes the qkv Dense output [B, N, 3*H*D] (q | k | v
contiguous) and returns [B, N, H*D], so no head transposes enter the graph.
With grad enabled and `qkv.requires_grad` it runs as a
`torch.autograd.Function`: the stats forward saves (qkv, o, m, l) and the
backward kernel returns dqkv [B, N, 3*H*D]. Otherwise (eval, the frozen
teacher under `no_grad`) it runs the no-stats forward. Each wrapper
launches its hand-written kernel on a CUDA tensor, or raises on what the
kernel does not take, and runs its plain version on a CPU tensor; `m` and
`l` are [B, H, N] float32. Each wrapper's `launches` counts its kernel
launches.

What bounds the kernels on an H100 at the flagship shape (B=12, H=12,
N=1568, D=64): a forward does 90.6 GFLOP of bf16 products (~92 us at
989 TFLOP/s) against 115.6 MB in and out (~35 us at 3.35 TB/s); a backward
five N x N x D products, 226.6 GFLOP (~229 us), against ~231 MB (~69 us).
Both are bound by operations, with the 354 M exponentials (~91 us on the
special-function units) close behind; see the sources for the designs.

Numerics: the kernels scale q in bf16, round the exponentials to bf16
before P.V and sum those rounded values into l, as the TPU kernel does, but
take the forward's exponent against a running row max. The backward
follows `_bwd_kernel_mh`'s roundings (see `attention_qkv_bwd_reference`).
The no-stats plain version rounds the logits and the probabilities to bf16
(the einsum path of `devias_tpu/nn/vit.py:260-266`); the stats and
backward plain versions follow the kernels' steps in float32 with the
same roundings to the input dtype.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from devias_tpu_torch.kernels import _build

HEAD_DIM = 64


def _heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """[B, N, H*D] -> [B, H, N, D]."""
    B, N, C = x.shape
    return x.reshape(B, N, num_heads, C // num_heads).transpose(1, 2)


def _qkv_heads(qkv: torch.Tensor, num_heads: int):
    B, N, W3 = qkv.shape
    return qkv.reshape(B, N, 3, num_heads, W3 // (3 * num_heads)).permute(2, 0, 3, 1, 4).unbind(0)


def attention_qkv_reference(qkv: torch.Tensor, num_heads: int, scale: float) -> torch.Tensor:
    """Plain PyTorch version: einsum, f32 softmax, einsum, in the input
    dtype, as the JAX package's unfused path computes it."""
    B, N, W3 = qkv.shape
    C = W3 // 3
    q, k, v = qkv.reshape(B, N, 3, num_heads, C // num_heads).unbind(2)
    attn = torch.einsum("bnhd,bmhd->bhnm", q * scale, k)
    attn = attn.float().softmax(dim=-1).to(qkv.dtype)
    return torch.einsum("bhnm,bmhd->bnhd", attn, v).reshape(B, N, C)


def attention_qkv_fwd_stats_reference(qkv: torch.Tensor, num_heads: int,
                                      scale: float) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the stats forward (`_fwd_kernel_mh` with stats):
    q scaled in the input dtype, s = q k^T in f32, m = max s,
    e = exp(s - m) rounded to the input dtype, l = sum e, o = (e v) / l.
    Returns o [B, N, H*D] in the input dtype and m, l [B, H, N] f32."""
    dt = qkv.dtype
    q, k, v = _qkv_heads(qkv, num_heads)
    s = (q * scale).float() @ k.float().transpose(-1, -2)
    m = s.amax(dim=-1)
    e = torch.exp(s - m[..., None]).to(dt).float()
    l = e.sum(dim=-1)
    o = (e @ v.float()) / l[..., None]
    B, H, N, D = o.shape
    return o.transpose(1, 2).reshape(B, N, H * D).to(dt), m, l


def attention_qkv_bwd_reference(qkv: torch.Tensor, o: torch.Tensor, do: torch.Tensor, m: torch.Tensor,
                                l: torch.Tensor, num_heads: int, scale: float) -> torch.Tensor:
    """Plain version of the backward (`_bwd_kernel_mh`): e = exp(s - m),
    Dr = rowsum(dO o), t = e (dO v^T - Dr) rounded to the input dtype,
    dq = (t k) (scale / l), dk = t^T (q scale / l) with the right factor
    rounded, dv = e^T (dO / l) with both factors rounded; f32 sums. Returns
    dqkv [B, N, 3*H*D] in the input dtype."""
    dt = qkv.dtype
    q, k, v = _qkv_heads(qkv, num_heads)
    oh, doh = _heads(o, num_heads).float(), _heads(do, num_heads).float()
    s = (q * scale).float() @ k.float().transpose(-1, -2)
    e = torch.exp(s - m[..., None])
    inv_l = (1.0 / l)[..., None]
    d_row = (doh * oh).sum(dim=-1, keepdim=True)
    t = (e * (doh @ v.float().transpose(-1, -2) - d_row)).to(dt).float()
    dq = (t @ k.float()) * (inv_l * scale)
    dk = t.transpose(-1, -2) @ (q.float() * (inv_l * scale)).to(dt).float()
    dv = e.to(dt).float().transpose(-1, -2) @ (doh * inv_l).to(dt).float()
    B, H, N, D = dq.shape
    return torch.stack([dq, dk, dv], dim=1).permute(0, 3, 1, 2, 4).reshape(B, N, 3 * H * D).to(dt)


def _fn(lib: str, symbol: str, n_ptrs: int):
    fn = getattr(_build.load(lib), symbol)
    fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check_qkv(qkv: torch.Tensor, num_heads: int) -> None:
    if qkv.dim() != 3 or qkv.shape[-1] % (3 * num_heads):
        raise ValueError(f"qkv must be [B, N, 3*H*D] with H={num_heads}; got {tuple(qkv.shape)}")


def _check_kernel_input(name: str, t: torch.Tensor, shape, dtype=torch.bfloat16) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"no K1 path for {name} on device {t.device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must be {tuple(shape)}; got {tuple(t.shape)}")
    if t.dtype != dtype:
        raise ValueError(f"the K1 kernels take {name} as {dtype}; got {t.dtype}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"the K1 kernels take a contiguous, 16-byte aligned {name}")


def _launch_dims(qkv: torch.Tensor, num_heads: int):
    B, N, W3 = qkv.shape
    D = W3 // (3 * num_heads)
    if D != HEAD_DIM:
        raise ValueError(f"the K1 kernels take head dim {HEAD_DIM}; got {D}")
    _check_kernel_input("qkv", qkv, qkv.shape)
    return B, N, D


def _run(fn, device, *args) -> None:
    with torch.cuda.device(device):
        rc = fn(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"K1 attention kernel launch failed with CUDA error {rc}")


def _fwd_no_stats(qkv: torch.Tensor, num_heads: int, scale: float) -> torch.Tensor:
    if qkv.device.type == "cpu":
        return attention_qkv_reference(qkv, num_heads, scale)
    B, N, D = _launch_dims(qkv, num_heads)
    out = torch.empty((B, N, num_heads * D), dtype=qkv.dtype, device=qkv.device)
    _run(_fn("attention_fwd", "devias_attention_qkv_fwd", 2), qkv.device,
         qkv.data_ptr(), out.data_ptr(), B, N, num_heads, D, float(scale))
    fused_attention_qkv.launches += 1
    return out


def attention_qkv_fwd_stats(qkv: torch.Tensor, num_heads: int,
                            scale: float) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The stats forward: (o [B, N, H*D], m [B, H, N], l [B, H, N]).
    CUDA tensors go through the kernel, CPU tensors take
    `attention_qkv_fwd_stats_reference`. `.launches` counts kernel launches."""
    _check_qkv(qkv, num_heads)
    if qkv.device.type == "cpu":
        return attention_qkv_fwd_stats_reference(qkv, num_heads, scale)
    B, N, D = _launch_dims(qkv, num_heads)
    out = torch.empty((B, N, num_heads * D), dtype=qkv.dtype, device=qkv.device)
    m = torch.empty((B, num_heads, N), dtype=torch.float32, device=qkv.device)
    l = torch.empty_like(m)
    _run(_fn("attention_fwd", "devias_attention_qkv_fwd_stats", 4), qkv.device,
         qkv.data_ptr(), out.data_ptr(), m.data_ptr(), l.data_ptr(), B, N, num_heads, D, float(scale))
    attention_qkv_fwd_stats.launches += 1
    return out, m, l


def attention_qkv_bwd(qkv: torch.Tensor, o: torch.Tensor, do: torch.Tensor, m: torch.Tensor,
                      l: torch.Tensor, num_heads: int, scale: float) -> torch.Tensor:
    """The backward: dqkv [B, N, 3*H*D] from qkv, o, dO and the stats.
    CUDA tensors go through the kernel, CPU tensors take
    `attention_qkv_bwd_reference`. `.launches` counts kernel launches."""
    _check_qkv(qkv, num_heads)
    if qkv.device.type == "cpu":
        return attention_qkv_bwd_reference(qkv, o, do, m, l, num_heads, scale)
    B, N, D = _launch_dims(qkv, num_heads)
    for name, t in (("o", o), ("do", do)):
        _check_kernel_input(name, t, (B, N, num_heads * D))
    for name, t in (("m", m), ("l", l)):
        _check_kernel_input(name, t, (B, num_heads, N), torch.float32)
    dqkv = torch.empty_like(qkv)
    scratch = torch.empty((B, num_heads, N), dtype=torch.float32, device=qkv.device)
    _run(_fn("attention_bwd", "devias_attention_qkv_bwd", 7), qkv.device,
         qkv.data_ptr(), o.data_ptr(), do.data_ptr(), m.data_ptr(), l.data_ptr(), scratch.data_ptr(),
         dqkv.data_ptr(), B, N, num_heads, D, float(scale))
    attention_qkv_bwd.launches += 1
    return dqkv


class _FusedAttentionQKV(torch.autograd.Function):
    """The differentiated K1: stats forward, saved (qkv, o, m, l), backward
    kernel (`_fa_qkv_fwd` / `_fa_qkv_bwd` of the JAX package)."""

    @staticmethod
    def forward(ctx, qkv, num_heads, scale):
        o, m, l = attention_qkv_fwd_stats(qkv, num_heads, scale)
        ctx.save_for_backward(qkv, o, m, l)
        ctx.num_heads, ctx.scale = num_heads, scale
        return o

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, do):
        qkv, o, m, l = ctx.saved_tensors
        return attention_qkv_bwd(qkv, o, do.contiguous(), m, l, ctx.num_heads, ctx.scale), None, None


def fused_attention_qkv(qkv: torch.Tensor, num_heads: int, scale: float) -> torch.Tensor:
    """Softmax attention over [B, N, 3*H*D] -> [B, N, H*D].

    With grad enabled and `qkv.requires_grad`, the differentiable form
    (stats forward + backward kernel); otherwise the no-stats forward.
    CUDA tensors go through the kernels (bf16, head dim 64, contiguous)
    and anything else they do not take raises; CPU tensors take the plain
    versions. `fused_attention_qkv.launches` counts no-stats launches."""
    _check_qkv(qkv, num_heads)
    if qkv.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no K1 path for device {qkv.device}")
    if torch.is_grad_enabled() and qkv.requires_grad:
        return _FusedAttentionQKV.apply(qkv, num_heads, scale)
    return _fwd_no_stats(qkv, num_heads, scale)


fused_attention_qkv.launches = 0
attention_qkv_fwd_stats.launches = 0
attention_qkv_bwd.launches = 0
KERNELS = {
    "K1-fwd": fused_attention_qkv,
    "K1-fwd-stats": attention_qkv_fwd_stats,
    "K1-bwd": attention_qkv_bwd,
}


def launch_counts() -> dict:
    """Kernel launches of each K1 wrapper since the last reset."""
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
