"""Softmax attention kernels K1, K2 and K3, forward and backward.

Replaces `devias_tpu/kernels/attention.py`'s three attention entry points,
their custom VJPs and the Pallas kernels behind them. All three are the
same attention in three layouts, and one CUDA forward (`attention_fwd.cu`)
and one backward (`attention_bwd.cu`) serve them, each operand addressed
by its own strides:

| wrapper                       | kernel (csrc/)                     | replaces                          |
|-------------------------------|------------------------------------|-----------------------------------|
| `fused_attention_qkv`         | `attention_fwd.cu`, no stats       | `_fwd_call_qkv(with_stats=False)` |
| `attention_qkv_fwd_stats`     | `attention_fwd.cu`, with m and l   | `_fwd_call_qkv` via `_fa_qkv_fwd` |
| `attention_qkv_bwd`           | `attention_bwd.cu`                 | `_bwd_call_qkv` (`_bwd_kernel_mh`)|
| `fused_attention_q_kv`        | `attention_fwd.cu`, no stats       | `_fwd_call_q_kv(with_stats=False)`|
| `attention_q_kv_fwd_stats`    | `attention_fwd.cu`, with m and l   | `_fwd_call_q_kv` via `_fa_qkv2_fwd`|
| `attention_q_kv_bwd`          | `attention_bwd.cu`                 | `_bwd_call_q_kv`                  |
| `fused_attention`             | `attention_fwd.cu`, head-major     | `_fwd_call` (`_fwd_kernel`)       |
| `attention_head_major_bwd`    | stats pass + `attention_bwd.cu`    | `_bwd_call` (`_bwd_kernel`)       |

K1 takes the qkv Dense output [B, N, 3*H*D] (q | k | v) and returns
[B, N, H*D], so no head transposes enter the graph. K2 takes local queries
q [B, Nq, H*D] against gathered kv [B, Nk, 2*H*D] (k | v): the
sequence-parallel attention. K3 takes head-major q, k, v [B, H, N, D].
With grad enabled and an input that requires grad, K1 and K2 run as a
`torch.autograd.Function`: the stats forward saves (inputs, o, m, l) and
the backward kernel returns the input gradients. Otherwise (eval, the
frozen teacher under `no_grad`) they run the no-stats forward. K3 has one
forward; its Function saves (q, k, v, o) and its backward recomputes the
statistics, as the TPU kernel does. Each wrapper launches its hand-written
kernel on a CUDA tensor, or raises on what the kernel does not take (not
bfloat16, head dim not 64, a logit scale that is not a power of two, not
contiguous or not 16-byte aligned), and runs its plain version on a CPU
tensor; `m` and `l` are [B, H, Nq] float32. Each wrapper's `launches`
counts its kernel launches; K1's also count them by head count in
`launches_by_heads` (tensor parallelism runs K1 on a rank's share of the
heads); a replayed CUDA graph adds the launches its capture recorded
(`add_launches`). The kernels are built for Hopper from
`csrc/hopper.cuh`: TMA loads into 128-byte-swizzled tiles, wgmma products
and a producer warpgroup beside the consumer warpgroups; the backward is
three launches (pre-pass, dq, dkdv) over scratch the wrapper allocates.

What bounds the kernels on an H100 at the flagship shape (B=12, H=12,
N=1568, D=64): a forward does 90.6 GFLOP of bf16 products (~92 us at
989 TFLOP/s) against 115.6 MB in and out (~35 us at 3.35 TB/s); a backward
five N x N x D products, 226.6 GFLOP (~229 us), against ~231 MB (~69 us).
Both are bound by operations, with the 354 M exponentials (~91 us on the
special-function units) close behind. K2 at four shards (Nq=392 against
Nk=1568) has a quarter of the operations and is nearly as bound by bytes
and exponentials; see the sources for the designs.

Numerics: the kernels scale q in bf16 and round the exponentials to bf16
before P.V. K1 and K2 sum those rounded values into l (the TPU kernel's
ones-column); K3 sums the f32 exponentials (`_fwd_kernel`'s `e.sum`). The
forward's exponent is taken against a running row max. The backward
follows `_bwd_kernel_mh`'s roundings (see `_bwd_heads`), which
`_bwd_kernel` shares. The no-stats plain versions of K1 and K2 round the
logits and the probabilities to bf16 (the einsum path of
`devias_tpu/nn/vit.py:243-266`); the stats, K3 and backward plain versions
follow the kernels' steps in float32 with the same roundings to the input
dtype.
"""

from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch

from devias_tpu_torch.kernels import _build

HEAD_DIM = 64


# ---------------------------------------------------------------- plain versions


def _heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """[B, N, H*D] -> [B, H, N, D]."""
    B, N, C = x.shape
    return x.reshape(B, N, num_heads, C // num_heads).transpose(1, 2)


def _merge(x: torch.Tensor) -> torch.Tensor:
    """[B, H, N, D] -> [B, N, H*D]."""
    B, H, N, D = x.shape
    return x.transpose(1, 2).reshape(B, N, H * D)


def _split_heads(x: torch.Tensor, parts: int, num_heads: int):
    """[B, N, parts*H*D] -> `parts` tensors [B, H, N, D]."""
    B, N, W = x.shape
    return x.reshape(B, N, parts, num_heads, W // (parts * num_heads)).permute(2, 0, 3, 1, 4).unbind(0)


def _fwd_stats_heads(q, k, v, scale: float, round_l: bool):
    """Head-major stats forward in f32 with the kernels' roundings: q
    scaled in the input dtype, s = q k^T, m = max s, e = exp(s - m), l = the
    sum of e rounded to the input dtype (`round_l`, K1 and K2) or of e (K3),
    o = (rounded e) v / l. Returns o [B, H, N, D] f32 and m, l [B, H, N]."""
    s = (q * scale).float() @ k.float().transpose(-1, -2)
    m = s.amax(dim=-1)
    e = torch.exp(s - m[..., None])
    eb = e.to(q.dtype).float()
    l = (eb if round_l else e).sum(dim=-1)
    return (eb @ v.float()) / l[..., None], m, l


def _bwd_heads(q, k, v, o, do, m, l, scale: float):
    """Head-major backward (`_bwd_kernel_mh`, `_bwd_kernel`): e = exp(s - m),
    Dr = rowsum(dO o), t = e (dO v^T - Dr) rounded to the input dtype,
    dq = (t k) (scale / l), dk = t^T (q scale / l) with the right factor
    rounded, dv = e^T (dO / l) with both factors rounded; f32 sums. Returns
    dq, dk, dv [B, H, N, D] in f32."""
    dt = q.dtype
    o, do = o.float(), do.float()
    s = (q * scale).float() @ k.float().transpose(-1, -2)
    e = torch.exp(s - m[..., None])
    inv_l = (1.0 / l)[..., None]
    d_row = (do * o).sum(dim=-1, keepdim=True)
    t = (e * (do @ v.float().transpose(-1, -2) - d_row)).to(dt).float()
    dq = (t @ k.float()) * (inv_l * scale)
    dk = t.transpose(-1, -2) @ (q.float() * (inv_l * scale)).to(dt).float()
    dv = e.to(dt).float().transpose(-1, -2) @ (do * inv_l).to(dt).float()
    return dq, dk, dv


def bwd_prepass_reference(q, o, do, l, scale: float):
    """Plain version of the backward's pre-pass (`attention_bwd.cu`) on
    head-major q, o, dO [B, H, N, D] and l [B, H, N]: Dr = rowsum(dO o) in
    f32 and the bf16 operands of dk and dv, Qs = q (scale / l) and
    dOs = dO / l rounded to the input dtype, by `_bwd_heads`' operations.
    Returns Dr [B, H, N] and Qs, dOs [B, H, N, D]."""
    dt = q.dtype
    inv_l = (1.0 / l)[..., None]
    d_row = (do.float() * o.float()).sum(dim=-1)
    return d_row, (q.float() * (inv_l * scale)).to(dt), (do.float() * inv_l).to(dt)


def attention_q_kv_reference(q: torch.Tensor, kv: torch.Tensor, num_heads: int, scale: float) -> torch.Tensor:
    """Plain K2 (and, through `attention_qkv_reference`, K1): einsum, f32
    softmax, einsum, in the input dtype, as the JAX package's unfused path
    computes it. q [B, Nq, H*D], kv [B, Nk, 2*H*D] -> [B, Nq, H*D]."""
    B, Nq, C = q.shape
    D = C // num_heads
    qh = q.reshape(B, Nq, num_heads, D)
    kh, vh = kv.reshape(B, kv.shape[1], 2, num_heads, D).unbind(2)
    attn = torch.einsum("bnhd,bmhd->bhnm", qh * scale, kh)
    attn = attn.float().softmax(dim=-1).to(q.dtype)
    return torch.einsum("bhnm,bmhd->bnhd", attn, vh).reshape(B, Nq, C)


def attention_qkv_reference(qkv: torch.Tensor, num_heads: int, scale: float) -> torch.Tensor:
    """Plain K1: `attention_q_kv_reference` on the q and k | v column
    blocks of the fused projection [B, N, 3*H*D]."""
    C = qkv.shape[-1] // 3
    return attention_q_kv_reference(qkv[..., :C], qkv[..., C:], num_heads, scale)


def attention_qkv_fwd_stats_reference(qkv: torch.Tensor, num_heads: int,
                                      scale: float) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of K1's stats forward (`_fwd_kernel_mh` with stats):
    `_fwd_stats_heads` with l over the rounded exponentials. Returns o
    [B, N, H*D] in the input dtype and m, l [B, H, N] f32."""
    o, m, l = _fwd_stats_heads(*_split_heads(qkv, 3, num_heads), scale, round_l=True)
    return _merge(o).to(qkv.dtype), m, l


def attention_q_kv_fwd_stats_reference(q: torch.Tensor, kv: torch.Tensor, num_heads: int,
                                       scale: float) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of K2's stats forward: as K1's on q [B, Nq, H*D] and
    kv [B, Nk, 2*H*D]. Returns o [B, Nq, H*D] and m, l [B, H, Nq] f32."""
    o, m, l = _fwd_stats_heads(_heads(q, num_heads), *_split_heads(kv, 2, num_heads), scale, round_l=True)
    return _merge(o).to(q.dtype), m, l


def attention_qkv_bwd_reference(qkv: torch.Tensor, o: torch.Tensor, do: torch.Tensor, m: torch.Tensor,
                                l: torch.Tensor, num_heads: int, scale: float) -> torch.Tensor:
    """Plain version of K1's backward (`_bwd_heads`). Returns dqkv
    [B, N, 3*H*D] in the input dtype."""
    grads = _bwd_heads(*_split_heads(qkv, 3, num_heads), _heads(o, num_heads), _heads(do, num_heads),
                       m, l, scale)
    return torch.cat([_merge(g) for g in grads], dim=-1).to(qkv.dtype)


def attention_q_kv_bwd_reference(q: torch.Tensor, kv: torch.Tensor, o: torch.Tensor, do: torch.Tensor,
                                 m: torch.Tensor, l: torch.Tensor, num_heads: int,
                                 scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K2's backward (`_bwd_heads`). Returns dq
    [B, Nq, H*D] and dkv [B, Nk, 2*H*D] in the input dtype."""
    dq, dk, dv = _bwd_heads(_heads(q, num_heads), *_split_heads(kv, 2, num_heads), _heads(o, num_heads),
                            _heads(do, num_heads), m, l, scale)
    return _merge(dq).to(q.dtype), torch.cat([_merge(dk), _merge(dv)], dim=-1).to(kv.dtype)


def attention_head_major_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                   scale: float) -> torch.Tensor:
    """Plain K3 forward (`_fwd_kernel`): `_fwd_stats_heads` with l over the
    f32 exponentials. q, k, v [B, H, N, D] -> o [B, H, N, D], input dtype."""
    return _fwd_stats_heads(q, k, v, scale, round_l=False)[0].to(q.dtype)


def attention_head_major_bwd_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
                                       do: torch.Tensor, scale: float):
    """Plain K3 backward (`_bwd_kernel`): m and l recomputed as K3's forward
    takes them, then `_bwd_heads`. Returns dq, dk, dv [B, H, N, D] in the
    input dtype."""
    _, m, l = _fwd_stats_heads(q, k, v, scale, round_l=False)
    return tuple(g.to(q.dtype) for g in _bwd_heads(q, k, v, o, do, m, l, scale))


# ---------------------------------------------------------------- kernel launches


def _fn(lib: str, symbol: str, n_ptrs: int, n_ints: int = 4):
    fn = getattr(_build.load(lib), symbol)
    fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check_qkv(qkv: torch.Tensor, num_heads: int) -> None:
    if qkv.dim() != 3 or qkv.shape[-1] % (3 * num_heads):
        raise ValueError(f"qkv must be [B, N, 3*H*D] with H={num_heads}; got {tuple(qkv.shape)}")


def _check_q_kv(q: torch.Tensor, kv: torch.Tensor, num_heads: int) -> None:
    if q.dim() != 3 or kv.dim() != 3 or q.shape[-1] % num_heads or kv.shape[0] != q.shape[0] \
            or kv.shape[-1] != 2 * q.shape[-1]:
        raise ValueError(f"q must be [B, Nq, H*D] and kv [B, Nk, 2*H*D] with H={num_heads}; "
                         f"got {tuple(q.shape)} and {tuple(kv.shape)}")


def _check_head_major(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must be one shape [B, H, N, D]; got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")


def _check_device(*tensors: torch.Tensor) -> bool:
    """True for CPU tensors (the plain versions); False for CUDA tensors
    (the kernels); raises for any other device."""
    dev = tensors[0].device.type
    if dev not in ("cpu", "cuda"):
        raise ValueError(f"no attention path for device {tensors[0].device}")
    return dev == "cpu"


def _check_kernel_input(name: str, t: torch.Tensor, shape, dtype=torch.bfloat16) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"no kernel path for {name} on device {t.device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must be {tuple(shape)}; got {tuple(t.shape)}")
    if t.dtype != dtype:
        raise ValueError(f"the attention kernels take {name} as {dtype}; got {t.dtype}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"the attention kernels take a contiguous, 16-byte aligned {name}")


def _check_head_dim(D: int) -> None:
    if D != HEAD_DIM:
        raise ValueError(f"the attention kernels take head dim {HEAD_DIM}; got {D}")


def _check_scale(scale: float) -> None:
    """The kernels fold the logit scale into the exponent's multiplier, which
    equals rounding q * scale to bf16 only for a power of two (D^-0.5 at
    D = 64 is 1/8)."""
    if not (scale > 0 and math.frexp(scale)[0] == 0.5):
        raise ValueError(f"the attention kernels take a logit scale that is a power of two; got {scale}")


def _launch_dims(qkv: torch.Tensor, num_heads: int, scale: float):
    B, N, W3 = qkv.shape
    D = W3 // (3 * num_heads)
    _check_head_dim(D)
    _check_scale(scale)
    _check_kernel_input("qkv", qkv, qkv.shape)
    return B, N, D


def _launch_dims_q_kv(q: torch.Tensor, kv: torch.Tensor, num_heads: int, scale: float):
    B, Nq, C = q.shape
    D = C // num_heads
    _check_head_dim(D)
    _check_scale(scale)
    _check_kernel_input("q", q, q.shape)
    _check_kernel_input("kv", kv, kv.shape)
    return B, Nq, kv.shape[1], D


def _run(fn, device, *args) -> None:
    with torch.cuda.device(device):
        rc = fn(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"attention kernel launch failed with CUDA error {rc}")


def _stats_like(B: int, H: int, N: int, device):
    m = torch.empty((B, H, N), dtype=torch.float32, device=device)
    return m, torch.empty_like(m)


# q rows of the backward's dkdv tiles, to which its row scratch is padded
_BWD_Q_ROWS = 64


def _bwd_scratch(B: int, H: int, Nq: int, D: int, device):
    """The backward's scratch: rows [2, B, H, Nq_pad] f32 (m log2 e and Dr,
    padded to whole dkdv tiles) and ops [2, B, H, Nq, D] bf16 (Qs, dOs)."""
    pad = -(-Nq // _BWD_Q_ROWS) * _BWD_Q_ROWS
    return (torch.empty((2, B, H, pad), dtype=torch.float32, device=device),
            torch.empty((2, B, H, Nq, D), dtype=torch.bfloat16, device=device))


# ---------------------------------------------------------------- K1


def _fwd_no_stats(qkv: torch.Tensor, num_heads: int, scale: float) -> torch.Tensor:
    if qkv.device.type == "cpu":
        return attention_qkv_reference(qkv, num_heads, scale)
    B, N, D = _launch_dims(qkv, num_heads, scale)
    out = torch.empty((B, N, num_heads * D), dtype=qkv.dtype, device=qkv.device)
    _run(_fn("attention_fwd", "devias_attention_qkv_fwd", 2), qkv.device,
         qkv.data_ptr(), out.data_ptr(), B, N, num_heads, D, float(scale))
    _count(fused_attention_qkv, num_heads)
    return out


def attention_qkv_fwd_stats(qkv: torch.Tensor, num_heads: int,
                            scale: float) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K1's stats forward: (o [B, N, H*D], m [B, H, N], l [B, H, N]).
    CUDA tensors go through the kernel, CPU tensors take
    `attention_qkv_fwd_stats_reference`. `.launches` counts kernel launches."""
    _check_qkv(qkv, num_heads)
    if qkv.device.type == "cpu":
        return attention_qkv_fwd_stats_reference(qkv, num_heads, scale)
    B, N, D = _launch_dims(qkv, num_heads, scale)
    out = torch.empty((B, N, num_heads * D), dtype=qkv.dtype, device=qkv.device)
    m, l = _stats_like(B, num_heads, N, qkv.device)
    _run(_fn("attention_fwd", "devias_attention_qkv_fwd_stats", 4), qkv.device,
         qkv.data_ptr(), out.data_ptr(), m.data_ptr(), l.data_ptr(), B, N, num_heads, D, float(scale))
    _count(attention_qkv_fwd_stats, num_heads)
    return out, m, l


def attention_qkv_bwd(qkv: torch.Tensor, o: torch.Tensor, do: torch.Tensor, m: torch.Tensor,
                      l: torch.Tensor, num_heads: int, scale: float) -> torch.Tensor:
    """K1's backward: dqkv [B, N, 3*H*D] from qkv, o, dO and the stats.
    CUDA tensors go through the kernel, CPU tensors take
    `attention_qkv_bwd_reference`. `.launches` counts kernel launches."""
    _check_qkv(qkv, num_heads)
    if qkv.device.type == "cpu":
        return attention_qkv_bwd_reference(qkv, o, do, m, l, num_heads, scale)
    B, N, D = _launch_dims(qkv, num_heads, scale)
    for name, t in (("o", o), ("do", do)):
        _check_kernel_input(name, t, (B, N, num_heads * D))
    for name, t in (("m", m), ("l", l)):
        _check_kernel_input(name, t, (B, num_heads, N), torch.float32)
    dqkv = torch.empty_like(qkv)
    rows, ops = _bwd_scratch(B, num_heads, N, D, qkv.device)
    _run(_fn("attention_bwd", "devias_attention_qkv_bwd", 8), qkv.device,
         qkv.data_ptr(), o.data_ptr(), do.data_ptr(), m.data_ptr(), l.data_ptr(), rows.data_ptr(), ops.data_ptr(),
         dqkv.data_ptr(), B, N, num_heads, D, float(scale))
    _count(attention_qkv_bwd, num_heads)
    return dqkv


def _count(fn, num_heads: int) -> None:
    """One launch of K1's `fn` at `num_heads` heads."""
    fn.launches += 1
    fn.launches_by_heads[num_heads] = fn.launches_by_heads.get(num_heads, 0) + 1


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
    """K1: softmax attention over [B, N, 3*H*D] -> [B, N, H*D].

    With grad enabled and `qkv.requires_grad`, the differentiable form
    (stats forward + backward kernel); otherwise the no-stats forward.
    CUDA tensors go through the kernels (bf16, head dim 64, contiguous)
    and anything else they do not take raises; CPU tensors take the plain
    versions. `fused_attention_qkv.launches` counts no-stats launches."""
    _check_qkv(qkv, num_heads)
    _check_device(qkv)
    if torch.is_grad_enabled() and qkv.requires_grad:
        return _FusedAttentionQKV.apply(qkv, num_heads, scale)
    return _fwd_no_stats(qkv, num_heads, scale)


# ---------------------------------------------------------------- K2


def _q_kv_no_stats(q: torch.Tensor, kv: torch.Tensor, num_heads: int, scale: float) -> torch.Tensor:
    if q.device.type == "cpu":
        return attention_q_kv_reference(q, kv, num_heads, scale)
    B, Nq, Nk, D = _launch_dims_q_kv(q, kv, num_heads, scale)
    out = torch.empty_like(q)
    _run(_fn("attention_fwd", "devias_attention_q_kv_fwd", 3, 5), q.device,
         q.data_ptr(), kv.data_ptr(), out.data_ptr(), B, Nq, Nk, num_heads, D, float(scale))
    fused_attention_q_kv.launches += 1
    return out


def attention_q_kv_fwd_stats(q: torch.Tensor, kv: torch.Tensor, num_heads: int,
                             scale: float) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K2's stats forward: (o [B, Nq, H*D], m [B, H, Nq], l [B, H, Nq]) from
    q [B, Nq, H*D] and kv [B, Nk, 2*H*D]. CUDA tensors go through the kernel,
    CPU tensors take `attention_q_kv_fwd_stats_reference`. `.launches`
    counts kernel launches."""
    _check_q_kv(q, kv, num_heads)
    if _check_device(q, kv):
        return attention_q_kv_fwd_stats_reference(q, kv, num_heads, scale)
    B, Nq, Nk, D = _launch_dims_q_kv(q, kv, num_heads, scale)
    out = torch.empty_like(q)
    m, l = _stats_like(B, num_heads, Nq, q.device)
    _run(_fn("attention_fwd", "devias_attention_q_kv_fwd_stats", 5, 5), q.device,
         q.data_ptr(), kv.data_ptr(), out.data_ptr(), m.data_ptr(), l.data_ptr(), B, Nq, Nk, num_heads, D,
         float(scale))
    attention_q_kv_fwd_stats.launches += 1
    return out, m, l


def attention_q_kv_bwd(q: torch.Tensor, kv: torch.Tensor, o: torch.Tensor, do: torch.Tensor, m: torch.Tensor,
                       l: torch.Tensor, num_heads: int, scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2's backward: (dq [B, Nq, H*D], dkv [B, Nk, 2*H*D]) from q, kv, o,
    dO and the stats. CUDA tensors go through the kernel, CPU tensors take
    `attention_q_kv_bwd_reference`. `.launches` counts kernel launches."""
    _check_q_kv(q, kv, num_heads)
    if _check_device(q, kv):
        return attention_q_kv_bwd_reference(q, kv, o, do, m, l, num_heads, scale)
    B, Nq, Nk, D = _launch_dims_q_kv(q, kv, num_heads, scale)
    for name, t in (("o", o), ("do", do)):
        _check_kernel_input(name, t, q.shape)
    for name, t in (("m", m), ("l", l)):
        _check_kernel_input(name, t, (B, num_heads, Nq), torch.float32)
    dq, dkv = torch.empty_like(q), torch.empty_like(kv)
    rows, ops = _bwd_scratch(B, num_heads, Nq, D, q.device)
    _run(_fn("attention_bwd", "devias_attention_q_kv_bwd", 10, 5), q.device,
         q.data_ptr(), kv.data_ptr(), o.data_ptr(), do.data_ptr(), m.data_ptr(), l.data_ptr(), rows.data_ptr(),
         ops.data_ptr(), dq.data_ptr(), dkv.data_ptr(), B, Nq, Nk, num_heads, D, float(scale))
    attention_q_kv_bwd.launches += 1
    return dq, dkv


class _FusedAttentionQKV2(torch.autograd.Function):
    """The differentiated K2: stats forward, saved (q, kv, o, m, l),
    backward kernel (`_fa_qkv2_fwd` / `_fa_qkv2_bwd` of the JAX package)."""

    @staticmethod
    def forward(ctx, q, kv, num_heads, scale):
        o, m, l = attention_q_kv_fwd_stats(q, kv, num_heads, scale)
        ctx.save_for_backward(q, kv, o, m, l)
        ctx.num_heads, ctx.scale = num_heads, scale
        return o

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, do):
        q, kv, o, m, l = ctx.saved_tensors
        dq, dkv = attention_q_kv_bwd(q, kv, o, do.contiguous(), m, l, ctx.num_heads, ctx.scale)
        return dq, dkv, None, None


def fused_attention_q_kv(q: torch.Tensor, kv: torch.Tensor, num_heads: int, scale: float) -> torch.Tensor:
    """K2: softmax attention of local query rows q [B, Nq, H*D] against a
    (possibly larger) key/value set kv [B, Nk, 2*H*D] -> [B, Nq, H*D].

    The sequence-parallel attention: each rank passes its own q rows and
    the kv gathered over the seq group. With grad enabled and q or kv
    requiring grad, the differentiable form (stats forward + backward
    kernel); otherwise the no-stats forward. CUDA tensors go through the
    kernels and anything they do not take raises; CPU tensors take the
    plain versions. `fused_attention_q_kv.launches` counts no-stats
    launches."""
    _check_q_kv(q, kv, num_heads)
    _check_device(q, kv)
    if torch.is_grad_enabled() and (q.requires_grad or kv.requires_grad):
        return _FusedAttentionQKV2.apply(q, kv, num_heads, scale)
    return _q_kv_no_stats(q, kv, num_heads, scale)


# ---------------------------------------------------------------- K3


def _head_major_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    if q.device.type == "cpu":
        return attention_head_major_reference(q, k, v, scale)
    B, H, N, D = q.shape
    _check_head_dim(D)
    _check_scale(scale)
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_kernel_input(name, t, q.shape)
    out = torch.empty_like(q)
    _run(_fn("attention_fwd", "devias_attention_head_major_fwd", 4), q.device,
         q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H, N, D, float(scale))
    fused_attention.launches += 1
    return out


def attention_head_major_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
                             do: torch.Tensor, scale: float):
    """K3's backward: (dq, dk, dv) [B, H, N, D] from q, k, v, o and dO; the
    statistics are recomputed (a stats-only pass of the forward kernel, l
    over the f32 exponentials). CUDA tensors go through the kernels, CPU
    tensors take `attention_head_major_bwd_reference`. `.launches` counts
    launches of the pair."""
    _check_head_major(q, k, v)
    if _check_device(q, k, v):
        return attention_head_major_bwd_reference(q, k, v, o, do, scale)
    B, H, N, D = q.shape
    _check_head_dim(D)
    _check_scale(scale)
    for name, t in (("q", q), ("k", k), ("v", v), ("o", o), ("do", do)):
        _check_kernel_input(name, t, q.shape)
    m, l = _stats_like(B, H, N, q.device)
    rows, ops = _bwd_scratch(B, H, N, D, q.device)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    _run(_fn("attention_fwd", "devias_attention_head_major_stats", 4), q.device,
         q.data_ptr(), k.data_ptr(), m.data_ptr(), l.data_ptr(), B, H, N, D, float(scale))
    _run(_fn("attention_bwd", "devias_attention_head_major_bwd", 12), q.device,
         q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(), m.data_ptr(), l.data_ptr(),
         rows.data_ptr(), ops.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, H, N, D, float(scale))
    attention_head_major_bwd.launches += 1
    return dq, dk, dv


class _FusedAttention(torch.autograd.Function):
    """K3 (`fused_attention` of the JAX package, `_fa_fwd` / `_fa_bwd`): the
    forward saves (q, k, v, o); the backward recomputes the statistics."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        o = _head_major_fwd(q, k, v, scale)
        ctx.save_for_backward(q, k, v, o)
        ctx.scale = scale
        return o

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, do):
        q, k, v, o = ctx.saved_tensors
        return (*attention_head_major_bwd(q, k, v, o, do.contiguous(), ctx.scale), None)


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    """K3: softmax attention over full rows, head-major. q, k, v
    [B, H, N, D] -> [B, H, N, D]; `scale` multiplies the logits.
    Differentiable. CUDA tensors go through the kernels (bf16, head dim 64,
    contiguous) and anything else they do not take raises; CPU tensors take
    the plain versions. `fused_attention.launches` counts forward launches."""
    _check_head_major(q, k, v)
    _check_device(q, k, v)
    return _FusedAttention.apply(q, k, v, scale)


fused_attention_qkv.launches = 0
attention_qkv_fwd_stats.launches = 0
attention_qkv_bwd.launches = 0
fused_attention_q_kv.launches = 0
attention_q_kv_fwd_stats.launches = 0
attention_q_kv_bwd.launches = 0
fused_attention.launches = 0
attention_head_major_bwd.launches = 0
KERNELS = {
    "K1-fwd": fused_attention_qkv,
    "K1-fwd-stats": attention_qkv_fwd_stats,
    "K1-bwd": attention_qkv_bwd,
    "K2-fwd": fused_attention_q_kv,
    "K2-fwd-stats": attention_q_kv_fwd_stats,
    "K2-bwd": attention_q_kv_bwd,
    "K3-fwd": fused_attention,
    "K3-bwd": attention_head_major_bwd,
}


K1_KERNELS = ("K1-fwd", "K1-fwd-stats", "K1-bwd")
for _name in K1_KERNELS:
    KERNELS[_name].launches_by_heads = {}


def launch_counts() -> dict:
    """Kernel launches of each wrapper since the last reset."""
    return {name: fn.launches for name, fn in KERNELS.items()}


def launch_counts_by_heads() -> dict:
    """K1's launches since the last reset, by form and head count."""
    return {name: dict(KERNELS[name].launches_by_heads) for name in K1_KERNELS}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
    for name in K1_KERNELS:
        KERNELS[name].launches_by_heads = {}


def launches_since(counts: dict, by_heads: dict) -> tuple:
    """The launches made since `launch_counts()` and
    `launch_counts_by_heads()` read `counts` and `by_heads`, in their
    shapes: what a captured CUDA graph launches on each replay."""
    now, now_heads = launch_counts(), launch_counts_by_heads()
    return ({k: now[k] - counts.get(k, 0) for k in now},
            {k: {h: n - by_heads.get(k, {}).get(h, 0) for h, n in v.items()} for k, v in now_heads.items()})


def add_launches(counts: dict, by_heads: dict) -> None:
    """Add launches (`launches_since`'s pair) to the counts: a replayed
    CUDA graph's, which the wrappers do not see."""
    for name, n in counts.items():
        KERNELS[name].launches += n
    for name, heads in by_heads.items():
        fn = KERNELS[name]
        for h, n in heads.items():
            if n:
                fn.launches_by_heads[h] = fn.launches_by_heads.get(h, 0) + n


def set_launch_counts(counts: dict, by_heads: dict) -> None:
    """Put the counts back to `launch_counts()` and
    `launch_counts_by_heads()` as read earlier."""
    reset_launch_counts()
    add_launches(counts, by_heads)
