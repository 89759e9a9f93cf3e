"""K1 forward: softmax attention on the fused qkv projection.

Replaces `devias_tpu/kernels/attention.py::_fwd_call_qkv` (Pallas body
`_fwd_kernel_mh`) in its no-stats form, the one `fused_attention_qkv`
runs in the eval forward and the frozen teacher.

`fused_attention_qkv` takes the qkv Dense output [B, N, 3*H*D] (q | k | v
contiguous) and returns [B, N, H*D], so no head transposes enter the graph.
On a CUDA tensor it launches the hand-written kernel in
`csrc/attention_fwd.cu` or raises; on a CPU tensor it runs the plain
version, `attention_qkv_reference`.

What bounds the kernel on an H100: at the flagship shape (B=12, H=12,
N=1568, D=64) a launch does 90.6 GFLOP of bf16 products (~92 us at
989 TFLOP/s) against 115.6 MB in and out (~35 us at 3.35 TB/s), so it is
bound by operations, with the 354 M exponentials close behind on the
special-function units. The kernel streams K/V through shared memory in
64-key tiles and keeps S and P in registers, so its only device-memory
traffic is q/k/v in and o out; see the source for the design.

Numerics: the kernel scales q in bf16, rounds the exponentials to bf16
before P.V and sums those rounded values into the row sum, as the TPU
kernel does, but takes the exponent against a running row max. The plain
version rounds the logits and the probabilities to bf16 (the einsum path
of `devias_tpu/nn/vit.py:260-266`). The two agree to bf16 resolution of
the output, not bit for bit.
"""

from __future__ import annotations

import ctypes

import torch

from devias_tpu_torch.kernels import _build

HEAD_DIM = 64


def attention_qkv_reference(qkv: torch.Tensor, num_heads: int, scale: float) -> torch.Tensor:
    """Plain PyTorch version: einsum, f32 softmax, einsum, in the input
    dtype, as the JAX package's unfused path computes it."""
    B, N, W3 = qkv.shape
    C = W3 // 3
    q, k, v = qkv.reshape(B, N, 3, num_heads, C // num_heads).unbind(2)
    attn = torch.einsum("bnhd,bmhd->bhnm", q * scale, k)
    attn = attn.float().softmax(dim=-1).to(qkv.dtype)
    return torch.einsum("bhnm,bmhd->bnhd", attn, v).reshape(B, N, C)


def _kernel_fn():
    fn = _build.load("attention_fwd").devias_attention_qkv_fwd
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def fused_attention_qkv(qkv: torch.Tensor, num_heads: int, scale: float) -> torch.Tensor:
    """Softmax attention over [B, N, 3*H*D] -> [B, N, H*D].

    CUDA tensors go through the K1 kernel (bf16, head dim 64, contiguous)
    and anything else it does not take raises; CPU tensors take the plain
    version. `fused_attention_qkv.launches` counts kernel launches."""
    if qkv.dim() != 3 or qkv.shape[-1] % (3 * num_heads):
        raise ValueError(f"qkv must be [B, N, 3*H*D] with H={num_heads}; got {tuple(qkv.shape)}")
    if qkv.device.type == "cpu":
        return attention_qkv_reference(qkv, num_heads, scale)
    if qkv.device.type != "cuda":
        raise ValueError(f"no K1 path for device {qkv.device}")
    B, N, W3 = qkv.shape
    D = W3 // (3 * num_heads)
    if D != HEAD_DIM:
        raise ValueError(f"the K1 kernel takes head dim {HEAD_DIM}; got {D}")
    if qkv.dtype != torch.bfloat16:
        raise ValueError(f"the K1 kernel takes bfloat16; got {qkv.dtype}")
    if not qkv.is_contiguous() or qkv.data_ptr() % 16:
        raise ValueError("the K1 kernel takes a contiguous, 16-byte aligned qkv")
    if qkv.requires_grad and torch.is_grad_enabled():
        raise RuntimeError("the K1 kernel has no backward yet; run it under torch.no_grad or inference_mode")
    out = torch.empty((B, N, num_heads * D), dtype=qkv.dtype, device=qkv.device)
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _kernel_fn()(qkv.data_ptr(), out.data_ptr(), B, N, num_heads, D, float(scale), stream)
    if rc != 0:
        raise RuntimeError(f"K1 attention kernel launch failed with CUDA error {rc}")
    fused_attention_qkv.launches += 1
    return out


fused_attention_qkv.launches = 0
