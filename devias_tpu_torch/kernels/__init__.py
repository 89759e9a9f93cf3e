"""Hand-written CUDA kernels of the port, each beside its plain version.

`fused_attention` (K3, head-major) is exported as the JAX package exports
it; `fused_attention_qkv` (K1) is what the models call. K2 and the
kernels' plain versions are in `attention`.
"""

from devias_tpu_torch.kernels.attention import attention_qkv_reference, fused_attention, fused_attention_qkv

__all__ = ["attention_qkv_reference", "fused_attention", "fused_attention_qkv"]
