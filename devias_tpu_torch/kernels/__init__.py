"""Hand-written CUDA kernels of the port, each beside its plain version."""

from devias_tpu_torch.kernels.attention import attention_qkv_reference, fused_attention_qkv

__all__ = ["attention_qkv_reference", "fused_attention_qkv"]
