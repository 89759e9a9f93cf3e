"""Hand-written CUDA kernels of the port, each beside its plain version.

`fused_attention` (K3, head-major) and `fused_slot_attention` (K4) are
exported as the JAX package exports its kernels; `fused_attention_qkv` (K1)
is what the models call; `patchify_embed` (K5) is the patch-embed kernel.
K2 and the kernels' plain versions are in `attention`, `slot_attention` and
`patch_embed`.
"""

from devias_tpu_torch.kernels.attention import attention_qkv_reference, fused_attention, fused_attention_qkv
from devias_tpu_torch.kernels.patch_embed import patchify_embed
from devias_tpu_torch.kernels.slot_attention import fused_slot_attention, slot_attention_reference

__all__ = ["attention_qkv_reference", "fused_attention", "fused_attention_qkv", "fused_slot_attention",
           "patchify_embed", "slot_attention_reference"]
