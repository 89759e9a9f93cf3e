"""K1 forward in the PyTorch port: the plain version against the JAX
package's Pallas kernel (interpret mode), and the wrapper's dispatch rules.
Both sides take the same numpy inputs in float32; the tolerance is float32
rounding over a D-term dot and an N-term softmax sum."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from devias_tpu.kernels.attention import fused_attention_qkv as jax_fused_attention_qkv
from devias_tpu_torch.kernels.attention import attention_qkv_reference, fused_attention_qkv


@pytest.mark.parametrize("N", [64, 96, 9])  # 9: ragged, CLS-like token count
def test_plain_version_matches_pallas_kernel(N):
    B, H, D = 2, 4, 16
    rng = np.random.default_rng(N)
    qkv = rng.normal(size=(B, N, 3 * H * D)).astype(np.float32)
    scale = D ** -0.5
    want = np.asarray(jax_fused_attention_qkv(jnp.asarray(qkv), H, scale, None, True))
    got = attention_qkv_reference(torch.from_numpy(qkv), H, scale).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_wrapper_takes_plain_version_on_cpu_without_counting():
    rng = np.random.default_rng(0)
    qkv = torch.from_numpy(rng.normal(size=(2, 9, 3 * 4 * 64)).astype(np.float32))
    before = fused_attention_qkv.launches
    out = fused_attention_qkv(qkv, 4, 0.125)
    assert fused_attention_qkv.launches == before
    torch.testing.assert_close(out, attention_qkv_reference(qkv, 4, 0.125), rtol=0, atol=0)
    assert out.shape == (2, 9, 4 * 64)


def _emulate_kernel(qkv, H, scale, tile=64, mask_ragged_keys=True):
    """The CUDA kernel's rounding in float32 on the CPU: q scaled in bf16,
    logits in f32, exp(s - m) rounded to bf16 and summed as rounded, the
    output rounded to bf16. With `mask_ragged_keys=False` the zero-filled
    keys past N in the last 64-key tile count as logits of 0, the fault
    the smoke's tolerance must catch."""
    B, N, _ = qkv.shape
    q, k, v = qkv.float().view(B, N, 3, H, -1).permute(2, 0, 3, 1, 4)
    s = (q.bfloat16() * scale).float() @ k.transpose(-1, -2)
    pad = 0 if mask_ragged_keys else -N % tile
    s = torch.cat([s, s.new_zeros(*s.shape[:-1], pad)], -1)
    v = torch.cat([v, v.new_zeros(B, H, pad, v.shape[-1])], -2)
    e = torch.exp(s - s.amax(-1, keepdim=True)).bfloat16().float()
    o = (e @ v) / e.sum(-1, keepdim=True)
    return o.bfloat16().float().permute(0, 2, 1, 3).reshape(B, N, -1)


@pytest.mark.parametrize("N", [1568, 1569, 77])
def test_smoke_tolerance_catches_unmasked_ragged_keys(N):
    """`chip_smoke.py` holds K1 to KERNEL_TOL of the f32 output's RMS
    against the plain version in f32. On its N(0, 1) inputs the kernel's
    own rounding stays below that, and a kernel that leaves the ragged keys
    of its last tile unmasked reads above 1.5 times it."""
    from chip_smoke import KERNEL_TOL

    H, D = 6, 64
    rng = np.random.default_rng(N)
    qkv = torch.from_numpy(rng.standard_normal((1, N, 3 * H * D), dtype=np.float32)).bfloat16()
    exact = attention_qkv_reference(qkv.float(), H, D ** -0.5)
    rms = exact.square().mean().sqrt().item()
    good = (_emulate_kernel(qkv, H, D ** -0.5) - exact).abs().max().item() / rms
    bad = (_emulate_kernel(qkv, H, D ** -0.5, mask_ragged_keys=False) - exact).abs().max().item() / rms
    assert good < KERNEL_TOL < bad / 1.5, (good, bad)


def test_wrapper_rejects_bad_shapes():
    with pytest.raises(ValueError, match="3\\*H\\*D"):
        fused_attention_qkv(torch.zeros(2, 9, 100), 4, 0.125)
    with pytest.raises(ValueError, match="3\\*H\\*D"):
        fused_attention_qkv(torch.zeros(9, 3 * 64), 1, 0.125)
