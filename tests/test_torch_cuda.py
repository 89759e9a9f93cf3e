"""K1 on the card: the CUDA kernel against its plain version in bf16, and
the wrapper's refusals. Marked `cuda`; each test skips without a card.
This file imports neither JAX nor the JAX package, so on a machine with a
card and no JAX it runs as
`python -m pytest --noconftest -m cuda tests/test_torch_cuda.py`."""

import numpy as np
import pytest
import torch

from devias_tpu_torch.kernels.attention import attention_qkv_reference, fused_attention_qkv

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize("B,N,H", [(2, 64, 2), (2, 77, 3), (1, 1569, 12), (3, 9, 1)])
def test_kernel_matches_plain_version(card, B, N, H):
    """Errors held relative to the RMS of the f32 output, as `chip_smoke.py`
    holds them: the kernel keeps logits and probabilities in f32 and rounds
    only exp(s - m) and the output to bf16, so it is within 0.04 RMS of the
    plain version evaluated in f32; the plain version in bf16 rounds logits
    and probabilities too and is within 0.25 RMS."""
    rng = np.random.default_rng(N)
    qkv = torch.from_numpy(rng.normal(size=(B, N, 3 * H * 64)).astype(np.float32)).to(card, torch.bfloat16)
    before = fused_attention_qkv.launches
    out = fused_attention_qkv(qkv, H, 0.125)
    torch.cuda.synchronize()
    assert fused_attention_qkv.launches == before + 1
    want = attention_qkv_reference(qkv, H, 0.125)
    exact = attention_qkv_reference(qkv.float(), H, 0.125)
    assert out.shape == want.shape and out.dtype == torch.bfloat16
    assert torch.isfinite(out).all()
    rms = exact.square().mean().sqrt().item()
    assert (out.float() - exact).abs().max().item() <= 0.04 * rms
    assert (out.float() - want.float()).abs().max().item() <= 0.25 * rms


def test_kernel_refuses_what_it_does_not_take(card):
    qkv = torch.zeros(1, 8, 3 * 2 * 64, device=card)
    with pytest.raises(ValueError, match="bfloat16"):
        fused_attention_qkv(qkv, 2, 0.125)
    with pytest.raises(ValueError, match="head dim"):
        fused_attention_qkv(torch.zeros(1, 8, 3 * 4 * 32, device=card, dtype=torch.bfloat16), 4, 0.2)
    with pytest.raises(ValueError, match="contiguous"):
        fused_attention_qkv(torch.zeros(1, 3 * 2 * 64, 8, device=card, dtype=torch.bfloat16).transpose(1, 2), 2, 0.125)
