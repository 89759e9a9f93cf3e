"""K1 on the card: the CUDA kernels against their plain versions in bf16,
and the wrappers' refusals. Marked `cuda`; each test skips without a card.
This file imports neither JAX nor the JAX package, so on a machine with a
card and no JAX it runs as
`python -m pytest --noconftest -m cuda tests/test_torch_cuda.py`."""

import numpy as np
import pytest
import torch

from chip_smoke import BWD_TOL, STATS_L_TOL, STATS_M_TOL, bwd_errors
from devias_tpu_torch.kernels.attention import (
    attention_qkv_bwd,
    attention_qkv_bwd_reference,
    attention_qkv_fwd_stats,
    attention_qkv_fwd_stats_reference,
    attention_qkv_reference,
    fused_attention_qkv,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _inputs(card, B, N, H, seed):
    rng = np.random.default_rng(seed)
    qkv = torch.from_numpy(rng.normal(size=(B, N, 3 * H * 64)).astype(np.float32)).to(card, torch.bfloat16)
    do = torch.from_numpy(rng.normal(size=(B, N, H * 64)).astype(np.float32)).to(card, torch.bfloat16)
    return qkv, do


SHAPES = [(2, 64, 2), (2, 77, 3), (1, 1569, 12), (3, 9, 1)]


@pytest.mark.parametrize("B,N,H", SHAPES)
def test_kernel_matches_plain_version(card, B, N, H):
    """Errors held relative to the RMS of the f32 output, as `chip_smoke.py`
    holds them: the kernel keeps logits and probabilities in f32 and rounds
    only exp(s - m) and the output to bf16, so it is within 0.04 RMS of the
    plain version evaluated in f32; the plain version in bf16 rounds logits
    and probabilities too and is within 0.25 RMS."""
    qkv, _ = _inputs(card, B, N, H, N)
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


@pytest.mark.parametrize("B,N,H", SHAPES)
def test_stats_kernel_matches_plain_version(card, B, N, H):
    """o as the no-stats form; m within STATS_M_TOL and l within STATS_L_TOL
    of their RMS, against the plain version in f32."""
    qkv, _ = _inputs(card, B, N, H, N + 1)
    before = attention_qkv_fwd_stats.launches
    o, m, l = attention_qkv_fwd_stats(qkv, H, 0.125)
    torch.cuda.synchronize()
    assert attention_qkv_fwd_stats.launches == before + 1
    eo, em, el = attention_qkv_fwd_stats_reference(qkv.float(), H, 0.125)
    assert m.shape == l.shape == (B, H, N) and m.dtype == l.dtype == torch.float32
    rms = eo.square().mean().sqrt().item()
    assert (o.float() - eo).abs().max().item() <= 0.04 * rms
    assert (m - em).abs().max().item() <= STATS_M_TOL * em.square().mean().sqrt().item()
    assert (l - el).abs().max().item() <= STATS_L_TOL * el.square().mean().sqrt().item()


@pytest.mark.parametrize("B,N,H", SHAPES)
def test_bwd_kernel_matches_plain_version(card, B, N, H):
    """dq, dk and dv each within BWD_TOL of their RMS, against the plain
    version on the same bf16 inputs and against the f32 gradient."""
    qkv, do = _inputs(card, B, N, H, N + 2)
    o, m, l = attention_qkv_fwd_stats(qkv, H, 0.125)
    before = attention_qkv_bwd.launches
    got = attention_qkv_bwd(qkv, o, do, m, l, H, 0.125)
    torch.cuda.synchronize()
    assert attention_qkv_bwd.launches == before + 1
    assert got.shape == qkv.shape and got.dtype == torch.bfloat16 and torch.isfinite(got).all()
    plain = attention_qkv_bwd_reference(qkv, o, do, m, l, H, 0.125)
    eo, em, el = attention_qkv_fwd_stats_reference(qkv.float(), H, 0.125)
    exact = attention_qkv_bwd_reference(qkv.float(), eo, do.float(), em, el, H, 0.125)
    assert max(bwd_errors(got, plain, exact)) <= BWD_TOL
    assert max(bwd_errors(got, exact, exact)) <= BWD_TOL


def test_autograd_goes_through_both_kernels(card):
    qkv, do = _inputs(card, 2, 77, 3, 5)
    x = qkv.clone().requires_grad_()
    before = (attention_qkv_fwd_stats.launches, attention_qkv_bwd.launches, fused_attention_qkv.launches)
    fused_attention_qkv(x, 3, 0.125).backward(do)
    torch.cuda.synchronize()
    after = (attention_qkv_fwd_stats.launches, attention_qkv_bwd.launches, fused_attention_qkv.launches)
    assert after == (before[0] + 1, before[1] + 1, before[2])
    o, m, l = attention_qkv_fwd_stats(qkv, 3, 0.125)
    torch.testing.assert_close(x.grad, attention_qkv_bwd(qkv, o, do, m, l, 3, 0.125), rtol=0, atol=0)


def test_kernel_refuses_what_it_does_not_take(card):
    qkv = torch.zeros(1, 8, 3 * 2 * 64, device=card)
    with pytest.raises(ValueError, match="bfloat16"):
        fused_attention_qkv(qkv, 2, 0.125)
    with pytest.raises(ValueError, match="head dim"):
        fused_attention_qkv(torch.zeros(1, 8, 3 * 4 * 32, device=card, dtype=torch.bfloat16), 4, 0.2)
    with pytest.raises(ValueError, match="contiguous"):
        fused_attention_qkv(torch.zeros(1, 3 * 2 * 64, 8, device=card, dtype=torch.bfloat16).transpose(1, 2), 2, 0.125)
    good = torch.zeros(1, 8, 3 * 2 * 64, device=card, dtype=torch.bfloat16)
    o, m, l = attention_qkv_fwd_stats(good, 2, 0.125)
    with pytest.raises(ValueError, match="float32"):
        attention_qkv_bwd(good, o, o, m.bfloat16(), l, 2, 0.125)
    with pytest.raises(ValueError, match="do must be"):
        attention_qkv_bwd(good, o, o[:, :4], m, l, 2, 0.125)
