"""K1-K5 on the card: the CUDA kernels against their plain versions in
bf16, autograd through them, two runs bitwise equal, the wrappers'
refusals, and the tiny CLI commands on the card (head dim 16, so without
K1). Marked `cuda`; each test skips without a card.
This file imports neither JAX nor the JAX package, so on a machine with a
card and no JAX it runs as
`python -m pytest --noconftest -m cuda tests/test_torch_cuda.py`."""

import numpy as np
import pytest
import torch

from chip_smoke import BWD_TOL, STATS_L_TOL, STATS_M_TOL, bwd_errors, grad_errors, q_kv_bwd_errors
from devias_tpu_torch.kernels.attention import (
    attention_head_major_bwd,
    attention_head_major_bwd_reference,
    attention_head_major_reference,
    attention_q_kv_bwd,
    attention_q_kv_bwd_reference,
    attention_q_kv_fwd_stats,
    attention_q_kv_fwd_stats_reference,
    attention_q_kv_reference,
    attention_qkv_bwd,
    attention_qkv_bwd_reference,
    attention_qkv_fwd_stats,
    attention_qkv_fwd_stats_reference,
    attention_qkv_reference,
    fused_attention,
    fused_attention_q_kv,
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


# (B, N, H): each edge of the kernels' 128-row tiles (under one tile, one
# short of it, exactly one, one over), the student's 1568 and the teacher's
# 1569 tokens, the multi-task student's 1570 (last q and key tiles of 34
# rows), the tensor-parallel student's 6 of 12 heads at 1568 tokens, and
# the small shapes
SHAPES = [(2, 64, 2), (2, 77, 3), (1, 1569, 12), (3, 9, 1), (2, 127, 2), (2, 128, 2), (1, 129, 3),
          (1, 1568, 12), (2, 1570, 12), (2, 1568, 6)]


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


def _normal(card, shape, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(card, torch.bfloat16)


def _rms(t):
    return t.float().square().mean().sqrt().item()


# (B, Nq, Nk, H): ragged on both axes, whole tiles, the four-shard shape
Q_KV_SHAPES = [(2, 77, 301, 3), (2, 64, 128, 2), (1, 392, 1568, 12), (3, 9, 9, 1)]


@pytest.mark.parametrize("B,Nq,Nk,H", Q_KV_SHAPES)
def test_q_kv_kernels_match_plain_versions(card, B, Nq, Nk, H):
    """K2: the no-stats and stats forwards within 0.04 of the f32 output's
    RMS, m within STATS_M_TOL and l within STATS_L_TOL of their RMS, and dq,
    dk, dv within BWD_TOL of their RMS against the plain version on the
    same inputs and against the f32 gradient."""
    q, kv, do = _normal(card, (B, Nq, H * 64), Nq), _normal(card, (B, Nk, 2 * H * 64), Nk), _normal(card, (B, Nq, H * 64), 1)
    before = (fused_attention_q_kv.launches, attention_q_kv_fwd_stats.launches, attention_q_kv_bwd.launches)
    out = fused_attention_q_kv(q, kv, H, 0.125)
    o, m, l = attention_q_kv_fwd_stats(q, kv, H, 0.125)
    dq, dkv = attention_q_kv_bwd(q, kv, o, do, m, l, H, 0.125)
    torch.cuda.synchronize()
    after = (fused_attention_q_kv.launches, attention_q_kv_fwd_stats.launches, attention_q_kv_bwd.launches)
    assert after == tuple(b + 1 for b in before)
    eo, em, el = attention_q_kv_fwd_stats_reference(q.float(), kv.float(), H, 0.125)
    exact = attention_q_kv_reference(q.float(), kv.float(), H, 0.125)
    assert out.shape == o.shape == q.shape and m.shape == l.shape == (B, H, Nq)
    assert (out.float() - exact).abs().max().item() <= 0.04 * _rms(exact)
    assert (o.float() - eo).abs().max().item() <= 0.04 * _rms(eo)
    assert (m - em).abs().max().item() <= STATS_M_TOL * _rms(em)
    assert (l - el).abs().max().item() <= STATS_L_TOL * _rms(el)
    assert dq.shape == q.shape and dkv.shape == kv.shape and torch.isfinite(dkv).all()
    plain = attention_q_kv_bwd_reference(q, kv, o, do, m, l, H, 0.125)
    grads_exact = attention_q_kv_bwd_reference(q.float(), kv.float(), eo, do.float(), em, el, H, 0.125)
    assert max(q_kv_bwd_errors((dq, dkv), plain, grads_exact)) <= BWD_TOL
    assert max(q_kv_bwd_errors((dq, dkv), grads_exact, grads_exact)) <= BWD_TOL


def test_q_kv_autograd_goes_through_both_kernels(card):
    q, kv, do = _normal(card, (2, 77, 3 * 64), 1), _normal(card, (2, 140, 6 * 64), 2), _normal(card, (2, 77, 3 * 64), 3)
    x, y = q.clone().requires_grad_(), kv.clone().requires_grad_()
    before = (attention_q_kv_fwd_stats.launches, attention_q_kv_bwd.launches, fused_attention_q_kv.launches)
    fused_attention_q_kv(x, y, 3, 0.125).backward(do)
    torch.cuda.synchronize()
    after = (attention_q_kv_fwd_stats.launches, attention_q_kv_bwd.launches, fused_attention_q_kv.launches)
    assert after == (before[0] + 1, before[1] + 1, before[2])
    o, m, l = attention_q_kv_fwd_stats(q, kv, 3, 0.125)
    dq, dkv = attention_q_kv_bwd(q, kv, o, do, m, l, 3, 0.125)
    torch.testing.assert_close(x.grad, dq, rtol=0, atol=0)
    torch.testing.assert_close(y.grad, dkv, rtol=0, atol=0)


@pytest.mark.parametrize("B,H,N", [(2, 3, 77), (2, 2, 64), (1, 12, 1568), (3, 1, 9)])
def test_head_major_kernels_match_plain_versions(card, B, H, N):
    """K3: the forward within 0.04 of the f32 output's RMS and 0.25 of it
    against the plain version in bf16; dq, dk, dv within BWD_TOL of their
    RMS against the plain backward and the f32 gradient; autograd runs the
    two kernels once each."""
    q, k, v, do = (_normal(card, (B, H, N, 64), N + i) for i in range(4))
    xs = [t.clone().requires_grad_() for t in (q, k, v)]
    before = (fused_attention.launches, attention_head_major_bwd.launches)
    out = fused_attention(*xs, 0.125)
    out.backward(do)
    torch.cuda.synchronize()
    assert (fused_attention.launches, attention_head_major_bwd.launches) == (before[0] + 1, before[1] + 1)
    exact = attention_head_major_reference(q.float(), k.float(), v.float(), 0.125)
    plain = attention_head_major_reference(q, k, v, 0.125)
    assert out.shape == q.shape and out.dtype == torch.bfloat16 and torch.isfinite(out).all()
    assert (out.float() - exact).abs().max().item() <= 0.04 * _rms(exact)
    assert (out.float() - plain.float()).abs().max().item() <= 0.25 * _rms(exact)
    grads = [x.grad for x in xs]
    want = attention_head_major_bwd_reference(q, k, v, out.detach(), do, 0.125)
    grads_exact = attention_head_major_bwd_reference(q.float(), k.float(), v.float(), exact, do.float(), 0.125)
    assert max(grad_errors(grads, want, grads_exact)) <= BWD_TOL
    assert max(grad_errors(grads, grads_exact, grads_exact)) <= BWD_TOL


def test_backward_kernels_are_deterministic(card):
    """Every output tile of the backward has one owner and no atomics: two
    runs of K1-bwd (at the teacher's 1569 and the multi-task student's 1570
    tokens), K2-bwd and K3-bwd on the same inputs are bitwise equal."""
    for N in (1569, 1570):
        qkv, do = _inputs(card, 2, N, 12, 9)
        o, m, l = attention_qkv_fwd_stats(qkv, 12, 0.125)
        first = attention_qkv_bwd(qkv, o, do, m, l, 12, 0.125)
        assert torch.equal(first, attention_qkv_bwd(qkv, o, do, m, l, 12, 0.125)), N
    q, kv, dq_o = _normal(card, (2, 392, 12 * 64), 1), _normal(card, (2, 1568, 24 * 64), 2), _normal(card, (2, 392, 12 * 64), 3)
    o, m, l = attention_q_kv_fwd_stats(q, kv, 12, 0.125)
    first = attention_q_kv_bwd(q, kv, o, dq_o, m, l, 12, 0.125)
    again = attention_q_kv_bwd(q, kv, o, dq_o, m, l, 12, 0.125)
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    q, k, v, dh = (_normal(card, (2, 3, 77, 64), 10 + i) for i in range(4))
    out = fused_attention(q, k, v, 0.125)
    first = attention_head_major_bwd(q, k, v, out, dh, 0.125)
    again = attention_head_major_bwd(q, k, v, out, dh, 0.125)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, again))


def test_kernels_refuse_a_scale_that_is_not_a_power_of_two(card):
    """The kernels fold the logit scale into the exponent, which is exact
    only for a power of two; any other scale is refused before a launch."""
    qkv = torch.zeros(1, 8, 3 * 2 * 64, device=card, dtype=torch.bfloat16)
    hm = torch.zeros(1, 2, 8, 64, device=card, dtype=torch.bfloat16)
    before = fused_attention_qkv.launches
    with pytest.raises(ValueError, match="power of two"):
        fused_attention_qkv(qkv, 2, 0.2)
    with pytest.raises(ValueError, match="power of two"):
        attention_qkv_fwd_stats(qkv, 2, 0.1)
    with pytest.raises(ValueError, match="power of two"):
        fused_attention_q_kv(qkv[..., :128].contiguous(), qkv[..., 128:].contiguous(), 2, 0.3)
    with pytest.raises(ValueError, match="power of two"):
        fused_attention(hm, hm, hm, 0.2)
    assert fused_attention_qkv.launches == before


def test_split_kernels_refuse_what_they_do_not_take(card):
    q, kv = torch.zeros(1, 8, 128, device=card), torch.zeros(1, 8, 256, device=card)
    with pytest.raises(ValueError, match="bfloat16"):
        fused_attention_q_kv(q, kv, 2, 0.125)
    with pytest.raises(ValueError, match="head dim"):
        fused_attention_q_kv(q.bfloat16(), kv.bfloat16(), 4, 0.125)
    with pytest.raises(ValueError, match="contiguous"):
        wide = torch.zeros(1, 8, 384, device=card, dtype=torch.bfloat16)
        fused_attention_q_kv(wide[..., :128], kv.bfloat16(), 2, 0.125)
    hm = torch.zeros(1, 2, 8, 64, device=card, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="bfloat16"):
        fused_attention(hm.float(), hm.float(), hm.float(), 0.125)
    with pytest.raises(ValueError, match="contiguous"):
        fused_attention(hm.transpose(1, 2), hm.transpose(1, 2), hm.transpose(1, 2), 0.125)
    with pytest.raises(ValueError, match="head dim"):
        fused_attention(hm[..., :32].contiguous(), hm[..., :32].contiguous(), hm[..., :32].contiguous(), 0.125)


@pytest.mark.parametrize("N", [64, 100, 301])
def test_slot_attention_kernel_matches_plain_version(card, N):
    """K4 at a small width (D=128, 4 heads x 64) on bf16 inputs: out and
    sim within chip_smoke.py's KERNEL_TOL of the f32 plain version's RMS,
    the backward (autograd of the plain version) finite."""
    from devias_tpu_torch.kernels import fused_slot_attention, slot_attention_reference

    rng = np.random.default_rng(N)
    shapes = ((2, 2, 128, 1.0), (2, N, 128, 1.0), (128, 256, 0.05), (128, 256, 0.05), (128, 256, 0.05),
              (256, 128, 0.05), (128, 0.05))
    xs = [torch.from_numpy((rng.normal(size=s[:-1]) * s[-1]).astype(np.float32)).to(card, torch.bfloat16)
          for s in shapes]
    leaves = [x.clone().requires_grad_() for x in xs]
    before = fused_slot_attention.launches
    out, sim = fused_slot_attention(*leaves, 4, 64)
    torch.cuda.synchronize()
    assert fused_slot_attention.launches == before + 1
    assert out.shape == (2, 2, 128) and out.dtype == torch.bfloat16 and sim.shape == (2, 4, 2, N)
    e_out, e_sim = slot_attention_reference(*(x.float() for x in xs), 4, 64)
    assert (out.float() - e_out).abs().max().item() <= 0.04 * _rms(e_out)
    assert (sim - e_sim).abs().max().item() <= 0.04 * _rms(e_sim)
    (out.float().square().sum() + sim.square().sum()).backward()
    assert all(torch.isfinite(x.grad).all() for x in leaves)


def test_slot_attention_kernel_refuses_what_it_does_not_take(card):
    from devias_tpu_torch.kernels import fused_slot_attention

    xs = [torch.zeros(s, device=card) for s in ((1, 2, 128), (1, 9, 128), (128, 256), (128, 256), (128, 256),
                                                (256, 128), (128,))]
    with pytest.raises(ValueError, match="bfloat16"):
        fused_slot_attention(*xs, 4, 64)
    with pytest.raises(ValueError, match="dim_head"):
        fused_slot_attention(*(x.bfloat16() for x in xs), 8, 32)


@pytest.mark.parametrize("shape", [(2, 4, 48, 80, 3), (1, 2, 32, 32, 3)])
def test_patch_embed_kernel_matches_plain_version(card, shape):
    from devias_tpu_torch.kernels import patchify_embed
    from devias_tpu_torch.kernels.patch_embed import patchify_embed_reference

    rng = np.random.default_rng(sum(shape))
    x = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(card)
    kernel = torch.from_numpy((rng.normal(size=(1536, 768)) * 0.025).astype(np.float32)).to(card, torch.bfloat16)
    before = patchify_embed.launches
    out = patchify_embed(x, kernel)
    torch.cuda.synchronize()
    assert patchify_embed.launches == before + 1
    exact = patchify_embed_reference(x, kernel.float())
    plain = patchify_embed_reference(x, kernel)
    assert out.shape == plain.shape and out.dtype == torch.bfloat16
    assert (out.float() - exact).abs().max().item() <= 0.04 * _rms(exact)
    assert (out.float() - plain.float()).abs().max().item() <= 0.25 * _rms(exact)


def test_patch_embed_kernel_refuses_what_it_does_not_take(card):
    from devias_tpu_torch.kernels import patchify_embed

    x, kernel = torch.zeros(1, 2, 32, 32, 3, device=card), torch.zeros(1536, 64, device=card, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="f32 clip"):
        patchify_embed(x.bfloat16(), kernel)
    with pytest.raises(ValueError, match="multiple of 8"):
        patchify_embed(x, torch.zeros(1536, 60, device=card, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="contiguous"):
        patchify_embed(x.transpose(2, 3), kernel)


def test_slot_attention_and_patch_embed_kernels_are_deterministic(card):
    """K4 sums its key chunks and K5 its K loop in a fixed order, with no
    atomics: two runs on the same inputs are bitwise equal, at the flagship
    agg round's widths (D=768, 4 heads x 512, N=1568) and the flagship clip."""
    from devias_tpu_torch.kernels import fused_slot_attention, patchify_embed

    rng = np.random.default_rng(11)
    shapes = ((2, 2, 768, 1.0), (2, 1568, 768, 1.0), (768, 2048, 0.02), (768, 2048, 0.02), (768, 2048, 0.02),
              (2048, 768, 0.02), (768, 0.02))
    xs = [torch.from_numpy((rng.normal(size=s[:-1]) * s[-1]).astype(np.float32)).to(card, torch.bfloat16)
          for s in shapes]
    with torch.no_grad():
        first = fused_slot_attention(*xs, 4, 512)
        again = fused_slot_attention(*xs, 4, 512)
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    x = torch.from_numpy(rng.normal(size=(12, 16, 224, 224, 3)).astype(np.float32)).to(card)
    kernel = torch.from_numpy((rng.normal(size=(1536, 768)) * 0.025).astype(np.float32)).to(card, torch.bfloat16)
    first = patchify_embed(x, kernel)
    torch.cuda.synchronize()
    assert torch.equal(first, patchify_embed(x, kernel))


def test_tiny_cli_trains_and_evaluates_on_the_card(card, tmp_path):
    """The README's `--smoke_tiny` command without `--device cpu`: one
    epoch of training, validation and the final test on the card, finite
    metrics, and no K1 launch (head dim 16 is not the kernel's)."""
    import json

    from chip_smoke import TINY_CLI_FLAGS, write_tiny_filelists
    from devias_tpu_torch.cli import run_slot_finetuning as cli
    from devias_tpu_torch.kernels import attention

    write_tiny_filelists(str(tmp_path / "fl"))
    attention.reset_launch_counts()
    result = cli.main(cli.get_args(TINY_CLI_FLAGS + ["--data_path", str(tmp_path / "fl"),
                                                     "--output_dir", str(tmp_path / "out")]))
    torch.cuda.synchronize()
    assert not any(attention.launch_counts().values())
    assert [e["epoch"] for e in result["epochs"]] == [0] and np.isfinite(result["final_top1"])
    records = [json.loads(line) for line in (tmp_path / "out" / "log.txt").read_text().splitlines() if line.strip()]
    numbers = [v for r in records for k, v in r.items() if k.startswith(("train_", "val_", "final_"))]
    assert records and numbers and all(np.isfinite(v) for v in numbers)


TINY_FLAGS = ["--smoke_tiny", "--synthetic_data", "--batch_size", "4", "--epochs", "1", "--num_frames", "8",
              "--input_size", "32", "--short_side_size", "32"]


def _finite_records(path):
    import json

    records = [json.loads(line) for line in path.read_text().splitlines() if line.strip()]
    numbers = [v for r in records for k, v in r.items() if k.startswith(("train_", "val_", "final_"))]
    return bool(records) and bool(numbers) and all(np.isfinite(v) for v in numbers)


def test_tiny_hvu_cli_trains_and_evaluates_on_the_card(card, tmp_path):
    """`run_slot_finetuning_hvu --smoke_tiny --mask_model FAME` on the card
    (FAME-HVU, the HVU step, validation), then `eval_slot_finetuning_hvu`
    on a SEEN/UNSEEN pair with its checkpoint: finite metrics, the four
    blocks, and no K1 launch (head dim 16 is not the kernel's)."""
    from devias_tpu_torch.cli import eval_slot_finetuning_hvu as hvu_eval
    from devias_tpu_torch.cli import run_slot_finetuning_hvu as hvu
    from devias_tpu_torch.kernels import attention

    for name, n in (("train.csv", 16), ("val.csv", 8), ("seen.csv", 8), ("unseen.csv", 4)):
        (tmp_path / name).write_text("\n".join(f"{name[0]}{i} {(7 * i) % 739} {(5 * i) % 248}" for i in range(n)))
    flags = TINY_FLAGS + ["--agg_depth", "2", "--mask_model", "FAME"]
    attention.reset_launch_counts()
    result = hvu.main(hvu.get_args(flags + ["--data_path", str(tmp_path), "--output_dir", str(tmp_path / "out")]))
    blocks = hvu_eval.main(hvu_eval.get_args(flags + [
        "--anno_path", str(tmp_path / "seen.csv"), str(tmp_path / "unseen.csv"),
        "--finetune", str(tmp_path / "out" / "ckpt" / "checkpoint-0.pth")]))
    torch.cuda.synchronize()
    assert not any(attention.launch_counts().values())
    assert [e["epoch"] for e in result["epochs"]] == [0] and _finite_records(tmp_path / "out" / "log.txt")
    assert set(blocks) == {"action_seen", "scene_seen", "action_unseen", "scene_unseen"}
    assert all(np.isfinite(v) for b in blocks.values() for v in b.values())


def test_tiny_class_cli_trains_on_the_card(card, tmp_path):
    """`run_class_finetuning --smoke_tiny --opt sgd --use_cls` with mixup
    and `--scene_labels_from` a tiny CLS teacher on the card: one epoch,
    validation, the final test; finite metrics, SGD's momentum buffers in
    the checkpoint, no K1 launch."""
    from devias_tpu_torch.cli import run_class_finetuning as cls_cli
    from devias_tpu_torch.kernels import attention
    from devias_tpu_torch.nn import create_model

    for name, n in (("train.csv", 16), ("val.csv", 8), ("test.csv", 8)):
        (tmp_path / name).write_text("\n".join(f"{name[0]}{i}.mp4 {i % 365}" for i in range(n)))
    teacher = create_model("vit_base_patch16_224", device="cpu", seed=3, depth=2, embed_dim=64, num_heads=4,
                           num_classes=365, use_mean_pooling=False)
    torch.save({"model": teacher.state_dict()}, tmp_path / "teacher.pth")
    attention.reset_launch_counts()
    result = cls_cli.main(cls_cli.get_args(TINY_FLAGS + [
        "--data_set", "UCF101", "--nb_classes", "365", "--use_cls", "--opt", "sgd", "--mixup", "0.8", "--cutmix", "1.0",
        "--test_num_segment", "1", "--test_num_crop", "1", "--scene_labels_from", str(tmp_path / "teacher.pth"),
        "--data_path", str(tmp_path), "--output_dir", str(tmp_path / "out")]))
    torch.cuda.synchronize()
    assert not any(attention.launch_counts().values())
    assert np.isfinite(result["final_top1"]) and _finite_records(tmp_path / "out" / "log.txt")
    state = torch.load(tmp_path / "out" / "ckpt" / "checkpoint-0.pth", weights_only=True)["optimizer"]["state"]
    assert all(set(v) == {"momentum_buffer"} for v in state.values())


def test_tiny_downstream_cli_trains_and_evaluates_on_the_card(card, tmp_path):
    """`run_slot_downstream --smoke_tiny` (concat, MLP fusion head, tied agg)
    on the card: `--finetune` on a tiny slot checkpoint, one epoch,
    validation, the final test; then `--eval` on its checkpoint (the same
    top-1); finite metrics, no K1 launch."""
    from devias_tpu_torch.cli import run_slot_downstream as ds_cli
    from devias_tpu_torch.kernels import attention
    from devias_tpu_torch.nn import create_model

    for name, n in (("train.csv", 16), ("val.csv", 8), ("test.csv", 8)):
        (tmp_path / name).write_text("\n".join(f"{name[0]}{i}.mp4 {i % 5}" for i in range(n)))
    slot = create_model("slot_vit_base_patch16_224", device="cpu", seed=3, depth=2, embed_dim=64, num_heads=4,
                        num_classes=5, num_latents=2, agg_depth=2, img_size=32)
    torch.save({"model": slot.state_dict()}, tmp_path / "slot.pth")
    flags = TINY_FLAGS + ["--data_set", "UCF101", "--nb_classes", "5", "--downstream_nb_classes", "5",
                          "--num_latents", "2", "--agg_depth", "2", "--agg_weights_tie", "--head_type", "mlp",
                          "--test_num_segment", "1", "--test_num_crop", "1", "--data_path", str(tmp_path)]
    attention.reset_launch_counts()
    result = ds_cli.main(ds_cli.get_args(flags + ["--finetune", str(tmp_path / "slot.pth"),
                                                  "--output_dir", str(tmp_path / "out")]))
    again = ds_cli.main(ds_cli.get_args(flags + ["--eval", "--finetune",
                                                 str(tmp_path / "out" / "ckpt" / "checkpoint-0.pth"),
                                                 "--output_dir", str(tmp_path / "eval")]))
    torch.cuda.synchronize()
    assert not any(attention.launch_counts().values())
    assert np.isfinite(result["final_top1"]) and _finite_records(tmp_path / "out" / "log.txt")
    assert again["eval"]["top1"] == result["final_top1"]


def test_tiny_multi_task_cli_trains_and_evaluates_on_the_card(card, tmp_path):
    """`run_multi_task_finetuning --smoke_tiny --unified_head` with a tiny
    CLS teacher from `--scene_model_path` on the card: one epoch,
    validation, the final test; then `--eval --eval_scene` on its
    checkpoint (the same top-1, a finite scene test); no K1 launch."""
    from devias_tpu_torch.cli import run_multi_task_finetuning as mt_cli
    from devias_tpu_torch.kernels import attention
    from devias_tpu_torch.nn import create_model

    for name, n in (("train.csv", 16), ("val.csv", 8), ("test.csv", 8)):
        (tmp_path / name).write_text("\n".join(f"{name[0]}{i}.mp4 {i % 5}" for i in range(n)))
    teacher = create_model("vit_base_patch16_224", device="cpu", seed=3, depth=2, embed_dim=64, num_heads=4,
                           num_classes=365, use_mean_pooling=False)
    torch.save({"model": teacher.state_dict()}, tmp_path / "teacher.pth")
    flags = TINY_FLAGS + ["--data_set", "UCF101", "--nb_classes", "5", "--unified_head", "--test_num_segment", "1",
                          "--test_num_crop", "1", "--scene_model_path", str(tmp_path / "teacher.pth"),
                          "--data_path", str(tmp_path)]
    attention.reset_launch_counts()
    result = mt_cli.main(mt_cli.get_args(flags + ["--output_dir", str(tmp_path / "out")]))
    again = mt_cli.main(mt_cli.get_args(flags + ["--eval", "--eval_scene", "--finetune",
                                                 str(tmp_path / "out" / "ckpt" / "checkpoint-0.pth"),
                                                 "--output_dir", str(tmp_path / "eval")]))
    torch.cuda.synchronize()
    assert not any(attention.launch_counts().values())
    assert np.isfinite(result["final_top1"]) and _finite_records(tmp_path / "out" / "log.txt")
    assert again["eval"]["top1"] == result["final_top1"]
    assert np.isfinite(list(again["eval_scene"].values())).all()


def test_checkpointed_block_gradients_equal_the_plain_blocks(card):
    """K1 through a ViT-B block (bf16, B=2, N=1568) with dropout and
    drop-path at 0.1 from a card generator: under `checkpointed_block` the
    input and parameter gradients equal those without checkpointing
    bitwise, and so does the generator's state after the step; the stats
    forward runs twice (the forward and the recompute), the backward once."""
    from devias_tpu_torch.nn.vit import Block, checkpointed_block, init_weights

    block = Block(768, 12, fused_attention=True, dtype=torch.bfloat16, drop=0.1, drop_path_rate=0.1)
    init_weights(block, torch.Generator().manual_seed(0))
    block = block.to(card).train()
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(2, 1568, 768)).astype(np.float32)).to(card)
    w = torch.from_numpy(np.random.default_rng(2).normal(size=(2, 1568, 768)).astype(np.float32)).to(card)
    runs = {}
    for remat in (False, True):
        block.zero_grad()
        attention_qkv_fwd_stats.launches = attention_qkv_bwd.launches = 0
        g = torch.Generator(device=card).manual_seed(3)
        xb = x.to(torch.bfloat16).requires_grad_()
        y = checkpointed_block(block, xb, g, None, None) if remat else block(xb, g)
        (y.float() * w).sum().backward()
        torch.cuda.synchronize()
        runs[remat] = (xb.grad.clone(), {n: p.grad.clone() for n, p in block.named_parameters()}, g.get_state(),
                       (attention_qkv_fwd_stats.launches, attention_qkv_bwd.launches))
    (gx, grads, state, launches), (gx_r, grads_r, state_r, launches_r) = runs[False], runs[True]
    assert launches == (1, 1) and launches_r == (2, 1)
    assert torch.equal(gx, gx_r) and torch.equal(state, state_r)
    for name, grad in grads.items():
        assert torch.equal(grads_r[name], grad), name


def test_int8_dot_on_the_card_equals_the_cpu(card):
    """`int8_dot` at the teacher's qkv shape for 2 clips (3138 x 768 x
    2304): the int32 products are exact on both, so the card's result is
    the CPU's within 1e-6 relative (bitwise expected)."""
    from devias_tpu_torch.nn.quant import int8_dot

    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.normal(size=(2, 1569, 768)).astype(np.float32)).to(torch.bfloat16)
    w = torch.from_numpy((rng.normal(size=(2304, 768)) * 0.02).astype(np.float32))
    want = int8_dot(x, w)
    got = int8_dot(x.to(card), w.to(card)).cpu()
    assert got.shape == want.shape == (2, 1569, 2304)
    assert (got - want).abs().max().item() <= 1e-6 * want.abs().max().item()


@pytest.mark.parametrize("qk_scale", [None, 0.1], ids=["default", "scale_0.1"])
def test_geometry_attention_through_k1_matches_its_plain_version(card, qk_scale):
    """A ViT-B `Attention` without q/v biases at N = 392 (32x32 patches of
    16x224x224 clips), bf16, with K1 and with its plain version on the same
    weights: one K1 launch (a scale that is not a power of two applied to
    q before the kernel), the outputs within the kernel phase's PLAIN_TOL
    of the plain output's RMS; `return_attn=True` launches nothing and its
    probability rows sum to 1."""
    from chip_smoke import PLAIN_TOL
    from devias_tpu_torch.nn.vit import Attention, init_weights

    attn = Attention(768, 12, fused=True, dtype=torch.bfloat16, qkv_bias=False, qk_scale=qk_scale)
    init_weights(attn, torch.Generator().manual_seed(5))
    attn = attn.to(card).eval()
    x = torch.from_numpy(np.random.default_rng(6).normal(size=(2, 392, 768)).astype(np.float32)).to(card)
    x = x.to(torch.bfloat16)
    with torch.no_grad():
        fused_attention_qkv.launches = 0
        got = attn(x).float()
        assert fused_attention_qkv.launches == 1
        plain_out, probs = attn(x, return_attn=True)
        assert fused_attention_qkv.launches == 1
    want = plain_out.float()
    rms = want.square().mean().sqrt().item()
    assert (got - want).abs().max().item() <= PLAIN_TOL * rms
    assert (probs.float().sum(-1) - 1).abs().max().item() <= 1e-2


# the train step captured as a CUDA graph (`train/graph.py`): a slot ViT
# with K1's head dim, two blocks of two heads on 4 x 64 x 64 clips (32
# tokens), drop-path on, so the generator's draws enter the step
GRAPH_WIDTH = dict(depth=2, embed_dim=128, num_heads=2, num_frames=4, fused_attention=True, dtype=torch.bfloat16)
GRAPH_SLOT = dict(num_classes=5, num_scene_classes=4, num_latents=2, agg_depth=2, drop_path_rate=0.1, img_size=64,
                  **GRAPH_WIDTH)
GRAPH_B = 4


def _graph_data(card, steps, B=GRAPH_B):
    g = torch.Generator(device=card).manual_seed(11)
    return [({"videos": torch.randn((B, 4, 64, 64, 3), generator=g, device=card),
              "labels": torch.randint(0, 5, (B,), generator=g, device=card),
              "scene_labels": torch.randint(0, 4, (B,), generator=g, device=card)},
             {"perm": torch.rand(B, generator=g, device=card).argsort(),
              "keep": torch.rand(B, generator=g, device=card) < 0.5}) for _ in range(steps)]


def _graph_step(card, hvu):
    from devias_tpu_torch.losses import SlotLossConfig
    from devias_tpu_torch.nn import create_model
    from devias_tpu_torch.train import (OptimConfig, TrainState, TrainStepConfig, make_hvu_train_step,
                                        make_optimizer, make_slot_train_step)

    model = create_model("slot_vit_base_patch16_224", device=card, seed=0, **GRAPH_SLOT)
    opt, lr_fn = make_optimizer(model, OptimConfig(lr=1e-3, total_steps=10, warmup_steps=2, layer_decay=0.75,
                                                   agg_block_scale=0.1, num_layers=2), device=card)
    state = TrainState.create(model, opt, use_ema=True, device=card)
    loss_cfg = SlotLossConfig(num_action_classes=5, num_scene_classes=4)
    if hvu:
        step = make_hvu_train_step(model, opt, loss_cfg, TrainStepConfig(), lr_fn, device=card)
    else:
        teacher = create_model("vit_base_patch16_224", device=card, seed=1, num_classes=4, use_mean_pooling=False,
                               img_size=64, **GRAPH_WIDTH)
        step = make_slot_train_step(model, teacher, opt, loss_cfg, TrainStepConfig(), lr_fn, device=card)
    return model, opt, state, step


def _three_steps(card, hvu):
    """Three steps from the seed's weights, draws and generator; what they
    leave behind. The metrics are held as returned until the end."""
    from devias_tpu_torch.kernels import attention

    model, opt, state, step = _graph_step(card, hvu)
    gen = torch.Generator(device=card).manual_seed(5)
    attention.reset_launch_counts()
    held = [step(state, batch, generator=gen, draws=draws) for batch, draws in _graph_data(card, 3)]
    torch.cuda.synchronize()
    params = list(model.parameters())
    return {"metrics": [{k: float(v) for k, v in m.items()} for m in held],
            "exp_avg": [opt.state[p]["exp_avg"].clone() for p in params],
            "params": [p.detach().clone() for p in params],
            "ema": [e.clone() for e in state.ema_params.values()],
            "gen": gen.get_state(), "launches": attention.launch_counts(), "step": step,
            "counts": (state.step, opt.count, int(opt._counter))}


def _gap(a, b):
    """The largest difference between two runs' metrics and tensors."""
    gap = max(abs(x[k] - y[k]) for x, y in zip(a["metrics"], b["metrics"]) for k in x)
    for key in ("exp_avg", "params", "ema"):
        gap = max(gap, max(float((x - y).abs().max()) for x, y in zip(a[key], b[key])))
    return gap


@pytest.mark.parametrize("hvu", [False, True], ids=["slot", "hvu"])
def test_replayed_steps_equal_eager_steps(card, monkeypatch, capsys, hvu):
    """Three steps replayed from the captured graph against three eager
    steps (capture forbidden), from the same weights, clips, draws and
    generator state: the loss terms, Adam's first moments, the parameters
    and the EMA as close as two eager runs are to each other (bitwise
    where those are), the generator's state after them equal, and K1's
    launch counts equal. The first call captured and replayed: all three
    steps are replays."""
    import devias_tpu_torch.train.step as step_module

    with monkeypatch.context() as m:
        m.setattr(step_module, "graph_safe", lambda *a: False)
        eager = _three_steps(card, hvu)
        again = _three_steps(card, hvu)
    graphed = _three_steps(card, hvu)
    assert eager["step"].graph.replays == 0 and eager["step"].graph.graph is None
    sg = graphed["step"].graph
    assert not sg.failed and sg.replays == 3
    assert graphed["counts"] == eager["counts"] == (3, 3, 3)
    assert torch.equal(graphed["gen"], eager["gen"])
    assert graphed["launches"] == eager["launches"]
    assert graphed["launches"]["K1-fwd-stats"] == graphed["launches"]["K1-bwd"] == 3 * 2
    assert graphed["launches"]["K1-fwd"] == (0 if hvu else 3 * 2)
    with capsys.disabled():
        print(f"GRAPH-GAP {'hvu' if hvu else 'slot'}: replayed against eager {_gap(graphed, eager)}, "
              f"eager against eager {_gap(again, eager)}")
    assert _gap(graphed, eager) <= _gap(again, eager), (_gap(graphed, eager), _gap(again, eager))
    assert all(np.isfinite(v) for m in graphed["metrics"] for v in m.values())


def test_a_changed_batch_runs_eager_and_run_ahead_stays_two(card):
    """After the capture, a batch of another size runs eager and the
    captured batch replays again; replay n starts only once replay n - 2
    has finished, and no more than two are in flight. A loaded optimizer
    state (new tensors) drops the graph, and the next call captures one
    that updates the loaded tensors."""
    import copy

    model, opt, state, step = _graph_step(card, hvu=False)
    gen = torch.Generator(device=card).manual_seed(5)
    sg = step.graph
    events = []
    record = sg._recorded_event

    def recorded():
        events.append(record())
        return events[-1]

    sg._recorded_event = recorded
    data = _graph_data(card, 2)
    for n in range(1, 7):
        batch, draws = data[n % 2]
        step(state, batch, generator=gen, draws=draws)
        assert len(sg.inflight) <= 2
        if n >= 3:
            assert events[n - 3].query()
    assert sg.replays == 6
    (small, small_draws), = _graph_data(card, 1, B=2)
    m = step(state, small, generator=gen, draws=small_draws)
    assert sg.replays == 6 and np.isfinite(float(m["loss"]))
    batch, draws = data[0]
    step(state, batch, generator=gen, draws=draws)
    torch.cuda.synchronize()
    assert sg.replays == 7 and state.step == opt.count == int(opt._counter) == 8
    first = sg.graph
    opt.load_state_dict(copy.deepcopy(opt.state_dict()))
    loaded = opt.state[next(model.parameters())]["exp_avg"]
    before = loaded.clone()
    step(state, batch, generator=gen, draws=draws)
    torch.cuda.synchronize()
    assert sg.graph is not None and sg.graph is not first and sg.replays == 8
    assert not torch.equal(loaded, before) and state.step == opt.count == int(opt._counter) == 9


def test_which_other_steps_capture(card, capsys):
    """The classification step with mixup and the multi-task step on the
    card: two steps each, finite; whether each captured is printed
    (`GRAPH-CAPTURE`), as the step decides it for itself."""
    from devias_tpu_torch.aug.mixup import MixupConfig
    from devias_tpu_torch.losses.slot_loss import soft_target_cross_entropy
    from devias_tpu_torch.nn import create_model
    from devias_tpu_torch.train import (OptimConfig, TrainState, make_classification_train_step,
                                        make_multi_task_train_step, make_optimizer)

    data = _graph_data(card, 2)
    width = dict(GRAPH_WIDTH, img_size=64)
    seen = {}
    model = create_model("vit_base_patch16_224", device=card, seed=2, num_classes=5, **width)
    opt, lr_fn = make_optimizer(model, OptimConfig(lr=1e-3, total_steps=10, num_layers=2), device=card)
    state = TrainState.create(model, opt, device=card)
    mix = MixupConfig(mixup_alpha=0.8, cutmix_alpha=1.0, label_smoothing=0.1, num_classes=5)
    step = make_classification_train_step(model, opt, soft_target_cross_entropy, 1, lr_fn, mixup_cfg=mix,
                                          device=card)
    gen = torch.Generator(device=card).manual_seed(3)
    losses = [float(step(state, {"videos": b["videos"], "labels": b["labels"]}, generator=gen)["loss"])
              for b, _ in data]
    seen["classification"] = (step.graph.replays, step.graph.failed, losses)
    model = create_model("disentangle_vit_base_patch16_224", device=card, seed=2, num_classes=5,
                         num_scene_classes=4, **width)
    teacher = create_model("vit_base_patch16_224", device=card, seed=1, num_classes=4, use_mean_pooling=False,
                           **width)
    opt, lr_fn = make_optimizer(model, OptimConfig(lr=1e-3, total_steps=10, num_layers=2), device=card)
    state = TrainState.create(model, opt, device=card)
    step = make_multi_task_train_step(model, teacher, opt, 5, lr_fn=lr_fn, device=card)
    losses = [float(step(state, {"videos": b["videos"], "labels": b["labels"]}, generator=gen)["loss"])
              for b, _ in data]
    seen["multi_task"] = (step.graph.replays, step.graph.failed, losses)
    with capsys.disabled():
        for name, (replays, failed, losses) in seen.items():
            print(f"GRAPH-CAPTURE {name}: replays {replays}, capture failed {failed}, losses {losses}")
    for replays, failed, losses in seen.values():
        assert all(np.isfinite(v) for v in losses)
        assert replays == (0 if failed else 2)


def test_a_step_whose_capture_fails_runs_eager(card):
    """An update that waits for the host (a gradient read back, as a
    recording hook does) cannot be captured: the capture fails with a
    warning, the call and every later one run eager, and the steps equal
    those of a step that never tried."""
    import devias_tpu_torch.train.step as step_module

    def run(hooked):
        model, opt, state, step = _graph_step(card, hvu=True)
        update, seen = opt.step, []

        def recording_update(*args, **kw):
            if hooked:
                seen.append(float(next(model.parameters()).grad.float().norm().cpu()))
            return update(*args, **kw)

        opt.step = recording_update
        gen = torch.Generator(device=card).manual_seed(5)
        losses = [float(step(state, batch, generator=gen, draws=draws)["loss"])
                  for batch, draws in _graph_data(card, 3)]
        return losses, [p.detach().clone() for p in model.parameters()], step.graph, seen

    with pytest.warns(UserWarning, match="runs eager"):
        losses, params, sg, seen = run(True)
    assert sg.failed and sg.replays == 0 and sg.graph is None and len(seen) == 3
    saved = step_module.graph_safe
    step_module.graph_safe = lambda *a: False
    try:
        want_losses, want_params, _, _ = run(False)
    finally:
        step_module.graph_safe = saved
    assert losses == want_losses
    assert all(torch.equal(a, b) for a, b in zip(params, want_params))
