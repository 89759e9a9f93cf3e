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
# rows), and the small shapes
SHAPES = [(2, 64, 2), (2, 77, 3), (1, 1569, 12), (3, 9, 1), (2, 127, 2), (2, 128, 2), (1, 129, 3),
          (1, 1568, 12), (2, 1570, 12)]


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
