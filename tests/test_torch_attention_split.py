"""K2 (local queries against gathered keys) and K3 (head-major) in the
PyTorch port: the plain versions of the forward and of the backward against
the JAX package's `fused_attention_q_kv` and `fused_attention` (Pallas
kernels in interpret mode) and `jax.vjp`, the autograd Functions' wiring on
the CPU, and `chip_smoke.py`'s tolerances against emulated kernels that
leave a ragged query or key tail unmasked. Both sides take the same numpy
inputs in float32; the tolerances are float32 rounding over D-term dots and
N-term sums, as in `tests/test_torch_attention.py`."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from devias_tpu.kernels.attention import _fwd_call_q_kv
from devias_tpu.kernels.attention import fused_attention as jax_fused_attention
from devias_tpu.kernels.attention import fused_attention_q_kv as jax_fused_attention_q_kv
from devias_tpu_torch.kernels import attention as attn

F32 = dict(rtol=2e-5, atol=2e-5)
GRAD = dict(rtol=1e-4, atol=2e-5)
SPLIT_SHAPES = [(48, 192), (50, 130)]  # (Nq, Nk); the second ragged on both axes


def _q_kv(Nq, Nk, B=2, H=4, D=16, seed=0):
    rng = np.random.default_rng(seed + Nq * 1000 + Nk)
    return (rng.normal(size=(B, Nq, H * D)).astype(np.float32),
            rng.normal(size=(B, Nk, 2 * H * D)).astype(np.float32),
            rng.normal(size=(B, Nq, H * D)).astype(np.float32))


@pytest.mark.parametrize("Nq,Nk", SPLIT_SHAPES)
def test_q_kv_forward_matches_pallas_kernel(Nq, Nk):
    """The no-stats plain version against `fused_attention_q_kv`; the stats
    plain version's o, m, l against `_fwd_call_q_kv(with_stats=True)` (in
    interpret mode each head is its own group, stats columns 0 and 1)."""
    H, D = 4, 16
    q, kv, _ = _q_kv(Nq, Nk)
    scale = D ** -0.5
    want = np.asarray(jax_fused_attention_q_kv(jnp.asarray(q), jnp.asarray(kv), H, scale, None, True))
    got = attn.attention_q_kv_reference(torch.from_numpy(q), torch.from_numpy(kv), H, scale)
    np.testing.assert_allclose(got.numpy(), want, **F32)

    o_j, stats = _fwd_call_q_kv(jnp.asarray(q), jnp.asarray(kv), H, scale, None, True)
    o, m, l = attn.attention_q_kv_fwd_stats_reference(torch.from_numpy(q), torch.from_numpy(kv), H, scale)
    assert o.shape == (2, Nq, H * D) and m.shape == l.shape == (2, H, Nq)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_j), **F32)
    np.testing.assert_allclose(m.numpy(), np.asarray(stats)[..., 0], **F32)
    np.testing.assert_allclose(l.numpy(), np.asarray(stats)[..., 1], rtol=2e-5, atol=2e-4)


@pytest.mark.parametrize("Nq,Nk", SPLIT_SHAPES)
def test_q_kv_backward_matches_jax_vjp_and_autograd(Nq, Nk):
    """dq and dkv of the plain backward against `jax.vjp` of the Pallas
    pair and against torch autograd of the plain forward; the autograd
    Function on the CPU gives the plain backward exactly and launches no
    kernel."""
    H, D = 4, 16
    scale = D ** -0.5
    q, kv, do = _q_kv(Nq, Nk, seed=1)
    _, vjp = jax.vjp(lambda a, b: jax_fused_attention_q_kv(a, b, H, scale, None, True),
                     jnp.asarray(q), jnp.asarray(kv))
    want_dq, want_dkv = (np.asarray(g) for g in vjp(jnp.asarray(do)))
    tq, tkv, tdo = torch.from_numpy(q), torch.from_numpy(kv), torch.from_numpy(do)
    o, m, l = attn.attention_q_kv_fwd_stats_reference(tq, tkv, H, scale)
    dq, dkv = attn.attention_q_kv_bwd_reference(tq, tkv, o, tdo, m, l, H, scale)
    np.testing.assert_allclose(dq.numpy(), want_dq, **GRAD)
    np.testing.assert_allclose(dkv.numpy(), want_dkv, **GRAD)

    x, y = tq.clone().requires_grad_(), tkv.clone().requires_grad_()
    attn.attention_q_kv_reference(x, y, H, scale).backward(tdo)
    np.testing.assert_allclose(dq.numpy(), x.grad.numpy(), **GRAD)
    np.testing.assert_allclose(dkv.numpy(), y.grad.numpy(), **GRAD)

    before = attn.launch_counts()
    x, y = tq.clone().requires_grad_(), tkv.clone().requires_grad_()
    out = attn.fused_attention_q_kv(x, y, H, scale)
    out.backward(tdo)
    assert attn.launch_counts() == before
    torch.testing.assert_close(out.detach(), o, rtol=0, atol=0)
    torch.testing.assert_close(x.grad, dq, rtol=0, atol=0)
    torch.testing.assert_close(y.grad, dkv, rtol=0, atol=0)
    with torch.no_grad():
        torch.testing.assert_close(attn.fused_attention_q_kv(tq, tkv, H, scale),
                                   attn.attention_q_kv_reference(tq, tkv, H, scale), rtol=0, atol=0)
    torch.testing.assert_close(attn.attention_q_kv_bwd(tq, tkv, o, tdo, m, l, H, scale)[1], dkv, rtol=0, atol=0)


def test_q_kv_with_all_keys_is_k1():
    """K2 on q = qkv's q block and kv = its k | v block is K1 on qkv:
    forward, stats and backward (the layouts differ, the arithmetic not)."""
    H, D, N = 4, 16, 40
    rng = np.random.default_rng(3)
    qkv = torch.from_numpy(rng.normal(size=(2, N, 3 * H * D)).astype(np.float32))
    do = torch.from_numpy(rng.normal(size=(2, N, H * D)).astype(np.float32))
    q, kv = qkv[..., :H * D], qkv[..., H * D:]
    o1, m1, l1 = attn.attention_qkv_fwd_stats_reference(qkv, H, 0.25)
    o2, m2, l2 = attn.attention_q_kv_fwd_stats_reference(q, kv, H, 0.25)
    for a, b in ((o1, o2), (m1, m2), (l1, l2)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    dqkv = attn.attention_qkv_bwd_reference(qkv, o1, do, m1, l1, H, 0.25)
    dq, dkv = attn.attention_q_kv_bwd_reference(q, kv, o1, do, m1, l1, H, 0.25)
    torch.testing.assert_close(torch.cat([dq, dkv], -1), dqkv, rtol=0, atol=0)


# the shapes of tests/test_kernels.py:26 and :40, and a ragged one
@pytest.mark.parametrize("B,H,N,D", [(2, 2, 64, 16), (2, 4, 96, 32), (1, 2, 64, 16), (2, 3, 50, 16)])
def test_head_major_matches_pallas_kernel_and_vjp(B, H, N, D):
    """K3's plain forward against `fused_attention` in interpret mode, its
    plain backward against `jax.vjp` of the Pallas pair (which recomputes
    m and l over the f32 exponentials), and the port's `fused_attention`
    on the CPU: the plain pair exactly, no kernel launched."""
    rng = np.random.default_rng(N + D)
    q, k, v, do = (rng.normal(size=(B, H, N, D)).astype(np.float32) for _ in range(4))
    scale = D ** -0.5
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    want, vjp = jax.vjp(lambda a, b, c: jax_fused_attention(a, b, c, scale, None, True), jq, jk, jv)
    want_grads = [np.asarray(g) for g in vjp(jnp.asarray(do))]
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    o = attn.attention_head_major_reference(tq, tk, tv, scale)
    np.testing.assert_allclose(o.numpy(), np.asarray(want), **F32)
    grads = attn.attention_head_major_bwd_reference(tq, tk, tv, o, tdo, scale)
    for g, w, name in zip(grads, want_grads, "qkv"):
        np.testing.assert_allclose(g.numpy(), w, **GRAD, err_msg=name)

    before = attn.launch_counts()
    xs = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    out = attn.fused_attention(*xs, scale)
    out.backward(tdo)
    assert attn.launch_counts() == before
    torch.testing.assert_close(out.detach(), o, rtol=0, atol=0)
    for x, g in zip(xs, grads):
        torch.testing.assert_close(x.grad, g, rtol=0, atol=0)


def test_head_major_is_exported_and_rejects_bad_shapes():
    from devias_tpu_torch.kernels import fused_attention

    assert fused_attention is attn.fused_attention
    with pytest.raises(ValueError, match="one shape"):
        fused_attention(torch.zeros(1, 2, 8, 16), torch.zeros(1, 2, 9, 16), torch.zeros(1, 2, 8, 16), 0.25)
    with pytest.raises(ValueError, match="2\\*H\\*D"):
        attn.fused_attention_q_kv(torch.zeros(1, 8, 64), torch.zeros(1, 8, 64), 4, 0.25)


# ------------------------------------------------------------ smoke tolerances


# keys per K/V tile of the forward and of the backward's dq kernel, and q
# rows per tile of its dkdv kernel (attention_fwd.cu, attention_bwd.cu)
KEY_TILE, DKDV_Q_ROWS = 128, 64


def _pad_rows(x, rows, rng):
    """x [B, N, W] with `rows` N(0, 1) rows appended: what lies beyond a
    ragged tail in memory, read by a kernel that does not mask it."""
    tail = torch.from_numpy(rng.standard_normal((x.shape[0], rows, x.shape[2]), dtype=np.float32))
    return torch.cat([x, tail.to(x.dtype)], 1)


def _emulate_q_kv(q, kv, H, scale, mask_ragged_keys=True):
    """The CUDA kernel's forward rounding on the CPU: q scaled in bf16,
    logits in f32, exp(s - m) rounded to bf16 and summed as rounded, the
    output rounded to bf16. With `mask_ragged_keys=False` the zero-filled
    keys past Nk in the last 128-key tile count as logits of 0."""
    qh = attn._heads(q.float(), H)
    k, v = attn._split_heads(kv.float(), 2, H)
    s = (qh.bfloat16() * scale).float() @ k.transpose(-1, -2)
    pad = 0 if mask_ragged_keys else -kv.shape[1] % KEY_TILE
    s = torch.cat([s, s.new_zeros(*s.shape[:-1], pad)], -1)
    v = torch.cat([v, v.new_zeros(*v.shape[:2], pad, v.shape[-1])], -2)
    e = torch.exp(s - s.amax(-1, keepdim=True)).bfloat16().float()
    return attn._merge((e @ v) / e.sum(-1, keepdim=True)).bfloat16().float()


@pytest.mark.parametrize("Nq,Nk", [(77, 301), (392, 1569)])
def test_smoke_tolerance_catches_unmasked_ragged_keys_q_kv(Nq, Nk):
    """`chip_smoke.py` holds K2 to KERNEL_TOL of the f32 output's RMS, as
    K1: the emulated kernel stays below it, one that leaves the ragged keys
    of its last tile unmasked reads above 1.5 times it."""
    from chip_smoke import KERNEL_TOL

    H, D = 6, 64
    rng = np.random.default_rng(Nq + Nk)
    q = torch.from_numpy(rng.standard_normal((1, Nq, H * D), dtype=np.float32)).bfloat16()
    kv = torch.from_numpy(rng.standard_normal((1, Nk, 2 * H * D), dtype=np.float32)).bfloat16()
    exact = attn.attention_q_kv_reference(q.float(), kv.float(), H, D ** -0.5)
    rms = exact.square().mean().sqrt().item()
    good = (_emulate_q_kv(q, kv, H, D ** -0.5) - exact).abs().max().item() / rms
    bad = (_emulate_q_kv(q, kv, H, D ** -0.5, mask_ragged_keys=False) - exact).abs().max().item() / rms
    assert good < KERNEL_TOL < bad / 1.5, (good, bad)


def _exact_q_kv_grad(q, kv, do, H, scale):
    o, m, l = attn.attention_q_kv_fwd_stats_reference(q.float(), kv.float(), H, scale)
    return attn.attention_q_kv_bwd_reference(q.float(), kv.float(), o, do.float(), m, l, H, scale)


@pytest.mark.parametrize("tail", ["queries", "keys"])
def test_smoke_bwd_tolerance_catches_unmasked_ragged_tails_q_kv(tail):
    """`chip_smoke.py` holds K2's dq, dk and dv to BWD_TOL of their RMS. The
    plain backward on bf16 inputs (the kernels' roundings) stays below it. A
    dkdv kernel that streams the rows past Nq of its last q tile unmasked
    (what lies beyond in memory: N(0, 1) rows) spoils dk and dv; a dq kernel
    that reads the keys past Nk of its last key tile spoils dq. Each reads
    above ten times the limit."""
    from chip_smoke import BWD_TOL, q_kv_bwd_errors

    H, D, Nq, Nk = 6, 64, 77, 301
    scale = D ** -0.5
    rng = np.random.default_rng(7)
    q = torch.from_numpy(rng.standard_normal((1, Nq, H * D), dtype=np.float32)).bfloat16()
    kv = torch.from_numpy(rng.standard_normal((1, Nk, 2 * H * D), dtype=np.float32)).bfloat16()
    do = torch.from_numpy(rng.standard_normal((1, Nq, H * D), dtype=np.float32)).bfloat16()
    exact = _exact_q_kv_grad(q, kv, do, H, scale)
    o, m, l = attn.attention_q_kv_fwd_stats_reference(q, kv, H, scale)
    good = max(q_kv_bwd_errors(attn.attention_q_kv_bwd_reference(q, kv, o, do, m, l, H, scale), exact, exact))
    if tail == "queries":
        pad = -Nq % DKDV_Q_ROWS
        dq, dkv = _exact_q_kv_grad(_pad_rows(q, pad, rng), kv, _pad_rows(do, pad, rng), H, scale)
        bad = min(q_kv_bwd_errors((dq[:, :Nq], dkv), exact, exact)[1:])  # dk, dv
    else:
        dq, dkv = _exact_q_kv_grad(q, _pad_rows(kv, -Nk % KEY_TILE, rng), do, H, scale)
        bad = q_kv_bwd_errors((dq, dkv[:, :Nk]), exact, exact)[0]  # dq
    assert good < BWD_TOL < bad / 10, (good, bad)


def test_smoke_tolerance_catches_unmasked_ragged_keys_head_major():
    """K3 at N=77 against its f32 plain version: the emulated kernel (l over
    the f32 exponentials) within KERNEL_TOL of the RMS, zero-filled ragged
    keys left in the softmax above 1.5 times it."""
    from chip_smoke import KERNEL_TOL

    B, H, N, D = 1, 6, 77, 64
    scale = D ** -0.5
    rng = np.random.default_rng(11)
    q, k, v = (torch.from_numpy(rng.standard_normal((B, H, N, D), dtype=np.float32)).bfloat16() for _ in range(3))
    exact = attn.attention_head_major_reference(q.float(), k.float(), v.float(), scale)
    rms = exact.square().mean().sqrt().item()

    def emulate(pad):
        s = (q.bfloat16() * scale).float() @ k.float().transpose(-1, -2)
        s = torch.cat([s, s.new_zeros(B, H, N, pad)], -1)
        vv = torch.cat([v.float(), v.new_zeros(B, H, pad, D).float()], -2)
        e = torch.exp(s - s.amax(-1, keepdim=True))
        return ((e.bfloat16().float() @ vv) / e.sum(-1, keepdim=True)).bfloat16().float()

    good = (emulate(0) - exact).abs().max().item() / rms
    bad = (emulate(-N % KEY_TILE) - exact).abs().max().item() / rms
    assert good < KERNEL_TOL < bad / 1.5, (good, bad)
