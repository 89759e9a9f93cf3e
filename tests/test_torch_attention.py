"""K1 in the PyTorch port: the plain versions of the forward (with and
without stats) and of the backward against the JAX package's Pallas
kernels (interpret mode) and `jax.vjp`, the autograd Function's wiring on
the CPU, and the smoke's tolerances against emulated kernels. Both sides
take the same numpy inputs in float32; the tolerances are float32 rounding
over D-term dots and N-term sums."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from devias_tpu.kernels.attention import _fwd_call_qkv
from devias_tpu.kernels.attention import fused_attention_qkv as jax_fused_attention_qkv
from devias_tpu_torch.kernels.attention import (
    attention_qkv_bwd,
    attention_qkv_bwd_reference,
    attention_qkv_fwd_stats,
    attention_qkv_fwd_stats_reference,
    attention_qkv_reference,
    fused_attention_qkv,
    launch_counts,
)

F32 = dict(rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("N", [64, 96, 9])  # 9: ragged, CLS-like token count
def test_plain_version_matches_pallas_kernel(N):
    B, H, D = 2, 4, 16
    rng = np.random.default_rng(N)
    qkv = rng.normal(size=(B, N, 3 * H * D)).astype(np.float32)
    scale = D ** -0.5
    want = np.asarray(jax_fused_attention_qkv(jnp.asarray(qkv), H, scale, None, True))
    got = attention_qkv_reference(torch.from_numpy(qkv), H, scale).numpy()
    np.testing.assert_allclose(got, want, **F32)


def _qkv_do(N, B=2, H=4, D=16):
    rng = np.random.default_rng(100 + N)
    return (rng.normal(size=(B, N, 3 * H * D)).astype(np.float32),
            rng.normal(size=(B, N, H * D)).astype(np.float32))


@pytest.mark.parametrize("N", [64, 96, 9])
def test_stats_forward_matches_pallas_kernel(N):
    """o, m and l against `_fwd_call_qkv(with_stats=True)`; in interpret
    mode each head is its own group, stats columns 0 (m) and 1 (l)."""
    H, D = 4, 16
    qkv, _ = _qkv_do(N, H=H, D=D)
    o_j, stats = _fwd_call_qkv(jnp.asarray(qkv), H, D ** -0.5, None, True)
    o, m, l = attention_qkv_fwd_stats_reference(torch.from_numpy(qkv), H, D ** -0.5)
    assert m.shape == l.shape == (2, H, N)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_j), **F32)
    np.testing.assert_allclose(m.numpy(), np.asarray(stats)[..., 0], **F32)
    np.testing.assert_allclose(l.numpy(), np.asarray(stats)[..., 1], rtol=2e-5, atol=2e-4)


@pytest.mark.parametrize("N", [64, 96, 9])
def test_backward_matches_jax_vjp_and_autograd(N):
    """The plain backward against `jax.vjp` of the Pallas kernel pair and
    against torch autograd of the plain forward; the autograd Function on
    the CPU gives the plain backward exactly and launches no kernel."""
    H, D = 4, 16
    scale = D ** -0.5
    qkv, do = _qkv_do(N, H=H, D=D)
    _, vjp = jax.vjp(lambda x: jax_fused_attention_qkv(x, H, scale, None, True), jnp.asarray(qkv))
    want = np.asarray(vjp(jnp.asarray(do))[0])
    t_qkv, t_do = torch.from_numpy(qkv), torch.from_numpy(do)
    o, m, l = attention_qkv_fwd_stats_reference(t_qkv, H, scale)
    got = attention_qkv_bwd_reference(t_qkv, o, t_do, m, l, H, scale)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=2e-5)

    x = t_qkv.clone().requires_grad_()
    attention_qkv_reference(x, H, scale).backward(t_do)
    np.testing.assert_allclose(got.numpy(), x.grad.numpy(), rtol=1e-4, atol=2e-5)

    before = launch_counts()
    y = t_qkv.clone().requires_grad_()
    out = fused_attention_qkv(y, H, scale)
    out.backward(t_do)
    assert launch_counts() == before
    torch.testing.assert_close(out.detach(), o, rtol=0, atol=0)
    torch.testing.assert_close(y.grad, got, rtol=0, atol=0)
    torch.testing.assert_close(attention_qkv_fwd_stats(t_qkv, H, scale)[1], m, rtol=0, atol=0)
    torch.testing.assert_close(attention_qkv_bwd(t_qkv, o, t_do, m, l, H, scale), got, rtol=0, atol=0)


def test_wrapper_takes_plain_version_on_cpu_without_counting():
    rng = np.random.default_rng(0)
    qkv = torch.from_numpy(rng.normal(size=(2, 9, 3 * 4 * 64)).astype(np.float32))
    before = fused_attention_qkv.launches
    out = fused_attention_qkv(qkv, 4, 0.125)
    assert fused_attention_qkv.launches == before
    torch.testing.assert_close(out, attention_qkv_reference(qkv, 4, 0.125), rtol=0, atol=0)
    assert out.shape == (2, 9, 4 * 64)


# keys per K/V tile of the CUDA kernels (`kKTile` of attention_fwd.cu,
# `kBlock` of attention_bwd.cu): N = 1568 leaves a 32-key tail, 1569 a 33-key
# one, 77 a single ragged tile
KEY_TILE = 128


def _emulate_kernel(qkv, H, scale, tile=KEY_TILE, mask_ragged_keys=True):
    """The CUDA kernel's rounding in float32 on the CPU: q scaled in bf16,
    logits in f32, exp(s - m) rounded to bf16 and summed as rounded, the
    output rounded to bf16. With `mask_ragged_keys=False` the zero-filled
    keys past N in the last 128-key tile count as logits of 0, the fault
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


def _exact_grad(qkv, do, H, scale):
    o, m, l = attention_qkv_fwd_stats_reference(qkv.float(), H, scale)
    return attention_qkv_bwd_reference(qkv.float(), o, do.float(), m, l, H, scale)


@pytest.mark.parametrize("N", [1568, 1569, 77])
def test_smoke_bwd_tolerance_catches_unmasked_ragged_tiles(N):
    """`chip_smoke.py` holds each of dq, dk, dv to BWD_TOL of its RMS
    against the f32 gradient. The kernels' own roundings (the plain
    backward on bf16 inputs, fed the plain stats forward's o, m and l) stay
    below it; a kernel that reads the rows past N of its last q and key
    tiles (here: N(0, 1) rows, what lies beyond in memory) without masking
    them reads above ten times it."""
    from chip_smoke import BWD_TOL, bwd_errors

    H, D = 6, 64
    scale = D ** -0.5
    rng = np.random.default_rng(N)
    qkv = torch.from_numpy(rng.standard_normal((1, N, 3 * H * D), dtype=np.float32)).bfloat16()
    do = torch.from_numpy(rng.standard_normal((1, N, H * D), dtype=np.float32)).bfloat16()
    exact = _exact_grad(qkv, do, H, scale)
    o, m, l = attention_qkv_fwd_stats_reference(qkv, H, scale)
    good = max(bwd_errors(attention_qkv_bwd_reference(qkv, o, do, m, l, H, scale), exact, exact))
    pad = -N % KEY_TILE
    tail_qkv = torch.from_numpy(rng.standard_normal((1, pad, 3 * H * D), dtype=np.float32)).bfloat16()
    tail_do = torch.from_numpy(rng.standard_normal((1, pad, H * D), dtype=np.float32)).bfloat16()
    bad_grad = _exact_grad(torch.cat([qkv, tail_qkv], 1), torch.cat([do, tail_do], 1), H, scale)[:, :N]
    bad = min(bwd_errors(bad_grad, exact, exact))
    assert good < BWD_TOL < bad / 10, (good, bad)


@pytest.mark.parametrize("N", [1568, 77])
def test_smoke_stats_tolerance_catches_unmasked_ragged_keys(N):
    """l of the emulated kernel (bf16-rounded exponentials) is within
    STATS_L_TOL of its RMS against f32; zero-filled ragged keys left in the
    softmax read above twice it. m is exact."""
    from chip_smoke import STATS_L_TOL, STATS_M_TOL

    H, D = 6, 64
    rng = np.random.default_rng(N)
    qkv = torch.from_numpy(rng.standard_normal((1, N, 3 * H * D), dtype=np.float32)).bfloat16()
    _, m, l = attention_qkv_fwd_stats_reference(qkv, H, D ** -0.5)
    _, em, el = attention_qkv_fwd_stats_reference(qkv.float(), H, D ** -0.5)
    padded = torch.cat([qkv, torch.zeros(1, -N % KEY_TILE, 3 * H * D).bfloat16()], 1)
    _, _, bl = attention_qkv_fwd_stats_reference(padded, H, D ** -0.5)
    rms = el.square().mean().sqrt().item()
    assert (m - em).abs().max().item() <= STATS_M_TOL * em.square().mean().sqrt().item()
    good = (l - el).abs().max().item() / rms
    bad = (bl[..., :N] - el).abs().max().item() / rms
    assert good < STATS_L_TOL < bad / 2, (good, bad)


def test_power_of_two_scale_folds_exactly():
    """The kernels fold the logit scale into the exponent's multiplier
    instead of rounding q * scale to bf16. At scale = 1/8 (D^-0.5 at D = 64)
    that rounding changes no element, and the logits bf16(q scale) k^T and
    (q k^T) scale, then times log2 e, agree bit for bit: the CPU product
    sums both in one order, and a power of two commutes with every rounding.
    A scale that is not a power of two is refused before any launch."""
    from devias_tpu_torch.kernels.attention import _check_scale

    rng = np.random.default_rng(3)
    q, k = (torch.from_numpy(rng.standard_normal((2, 3, 77, 64), dtype=np.float32)).bfloat16() for _ in range(2))
    scale, log2e = 64 ** -0.5, 1.4426950408889634
    torch.testing.assert_close((q * scale).float(), q.float() * scale, rtol=0, atol=0)
    tpu = (q * scale).float() @ k.float().transpose(-1, -2)
    folded = q.float() @ k.float().transpose(-1, -2)
    torch.testing.assert_close(folded * scale, tpu, rtol=0, atol=0)
    torch.testing.assert_close(folded * (scale * log2e), tpu * log2e, rtol=0, atol=0)
    _check_scale(scale)
    _check_scale(0.25)
    for bad in (0.2, 0.0, -0.125):
        with pytest.raises(ValueError, match="power of two"):
            _check_scale(bad)


@pytest.mark.parametrize("N", [77, 128])
def test_bwd_prepass_operands_are_the_ones_bwd_heads_rounds(N):
    """The backward's pre-pass writes Dr, Qs = bf16(q scale / l) and
    dOs = bf16(dO / l) once, and the dq and dkdv kernels only read them.
    Its plain form gives exactly the operands `_bwd_heads` rounds: dk = t^T
    Qs and dv = e^T dOs rebuilt from them, and dq from t with its Dr, equal
    `_bwd_heads`' gradients bit for bit."""
    from devias_tpu_torch.kernels.attention import _bwd_heads, _fwd_stats_heads, bwd_prepass_reference

    H, D, scale = 3, 64, 0.125
    rng = np.random.default_rng(N)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((2, H, N, D), dtype=np.float32)).bfloat16()
                   for _ in range(4))
    o, m, l = _fwd_stats_heads(q, k, v, scale, round_l=True)
    o = o.bfloat16()
    dq, dk, dv = _bwd_heads(q, k, v, o, do, m, l, scale)
    dr, qs, dos = bwd_prepass_reference(q, o, do, l, scale)
    assert dr.shape == (2, H, N) and dr.dtype == torch.float32
    assert qs.dtype == dos.dtype == torch.bfloat16 and qs.shape == dos.shape == q.shape
    e = torch.exp((q * scale).float() @ k.float().transpose(-1, -2) - m[..., None])
    t = (e * (do.float() @ v.float().transpose(-1, -2) - dr[..., None])).bfloat16().float()
    torch.testing.assert_close(t.transpose(-1, -2) @ qs.float(), dk, rtol=0, atol=0)
    torch.testing.assert_close(e.bfloat16().float().transpose(-1, -2) @ dos.float(), dv, rtol=0, atol=0)
    torch.testing.assert_close((t @ k.float()) * ((1.0 / l)[..., None] * scale), dq, rtol=0, atol=0)


def test_library_hash_covers_included_headers(tmp_path, monkeypatch):
    """A change to a header that a source includes, directly or through
    another header, renames the library, so the next load rebuilds it; a
    header it does not include leaves the name alone."""
    from devias_tpu_torch.kernels import _build

    (tmp_path / "a.cu").write_text('#include "b.cuh"\n#include <cuda_runtime.h>\n')
    (tmp_path / "b.cuh").write_text('#pragma once\n#include "c.cuh"\n')
    (tmp_path / "c.cuh").write_text("// one\n")
    (tmp_path / "d.cuh").write_text("// unrelated\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path.resolve())
    monkeypatch.setattr(_build, "SOURCES", {"a": tmp_path.resolve() / "a.cu"})
    assert [p.name for p in _build.local_includes(_build.SOURCES["a"])] == ["a.cu", "b.cuh", "c.cuh"]
    first = _build.library_path("a")
    (tmp_path / "d.cuh").write_text("// changed\n")
    assert _build.library_path("a") == first
    (tmp_path / "c.cuh").write_text("// two\n")
    assert _build.library_path("a") != first
