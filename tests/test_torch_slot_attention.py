"""K4 (the fused slot cross-attention round) in the PyTorch port: its plain
version against the JAX package's Pallas kernel (interpret mode, 32-key
blocks, so N=100 is ragged against them) and XLA formulation, its
autograd Function's gradients against `jax.grad` of the fused JAX function,
and a CPU emulation of the CUDA kernel's tiling (64-key tiles, per-tile
num and den, a fixed-order sum over tiles) against the plain version,
which leaves that tolerance when the ragged keys are left in.
f32 throughout; the tolerances are the JAX package's own for this kernel
(`tests/test_kernels.py:125-126`, `:140`). At `chip_smoke.py`'s widths and
input scales the same emulation is held to the card check's KERNEL_TOL."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from devias_tpu.kernels.slot_attention import fused_slot_attention as jax_fused_slot_attention
from devias_tpu.kernels.slot_attention import slot_attention_reference as jax_slot_attention_reference
from devias_tpu_torch.kernels import fused_slot_attention, slot_attention_reference

B, S, N, D, HEADS, DH = 2, 2, 100, 32, 4, 16
SIM = dict(rtol=1e-5, atol=1e-6)
OUT = dict(rtol=1e-4, atol=1e-5)


def _inputs(seed=4, n=N):
    rng = np.random.default_rng(seed)
    inner = HEADS * DH
    return [rng.normal(size=(B, S, D)).astype(np.float32), rng.normal(size=(B, n, D)).astype(np.float32)] + [
        (rng.normal(size=s) * 0.05).astype(np.float32)
        for s in ((D, inner), (D, inner), (D, inner), (inner, D), (D,))]


def test_plain_version_matches_pallas_kernel_and_reference():
    arrays = _inputs()
    out, sim = slot_attention_reference(*map(torch.from_numpy, arrays), HEADS, DH)
    j_out, j_sim = jax_fused_slot_attention(*map(jnp.asarray, arrays), HEADS, DH, 32, True)
    r_out, r_sim = jax_slot_attention_reference(*map(jnp.asarray, arrays), HEADS, DH)
    assert sim.shape == (B, HEADS, S, N) and sim.dtype == torch.float32 and out.shape == (B, S, D)
    for want_out, want_sim in ((j_out, j_sim), (r_out, r_sim)):
        np.testing.assert_allclose(sim.numpy(), np.asarray(want_sim), **SIM)
        np.testing.assert_allclose(out.numpy(), np.asarray(want_out), **OUT)


def test_function_gradients_match_jax_grad():
    """Gradients of sum(out^2) + sum(sim^2) with respect to all seven
    inputs: the port's Function (plain forward on the CPU, autograd replay
    of the plain version backward) against `jax.grad` of the fused JAX
    function (Pallas forward, XLA-replay backward)."""
    arrays = _inputs(seed=5)
    leaves = [torch.from_numpy(a).requires_grad_() for a in arrays]
    out, sim = fused_slot_attention(*leaves, HEADS, DH)
    (out.square().sum() + sim.square().sum()).backward()

    def loss(*a):
        o, s = jax_fused_slot_attention(*a, HEADS, DH, 32, True)
        return (o ** 2).sum() + (s ** 2).sum()

    want = jax.grad(loss, argnums=tuple(range(7)))(*map(jnp.asarray, arrays))
    assert fused_slot_attention.launches == 0
    for leaf, w in zip(leaves, want):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w), rtol=1e-4, atol=1e-5)


def test_function_backward_takes_either_cotangent():
    """Only `sim` (the distillation map) or only `out` carries a gradient:
    the missing cotangent counts as zero."""
    arrays = _inputs(seed=6)
    for pick in (0, 1):
        leaves = [torch.from_numpy(a).requires_grad_() for a in arrays]
        outputs = fused_slot_attention(*leaves, HEADS, DH)
        outputs[pick].sum().backward()
        ref = [torch.from_numpy(a).requires_grad_() for a in arrays]
        slot_attention_reference(*ref, HEADS, DH)[pick].sum().backward()
        for a, b in zip(leaves, ref):
            # sim does not depend on wo and bo: autograd leaves them None
            want = torch.zeros_like(b) if b.grad is None else b.grad
            torch.testing.assert_close(a.grad, want, rtol=1e-5, atol=1e-6)


def _emulate(x, ctx, wq, wk, wv, wo, bo, heads, dh, mask_ragged_keys=True, round_bf16=False):
    """`csrc/slot_attention.cu` step by step in f32: q = x wq; per 64-key
    tile (ctx zero-padded to whole tiles) k, v, the slot softmax per key,
    ragged keys zeroed, partial den and num; the tiles summed in order;
    o = num / (den + 1e-7); out = o wo + bo. With `round_bf16`, o and out
    are rounded to bf16 where the kernel rounds them."""
    Bx, Sx, _ = x.shape
    n = ctx.shape[1]
    tiles = -(-n // 64)
    ctx = torch.cat([ctx, ctx.new_zeros(Bx, tiles * 64 - n, ctx.shape[2])], dim=1)
    q = (x @ wq).reshape(Bx, Sx, heads, dh)
    num = torch.zeros(Bx, heads, Sx, dh)
    den = torch.zeros(Bx, heads, Sx)
    sims = []
    for t in range(tiles):
        c = ctx[:, t * 64:(t + 1) * 64]
        k = (c @ wk).reshape(Bx, 64, heads, dh)
        v = (c @ wv).reshape(Bx, 64, heads, dh)
        a = (torch.einsum("bshd,bnhd->bhsn", q, k) * dh ** -0.5).softmax(dim=2)
        if mask_ragged_keys:
            a = a * (torch.arange(t * 64, (t + 1) * 64) < n).float()
        sims.append(a)
        num = num + torch.einsum("bhsn,bnhd->bhsd", a, v)
        den = den + a.sum(dim=-1)
    o = (num / (den[..., None] + 1e-7)).transpose(1, 2).reshape(Bx, Sx, heads * dh)
    if round_bf16:
        o = o.bfloat16().float()
    out = o @ wo + bo
    return (out.bfloat16().float() if round_bf16 else out), torch.cat(sims, dim=-1)[..., :n]


@pytest.mark.parametrize("n", [100, 64, 301])
def test_tiling_emulation_matches_plain_version_and_tolerance_catches_unmasked_keys(n):
    tensors = list(map(torch.from_numpy, _inputs(seed=7, n=n)))
    out, sim = slot_attention_reference(*tensors, HEADS, DH)
    e_out, e_sim = _emulate(*tensors, HEADS, DH)
    torch.testing.assert_close(e_sim, sim, **SIM)
    torch.testing.assert_close(e_out, out, **OUT)
    if n % 64:
        # left in, the zero-padded keys take 1/S of each slot's softmax and
        # inflate den: out leaves the tolerance it is held to above
        bad, _ = _emulate(*tensors, HEADS, DH, mask_ragged_keys=False)
        assert not torch.allclose(bad, out, **OUT)


def test_smoke_tolerance_catches_unmasked_keys():
    """`chip_smoke.py` holds K4's out to KERNEL_TOL of the f32 plain
    version's RMS at N=301, on its own input scales (x, ctx ~ N(0, 1), the
    weights and bo ~ N(0, 0.02^2), rounded to bf16) and widths (4 heads x
    512 over D=768; two batch entries here). The emulated kernel, with its
    bf16 roundings of o and out, stays below that; left in, the 19
    zero-padded keys of the last tile take their share of each slot's
    softmax and inflate den, and out reads above 1.5 times the tolerance."""
    from chip_smoke import AGG_DIM, AGG_DIM_HEAD, AGG_HEADS, KERNEL_TOL, SLOTS

    n, inner = 301, AGG_HEADS * AGG_DIM_HEAD
    rng = np.random.default_rng(60 + n)
    shapes = ((2, SLOTS, AGG_DIM, 1.0), (2, n, AGG_DIM, 1.0), (AGG_DIM, inner, 0.02), (AGG_DIM, inner, 0.02),
              (AGG_DIM, inner, 0.02), (inner, AGG_DIM, 0.02), (AGG_DIM, 0.02))
    tensors = [torch.from_numpy(rng.standard_normal(s[:-1], dtype=np.float32) * np.float32(s[-1])).bfloat16().float()
               for s in shapes]
    with torch.no_grad():
        exact, _ = slot_attention_reference(*tensors, AGG_HEADS, AGG_DIM_HEAD)
        rms = exact.square().mean().sqrt().item()
        good = (_emulate(*tensors, AGG_HEADS, AGG_DIM_HEAD, round_bf16=True)[0] - exact).abs().max().item() / rms
        bad = (_emulate(*tensors, AGG_HEADS, AGG_DIM_HEAD, mask_ragged_keys=False, round_bf16=True)[0]
               - exact).abs().max().item() / rms
    assert good < KERNEL_TOL < bad / 1.5, (good, bad)


def test_wrapper_checks_shapes_and_devices():
    tensors = list(map(torch.from_numpy, _inputs()))
    bad = list(tensors)
    bad[5] = bad[5][:, :-1]  # wo [inner, D-1]
    with pytest.raises(ValueError, match="wo"):
        fused_slot_attention(*bad, HEADS, DH)
    with pytest.raises(ValueError, match="x must be"):
        fused_slot_attention(tensors[0][0], *tensors[1:], HEADS, DH)
    meta = [t.to("meta") for t in tensors]
    with pytest.raises(ValueError, match="no slot-attention path"):
        fused_slot_attention(*meta, HEADS, DH)
