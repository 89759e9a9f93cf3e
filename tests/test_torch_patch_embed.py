"""K5 (patchify + tubelet embedding GEMM) in the PyTorch port: its plain
version against the product the TPU script checks its kernel against,
`patchify_video(x, 2, 16) @ kernel` of the JAX package
(`scripts/retest_patchify_pallas.py:62-65`; the script runs its full-size
kernel when imported, so the test calls the function it compares with).
x [2, 4, 48, 80, 3] gives 3 x 5 = 15 tokens per frame pair, ragged against
the CUDA kernel's 128-token tiles. In f32 within 1e-5 relative; with a
bf16 kernel (the clip rounded to bf16, f32 sums, a bf16 result) within one
bf16 ulp of the output's RMS."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from devias_tpu.nn.vit import patchify_video
from devias_tpu_torch.kernels import patchify_embed
from devias_tpu_torch.kernels.patch_embed import patchify_embed_reference

SHAPE = (2, 4, 48, 80, 3)
DOUT = 96


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=SHAPE).astype(np.float32)
    kernel = (rng.normal(size=(1536, DOUT)) * 1536 ** -0.5).astype(np.float32)
    return x, kernel


def _jax_embed(x, kernel, dtype):
    B, T, H, W, _ = x.shape
    p = patchify_video(jnp.asarray(x, dtype), 2, 16)
    out = jnp.einsum("bnk,kd->bnd", p, jnp.asarray(kernel, dtype), preferred_element_type=jnp.float32)
    return np.asarray(out.astype(dtype).astype(jnp.float32)).reshape(B, T // 2, (H // 16) * (W // 16), -1)


def test_plain_version_matches_jax_patchify_matmul_f32():
    x, kernel = _inputs()
    got = patchify_embed(torch.from_numpy(x), torch.from_numpy(kernel))
    assert got.shape == (2, 2, 15, DOUT) and got.dtype == torch.float32
    assert patchify_embed.launches == 0
    np.testing.assert_allclose(got.numpy(), _jax_embed(x, kernel, jnp.float32), rtol=1e-5, atol=1e-5)


def test_plain_version_matches_jax_patchify_matmul_bf16():
    x, kernel = _inputs(1)
    got = patchify_embed(torch.from_numpy(x), torch.from_numpy(kernel).bfloat16())
    assert got.dtype == torch.bfloat16
    want = _jax_embed(x, kernel, jnp.bfloat16)
    rms = float(np.sqrt(np.mean(want ** 2)))
    ulp = 2.0 ** (np.floor(np.log2(rms)) - 7)  # one bf16 ulp at the RMS
    assert np.abs(got.float().numpy() - want).max() <= ulp


def test_plain_version_equals_port_patch_embed_product():
    """The same function as `PatchEmbed3D`'s patchify + matmul (bias left
    out): rows of the kernel in (tb, ph, pw, c) order."""
    from devias_tpu_torch.nn.vit import patchify_video as port_patchify

    x, kernel = _inputs(2)
    xt, kt = torch.from_numpy(x), torch.from_numpy(kernel)
    want = (port_patchify(xt) @ kt).reshape(2, 2, 15, DOUT)
    torch.testing.assert_close(patchify_embed_reference(xt, kt), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("shape,kshape", [
    ((2, 3, 48, 80, 3), (1536, DOUT)),   # odd T
    ((2, 4, 40, 80, 3), (1536, DOUT)),   # H not a multiple of 16
    ((2, 4, 48, 80, 1), (1536, DOUT)),   # one channel
    ((2, 4, 48, 80, 3), (768, DOUT)),    # kernel rows
    ((4, 48, 80, 3), (1536, DOUT)),      # no batch axis
])
def test_bad_shapes_raise(shape, kshape):
    with pytest.raises(ValueError):
        patchify_embed(torch.zeros(shape), torch.zeros(kshape))
