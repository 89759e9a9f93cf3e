"""K5: patchify + tubelet embedding GEMM (port of
`scripts/retest_patchify_pallas.py::embed`).

`patchify_embed(x, kernel)`: x f32 [B, T, H, W, 3], kernel [2*16*16*3, Dout]
bf16 with rows in (tb, ph, pw, c) order (the layout `nn/vit.py::PatchEmbed3D`
flattens its Conv3d weight into) -> [B, T/2, (H/16)(W/16), Dout] bf16, the
clip rounded to bf16 and the products summed in f32. On a CUDA tensor it is
the hand-written kernel (`csrc/patch_embed.cu`, an implicit-im2col GEMM);
on a CPU tensor `patchify_embed_reference`. `patchify_embed.launches`
counts kernel launches.

Not on a path: `PatchEmbed3D` stays patchify + matmul, as the JAX package's
`patchify` mode does; the script that held the TPU kernel planned to wire
it in only after a measurement.
"""

from __future__ import annotations

import ctypes

import torch

from devias_tpu_torch.kernels import _build

TUBELET, PATCH, CHANNELS = 2, 16, 3
PATCH_DIM = TUBELET * PATCH * PATCH * CHANNELS


def _patches(x: torch.Tensor) -> torch.Tensor:
    """[B, T, H, W, C] -> [B, T/2, (H/16)(W/16), 2*16*16*C], (tb, ph, pw, c)
    order (`nn/vit.py::patchify_video` with the frame axis kept apart)."""
    B, T, H, W, C = x.shape
    t, h, w = T // TUBELET, H // PATCH, W // PATCH
    x = x.reshape(B, t, TUBELET, h, PATCH, w, PATCH, C).permute(0, 1, 3, 5, 2, 4, 6, 7)
    return x.reshape(B, t, h * w, TUBELET * PATCH * PATCH * C)


def _check(x: torch.Tensor, kernel: torch.Tensor) -> None:
    if x.dim() != 5 or x.shape[-1] != CHANNELS or x.shape[1] % TUBELET or x.shape[2] % PATCH \
            or x.shape[3] % PATCH:
        raise ValueError(f"x must be [B, T, H, W, {CHANNELS}] with T divisible by {TUBELET} and H, W by "
                         f"{PATCH}; got {tuple(x.shape)}")
    if kernel.dim() != 2 or kernel.shape[0] != PATCH_DIM:
        raise ValueError(f"kernel must be [{PATCH_DIM}, Dout]; got {tuple(kernel.shape)}")
    if x.device != kernel.device or x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no patch-embed path for x on {x.device} and kernel on {kernel.device}")


def patchify_embed_reference(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Plain K5: the clip in the kernel's dtype, patchified, times the
    kernel with f32 sums, in the kernel's dtype. In f32 throughout for an
    f32 kernel."""
    _check(x, kernel)
    return (_patches(x.to(kernel.dtype)).float() @ kernel.float()).to(kernel.dtype)


def patchify_embed(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """K5 (module docstring). CUDA tensors go through the kernel, which
    takes a contiguous f32 clip and a bf16 kernel whose width is a multiple
    of 8, and raises on anything else; CPU tensors take the plain version."""
    _check(x, kernel)
    if x.device.type == "cpu":
        return patchify_embed_reference(x, kernel)
    if x.dtype != torch.float32 or kernel.dtype != torch.bfloat16:
        raise ValueError(f"the K5 kernel takes an f32 clip and a bf16 kernel; got {x.dtype} and {kernel.dtype}")
    if kernel.shape[1] % 8:
        raise ValueError(f"the K5 kernel takes Dout a multiple of 8; got {kernel.shape[1]}")
    for name, t in (("x", x), ("kernel", kernel)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"the K5 kernel takes a contiguous, 16-byte aligned {name}")
    B, T, H, W, _ = x.shape
    Dout = kernel.shape[1]
    out = torch.empty((B, T // TUBELET, (H // PATCH) * (W // PATCH), Dout), dtype=torch.bfloat16, device=x.device)
    fn = _build.load("patch_embed").devias_patch_embed
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), kernel.data_ptr(), out.data_ptr(), B, T, H, W, Dout,
                torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"patch-embed kernel launch failed with CUDA error {rc}")
    patchify_embed.launches += 1
    return out


patchify_embed.launches = 0
