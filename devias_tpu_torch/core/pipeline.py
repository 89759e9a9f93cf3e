"""Pipeline parallelism of the video backbone (port of
`devias_tpu/core/pipeline.py`).

A (data, pipe) layout (`make_pp_mesh`): the batch over the data rows, the
ViT's blocks over the p ranks of each row's pipe group, stage s holding
blocks s·depth/p ... (s+1)·depth/p - 1. `pipeline_tokens` runs GPipe: the
stage's blocks on each of the M micro-batches of the local batch in turn,
activations [b/M, N, D] handed to the next stage by point-to-point sends,
the last stage's finished tokens broadcast to every pipe rank and the
final norm applied there, so the agg block, the heads and the loss run on
every pipe rank, as in JAX. The backward runs the micro-batches in
reverse, the token gradients sent back stage by stage. Stage 0 alone runs
the patch embed and the positions (JAX runs them on every pipe rank and
keeps stage 0's). The whole train state stays on every pipe rank, as in
JAX; `core/dist.py::reduce_stage_grads` sums the gradients that one stage
computes.

Gloo sends only host tensors, so with gloo a card's activations and
gradients go through pinned host buffers (`_send`, `_recv`); NCCL sends
them from the card. Stochastic draws do not depend on the stage: each
block application draws its dropout and drop-path from generators seeded
by `block_seed(seed, data row, global block, micro-batch)`, and the
embed's dropout from one folded by the data row alone, as
`devias_tpu/core/pipeline.py:24-37` folds its keys; each block keeps its
own linspace drop-path rate by its global index.
"""

from __future__ import annotations

import contextlib
from typing import List, Optional

import torch
import torch.distributed as dist
from torch import nn

from devias_tpu_torch.core.dist import PIPE_AXIS, SPMesh, _draw_seeds, _eval_mode, _fold, _layout

__all__ = ["PIPE_AXIS", "block_seed", "make_pp_mesh", "pipeline_tokens"]


def make_pp_mesh(pipe_parallel: int) -> SPMesh:
    """A (data, pipe) layout over the initialised process group: pipe groups
    of `pipe_parallel` ranks and world // pipe_parallel data rows."""
    return _layout(pipe_parallel, PIPE_AXIS)


def block_seed(seed: int, data_row: int, block: int, micro: int) -> int:
    """The seed of one block application's draws: the same for a data row,
    global block index and micro-batch whatever stage runs it."""
    return _fold(seed, data_row, block, micro)


def _as_bytes(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().reshape(-1).view(torch.uint8)


def _staged(t: torch.Tensor) -> bool:
    """Whether `t` goes through a host buffer: a card tensor under gloo."""
    return t.is_cuda and dist.get_backend() == "gloo"


def _send(t: torch.Tensor, dst: int) -> None:
    if _staged(t):
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t)
        t = host
    dist.send(_as_bytes(t), dst)


def _recv(like: torch.Tensor, src: int) -> torch.Tensor:
    """A tensor of `like`'s shape, dtype and device from rank `src`."""
    buf = torch.empty(like.shape, dtype=like.dtype, pin_memory=True) if _staged(like) else torch.empty_like(like)
    dist.recv(_as_bytes(buf), src)
    return buf.to(like.device, non_blocking=False)


class _Stages:
    """One call's GPipe schedule on this rank: the forward's per-micro-batch
    graphs of this stage and their inputs, kept for the backward."""

    def __init__(self, model: nn.Module, videos: torch.Tensor, mesh: SPMesh, n_micro: int,
                 seeds: Optional[List[int]]):
        self.model, self.videos, self.mesh, self.M, self.seeds = model, videos, mesh, n_micro, seeds
        self.grad = torch.is_grad_enabled()  # the caller's: the op's forward runs without grad
        p, s = mesh.pipe_size, mesh.pipe_rank
        per = len(model.blocks) // p
        self.ids = range(s * per, (s + 1) * per)
        root = mesh.data_rank * p
        self.prev, self.next, self.last = root + s - 1, root + s + 1, root + p - 1
        self.inputs, self.outputs, self.embedded = [], [], None

    def _generators(self, block: int, micro: int):
        if self.seeds is None:
            return None, None
        dev = self.videos.device
        return tuple(torch.Generator(device=dev).manual_seed(block_seed(seed, self.mesh.data_rank, block, micro))
                     for seed in self.seeds[1:])

    def forward(self) -> torch.Tensor:
        model, mesh, M = self.model, self.mesh, self.M
        b = self.videos.shape[0]
        mb = b // M
        first, last = mesh.pipe_rank == 0, mesh.pipe_rank == mesh.pipe_size - 1
        if first:
            gen = None if self.seeds is None else torch.Generator(device=self.videos.device).manual_seed(
                _fold(self.seeds[0], mesh.data_rank))
            with torch.set_grad_enabled(self.grad):
                self.embedded = model.embed(self.videos, gen)
                self.x = self.embedded.detach().requires_grad_()
                chunks = self.x.split(mb)
            like = chunks[0]
        else:
            like = self._like(mb)
        for j in range(M):
            inp = chunks[j] if first else _recv(like, self.prev).requires_grad_()
            with torch.set_grad_enabled(self.grad):
                out = inp
                for i in self.ids:
                    out = model.run_block(model.blocks[i], out, *self._generators(i, j))
            self.inputs.append(inp)
            self.outputs.append(out)
            if not last:
                _send(out.detach(), self.next)
        y = torch.cat([o.detach() for o in self.outputs]) if last else self._like(b)
        dist.broadcast(_as_bytes(y), src=self.last, group=mesh.pipe_group)
        return y

    def _like(self, n: int) -> torch.Tensor:
        """An empty activation of n clips: [n, N, D] in the model's dtype."""
        tb, p = self.model.patch_embed.tubelet_size, self.model.patch_embed.patch_size
        T, H, W = self.videos.shape[1:4]
        N = (T // tb) * (H // p) * (W // p)
        return torch.empty((n, N, self.model.embed_dim), dtype=self.model.dtype, device=self.videos.device)

    def backward(self, grad: torch.Tensor) -> None:
        mesh = self.mesh
        last = mesh.pipe_rank == mesh.pipe_size - 1
        grads = grad.split(grad.shape[0] // self.M) if last else None
        for j in reversed(range(self.M)):
            g = grads[j].contiguous() if last else _recv(self.outputs[j], self.next)
            torch.autograd.backward(self.outputs[j], g)
            if mesh.pipe_rank > 0:
                _send(self.inputs[j].grad, self.prev)
        if mesh.pipe_rank == 0:
            torch.autograd.backward(self.embedded, self.x.grad)
        self.inputs = self.outputs = []


class _Pipeline(torch.autograd.Function):
    """The schedule as one differentiable op. Its output is the broadcast of
    the last stage's tokens, whose gradient every pipe rank holds whole
    (each computes the same loss on them): the last stage starts the
    backward from its own, the others from the gradients sent back."""

    @staticmethod
    def forward(ctx, anchor, stages):
        ctx.stages = stages
        return stages.forward()

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        ctx.stages.backward(grad)
        return None, None


def pipeline_tokens(model: nn.Module, videos: torch.Tensor, mesh: SPMesh, n_micro: int,
                    deterministic: bool = True, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Run `model`'s backbone (a `VideoViT`, such as the student) as a GPipe
    pipeline over `mesh`'s pipe group and return the tokens [b, N, D] after
    the final norm on every pipe rank of the row, equal to the backbone's
    forward up to rounding. Every rank of a row passes the row's clips
    [b, T, H, W, C]; b must divide into `n_micro` micro-batches.

    Differentiable: a backward through the result runs the stages'
    backward (module docstring). `deterministic=True` runs the blocks as in
    `eval()`; `deterministic=False` runs them in the model's own mode with
    draws seeded from three draws of `generator` (the embed's, the blocks'
    dropout, the blocks' drop-path; `block_seed`), which every rank of a
    data row must hold in one state."""
    if model.cls_token is not None or model.scene_token is not None:
        raise NotImplementedError("pipeline parallelism with cls/suffix tokens")
    depth, p = len(model.blocks), mesh.pipe_size
    if depth % p:
        raise ValueError(f"depth {depth} not divisible by pipe={p}")
    if not deterministic and generator is None:
        raise ValueError("deterministic=False requires a generator")
    if videos.shape[0] % n_micro:
        raise ValueError(f"local batch {videos.shape[0]} not divisible by n_micro {n_micro}")
    seeds = None if deterministic else _draw_seeds(generator, 3)
    context = _eval_mode(model) if deterministic else contextlib.nullcontext()
    with context:
        anchor = torch.empty(0, device=videos.device, requires_grad=torch.is_grad_enabled())
        y = _Pipeline.apply(anchor, _Stages(model, videos, mesh, n_micro, seeds))
        return y if model.norm is None else model.norm(y)
