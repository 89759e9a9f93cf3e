"""Process groups and the sequence-parallel backbone (port of the
sequence-parallel part of `devias_tpu/core/dist.py`).

Sequence parallelism (SP) splits one clip's tokens over the ranks of a
seq group: each rank runs the backbone on its own frames (token order
(t, h, w) makes frame shards contiguous token shards), attention gathers
K/V over the group, and the gathered tokens feed the agg block, the heads
and the loss, which every rank computes alike. Two differentiable gathers
along the token axis make that work, and their backward passes differ:

- `gather_kv`, inside attention: all-gather forward, reduce-scatter-sum
  backward, because every rank's queries attend to every rank's keys;
- `gather_tokens`, after the backbone: all-gather forward, and the
  backward takes this rank's slice, because every rank computes the same
  loss on the same gathered tokens and so holds the whole gradient.

The backbone's parameter gradients are then summed over the group
(`reduce_backbone_grads`).

Data parallelism (DP) runs one process per card, as the reference's DDP
does: each data row of the layout reads its own shard of the batch, and
after the micro-batch loop every gradient is averaged over the data group
(`reduce_grads`), the one collective that stands for the gradient psum
XLA inserts in the JAX step. A layout of D data rows and S seq ranks
(`make_sp_mesh(S)` over D x S processes, or `make_mesh()` for S = 1)
combines both.

Two batch ops of the JAX package mix clips across the whole (global)
micro-batch, and under jit on the data mesh XLA moves the donors across
shards: FAME-HVU's donor permutation and mixup's flipped-batch partner.
Here each rank holds only its own rows, so `over_data_group` gathers the
data group's rows, applies the op to the global micro-batch with draws
from a stream every rank holds alike (`mix_generators`), and keeps this
rank's rows. The slot step's FAME stays shard-local, as in JAX.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from devias_tpu_torch.device import DeviceLike, resolve_device

DATA_AXIS = "data"
SEQ_AXIS = "seq"


def maybe_init_distributed(device: DeviceLike = None) -> bool:
    """Initialise `torch.distributed` when launched under a known launcher:

    - DEVIAS_TPU_COORDINATOR=<host:port> with DEVIAS_TPU_NUM_PROCS and
      DEVIAS_TPU_PROC_ID, as the JAX package reads them;
    - torchrun's RANK, WORLD_SIZE, MASTER_ADDR and MASTER_PORT.

    NCCL on `cuda` (`device`'s default; each process takes card rank mod
    the card count, or LOCAL_RANK), gloo on `cpu`. A single process with
    neither set is a no-op. Returns whether a process group is initialised.
    """
    if dist.is_initialized():
        return True
    dev = resolve_device(device)
    coordinator = os.environ.get("DEVIAS_TPU_COORDINATOR")
    if coordinator:
        kw = dict(init_method=f"tcp://{coordinator}", world_size=int(os.environ.get("DEVIAS_TPU_NUM_PROCS", "1")),
                  rank=int(os.environ.get("DEVIAS_TPU_PROC_ID", "0")))
    elif "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        kw = dict(init_method="env://")
    else:
        return False
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", kw.get("rank", os.environ.get("RANK", "0"))))
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo", **kw)
    return True


@dataclasses.dataclass(frozen=True)
class SPMesh:
    """The (data, seq) process layout of data- and sequence-parallel
    training. Rank r is seq rank r mod seq_size of data row r // seq_size,
    as the JAX mesh lays devices out. `seq_group` holds this rank's data
    row and `data_group` the ranks of its seq position across the rows;
    either is None where its axis has one rank and no collective runs over
    it (`make_mesh`'s seq axis, a single row's data axis)."""

    seq_group: Any
    seq_rank: int
    seq_size: int
    data_group: Any = None
    data_rank: int = 0
    data_size: int = 1

    @property
    def seq_root(self) -> int:
        """Global rank of this seq group's first rank."""
        return self.data_rank * self.seq_size


def _world() -> tuple:
    if not dist.is_initialized():
        raise RuntimeError("a process layout needs an initialised process group (maybe_init_distributed)")
    return dist.get_rank(), dist.get_world_size()


def _group(ranks: List[int], world: int):
    """A process group of `ranks`. `dist.new_group` is collective over the
    whole world: every rank calls this for every group, in one order."""
    return dist.group.WORLD if len(ranks) == world else dist.new_group(ranks)


def make_sp_mesh(seq_parallel: int) -> SPMesh:
    """A (data, seq) layout over the initialised process group, with
    `seq_parallel` ranks per seq group and world // seq_parallel data rows.
    Every rank creates every seq group, then every data group, in rank
    order, and keeps its own. Raises when the world size is not divisible
    by `seq_parallel`."""
    rank, world = _world()
    if seq_parallel < 1 or world % seq_parallel:
        raise ValueError(f"{world} processes not divisible by seq_parallel={seq_parallel}")
    rows = world // seq_parallel
    seq_groups = [_group([d * seq_parallel + s for s in range(seq_parallel)], world) for d in range(rows)]
    data_groups = ([_group([d * seq_parallel + s for d in range(rows)], world) for s in range(seq_parallel)]
                   if rows > 1 else [None] * seq_parallel)
    data_rank, seq_rank = divmod(rank, seq_parallel)
    return SPMesh(seq_group=seq_groups[data_rank], seq_rank=seq_rank, seq_size=seq_parallel,
                  data_group=data_groups[seq_rank], data_rank=data_rank, data_size=rows)


def make_mesh() -> SPMesh:
    """Pure data parallelism over the initialised process group (the JAX
    package's `make_mesh()` with no model axis): every rank a data row of
    one seq rank."""
    rank, world = _world()
    return SPMesh(seq_group=None, seq_rank=0, seq_size=1, data_group=dist.group.WORLD if world > 1 else None,
                  data_rank=rank, data_size=world)


def _all_gather_tokens(x: torch.Tensor, mesh: SPMesh) -> torch.Tensor:
    """[B, n, C] on each rank -> [B, seq_size * n, C], rank order."""
    x = x.contiguous()
    B, n, C = x.shape
    buf = x.new_empty((mesh.seq_size * B, n, C))
    dist.all_gather_into_tensor(buf, x, group=mesh.seq_group)
    return buf.view(mesh.seq_size, B, n, C).permute(1, 0, 2, 3).reshape(B, mesh.seq_size * n, C)


class _GatherKV(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _all_gather_tokens(x, mesh)

    @staticmethod
    def backward(ctx, grad):
        mesh = ctx.mesh
        B, N, C = grad.shape
        parts = grad.reshape(B, mesh.seq_size, N // mesh.seq_size, C).permute(1, 0, 2, 3)
        parts = parts.reshape(mesh.seq_size * B, N // mesh.seq_size, C)
        out = grad.new_empty((B, N // mesh.seq_size, C))
        dist.reduce_scatter_tensor(out, parts, op=dist.ReduceOp.SUM, group=mesh.seq_group)
        return out, None


class _GatherTokens(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _all_gather_tokens(x, mesh)

    @staticmethod
    def backward(ctx, grad):
        mesh = ctx.mesh
        n = grad.shape[1] // mesh.seq_size
        return grad[:, mesh.seq_rank * n:(mesh.seq_rank + 1) * n].contiguous(), None


def gather_kv(kv: torch.Tensor, mesh: SPMesh) -> torch.Tensor:
    """The K/V gather inside attention: [B, n, 2C] -> [B, seq_size * n, 2C];
    its backward sums each rank's K/V gradient over the group
    (reduce-scatter), as `jax.lax.all_gather`'s transpose does."""
    return _GatherKV.apply(kv, mesh)


def gather_tokens(tokens: torch.Tensor, mesh: SPMesh) -> torch.Tensor:
    """The token gather after the backbone: [B, n, C] -> [B, seq_size * n, C];
    its backward takes this rank's slice of the gradient, which every rank
    holds whole (a summing backward would scale every backbone gradient by
    seq_size)."""
    return _GatherTokens.apply(tokens, mesh)


def _fold(seed: int, *ids: int) -> int:
    """A 63-bit seed from `seed` and `ids` (jax.random.fold_in's role)."""
    return int(np.random.SeedSequence([seed, *ids]).generate_state(1, np.uint64)[0] >> np.uint64(1))


def _draw_seeds(generator: Optional[torch.Generator], n: int) -> List[int]:
    """`n` seeds drawn from `generator`: the same on every rank that holds
    it in one state (a card generator's draw synchronises with the card)."""
    if generator is None:
        raise ValueError("data- and sequence-parallel training need a torch.Generator")
    return torch.randint(0, 2 ** 62, (n,), generator=generator, device=generator.device).tolist()


def rank_generators(generator: torch.Generator, mesh: SPMesh, device) -> tuple:
    """(FAME, backbone, heads) generators of this rank, from three draws of
    `generator`, which every rank holds in one state. Each stream is folded
    with the data rank: the rows of a data-parallel layout mix, drop and
    draw their own samples, as JAX's per-shard keys do, while the seq ranks
    of a row share FAME (it runs on the row's first rank and is broadcast)
    and the replicated heads' dropout. The backbone's is the seed source of
    `sp_generators`; without SP the model takes the heads' generator."""
    return tuple(torch.Generator(device=d).manual_seed(_fold(s, mesh.data_rank))
                 for d, s in zip((device, "cpu", device), _draw_seeds(generator, 3)))


def mix_generators(generator: torch.Generator, mesh: SPMesh, device) -> tuple:
    """(batch op, model) generators of this rank, from two draws of
    `generator`, which every rank holds in one state. The batch op's
    stream is not folded: `over_data_group` applies the op to the global
    micro-batch on every rank, and every rank must draw the same
    permutation, lam and boxes. The model's (dropout, drop-path) is folded
    with the data rank, so each row drops its own samples."""
    op_seed, model_seed = _draw_seeds(generator, 2)
    return (torch.Generator(device=device).manual_seed(op_seed),
            torch.Generator(device=device).manual_seed(_fold(model_seed, mesh.data_rank)))


def over_data_group(fn: Callable[..., Sequence[torch.Tensor]], tensors: Sequence[torch.Tensor],
                    mesh: Optional[SPMesh]) -> tuple:
    """Apply a batch op that mixes clips across the global micro-batch.
    `tensors` are this rank's rows (equal counts on every rank); each is
    gathered over the data group in data-rank order (one all-gather per
    tensor), `fn(*gathered)` returns tensors whose first axis is the global
    batch, and this rank's rows of each are returned. Every rank computes
    the whole op, with draws it must take alike (`mix_generators`). With no
    layout or one data row, `fn(*tensors)`. Not differentiable: it runs on
    the inputs, before the model."""
    if mesh is None or mesh.data_size == 1:
        return tuple(fn(*tensors))
    b = tensors[0].shape[0]
    gathered = []
    for t in tensors:
        parts = [torch.empty_like(t) for _ in range(mesh.data_size)]
        dist.all_gather(parts, t.contiguous(), group=mesh.data_group)
        gathered.append(torch.cat(parts))
    lo = mesh.data_rank * b
    return tuple(o[lo:lo + b] for o in fn(*gathered))


def sp_generators(generator: torch.Generator, mesh: SPMesh, device) -> tuple:
    """(token dropout, drop-path) generators of this rank, from two draws of
    `generator`, which every rank of the group holds in one state. Token
    dropout's stream differs per (data, seq) rank: a shared stream would
    repeat one mask on every token shard. Drop-path's is shared by the seq
    ranks of a data row, so a sample's keep decision agrees on all its
    token shards (`devias_tpu/core/dist.py:237-246`)."""
    token_seed, path_seed = _draw_seeds(generator, 2)
    return (torch.Generator(device=device).manual_seed(_fold(token_seed, mesh.data_rank, mesh.seq_rank)),
            torch.Generator(device=device).manual_seed(_fold(path_seed, mesh.data_rank)))


@contextlib.contextmanager
def _eval_mode(model: nn.Module):
    modes = [(m, m.training) for m in model.modules()]
    model.eval()
    try:
        yield
    finally:
        for m, training in modes:
            m.training = training


def seq_parallel_tokens(model: nn.Module, videos: torch.Tensor, mesh: SPMesh, deterministic: bool = True,
                        generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Run `model`'s backbone (a `VideoViT`, such as the student itself)
    sequence-parallel over `mesh`'s seq group and return the full token
    tensor [B, N, D], gathered (`gather_tokens`) for the replicated agg,
    heads and loss.

    Every rank passes the full clips [B, T, H, W, C]; each runs its
    T / seq_size frames. `deterministic=True` runs the backbone as in
    `eval()`; `deterministic=False` runs it in the model's own mode with
    the streams of `sp_generators(generator, ...)`."""
    T = videos.shape[1]
    s = mesh.seq_size
    tb = model.patch_embed.tubelet_size
    if T % (s * tb):
        raise ValueError(f"frames {T} not divisible by seq shards {s} x tubelet {tb}")
    if not deterministic and generator is None:
        raise ValueError("deterministic=False requires a generator")
    f = T // s
    local = videos[:, mesh.seq_rank * f:(mesh.seq_rank + 1) * f]
    if deterministic:
        with _eval_mode(model):
            tokens = model.forward_features(local, seq=mesh)
    else:
        token_gen, path_gen = sp_generators(generator, mesh, videos.device)
        tokens = model.forward_features(local, token_gen, seq=mesh, path_generator=path_gen)
    return gather_tokens(tokens, mesh)


def broadcast_from_seq_root(tensors: Sequence[torch.Tensor], mesh: SPMesh) -> None:
    """Overwrite `tensors` on every rank of the seq group with the group's
    first rank's (in place)."""
    for t in tensors:
        dist.broadcast(t, src=mesh.seq_root, group=mesh.seq_group)


def _all_reduce_flat(tensors: List[torch.Tensor], group, scale: float = 1.0) -> None:
    """Sum `tensors` over `group` in one all-reduce of their concatenation,
    times `scale`, in place."""
    if not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    if scale != 1.0:
        flat.mul_(scale)
    for t, part in zip(tensors, flat.split([t.numel() for t in tensors])):
        t.copy_(part.view_as(t))


def reduce_backbone_grads(model: nn.Module, mesh: SPMesh) -> None:
    """Sum the backbone parameters' gradients over the seq group, in one
    all-reduce. Each rank's backbone saw its own tokens; the agg and head
    gradients are the same on every rank already."""
    _all_reduce_flat([p.grad for p in model.backbone_parameters() if p.grad is not None], mesh.seq_group)


def reduce_grads(model: nn.Module, mesh: SPMesh) -> None:
    """The gradient reduction of a data- and sequence-parallel step: the
    backbone's gradients summed over the seq group, then every gradient
    averaged over the data group, one flat all-reduce per group. Each data
    row's loss is the mean over its own samples, so with equal local
    batches the average is the gradient of the global batch's mean."""
    if mesh.seq_size > 1:
        reduce_backbone_grads(model, mesh)
    if mesh.data_size > 1:
        _all_reduce_flat([p.grad for p in model.parameters() if p.grad is not None], mesh.data_group,
                         1.0 / mesh.data_size)


def mean_over_data(values: Dict[str, torch.Tensor], mesh: SPMesh) -> Dict[str, torch.Tensor]:
    """0-d metric tensors averaged over the data group in one all-reduce,
    on their device (no host sync on the card)."""
    if mesh.data_size == 1:
        return values
    names = list(values)
    flat = torch.stack([values[k].float() for k in names])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=mesh.data_group)
    return dict(zip(names, (flat / mesh.data_size).unbind()))


def min_over_data(value: torch.Tensor, mesh: SPMesh) -> torch.Tensor:
    """A 0-d tensor's minimum over the data group (a copy), on its device."""
    if mesh.data_size == 1:
        return value
    value = value.clone()
    dist.all_reduce(value, op=dist.ReduceOp.MIN, group=mesh.data_group)
    return value
