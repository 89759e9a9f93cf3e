"""Process layouts, the sequence-parallel backbone, tensor parallelism
and the placement of a train state over a layout (port of
`devias_tpu/core/dist.py`).

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

Tensor parallelism (TP, `make_mesh(model_parallel=t)`) cuts the student's
blocks Megatron-style over the t ranks of a model group
(`shard_blocks_tp`): the fused qkv and fc1 column-parallel, proj and fc2
row-parallel. `copy_to_model_group` (identity forward, all-reduce
backward) feeds each column-parallel product and `reduce_from_model_group`
(all-reduce forward, identity backward) sums each row-parallel one. The
pipeline layout (`core/pipeline.py::make_pp_mesh`) is the third inner
axis. One `SPMesh` describes all of them: a data axis and at most one
inner axis (seq, model or pipe) of more than one rank.

`shard_train_state` places a `TrainState` over a layout (a `Placement`):
ZeRO-1 keeps each rank's slice of the AdamW moments along `zero1_axis`;
FSDP also keeps only that slice of the parameters and the EMA between
steps, gathering the full weights at each step's start; TP keeps the
blocks' cut weights, their moments and their EMA. The gradients are
reduced over the data group as under DP, so ZeRO-1 and FSDP do DP's
arithmetic element for element. `Shard` says how one tensor is cut and
`gather_shards` puts the pieces back together, in one all-gather per call.
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
MODEL_AXIS = "model"
PIPE_AXIS = "pipe"


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
    """A process layout of data rows and one inner axis: seq (sequence
    parallelism, `make_sp_mesh`), model (tensor parallelism,
    `make_mesh(model_parallel=t)`) or pipe (pipeline parallelism,
    `core/pipeline.py::make_pp_mesh`); the other two keep one rank. Rank r
    is inner rank r mod inner_size of data row r // inner_size, as the JAX
    mesh lays devices out. Each `*_group` holds this rank's data row along
    its axis, `data_group` the ranks of its inner position across the rows;
    a group is None where its axis has one rank and no collective runs over
    it (`make_mesh`'s inner axes, a single row's data axis)."""

    seq_group: Any
    seq_rank: int
    seq_size: int
    data_group: Any = None
    data_rank: int = 0
    data_size: int = 1
    model_group: Any = None
    model_rank: int = 0
    model_size: int = 1
    pipe_group: Any = None
    pipe_rank: int = 0
    pipe_size: int = 1

    @property
    def seq_root(self) -> int:
        """Global rank of this seq group's first rank."""
        return self.data_rank * self.seq_size

    @property
    def inner(self) -> tuple:
        """(group, rank, size) of the inner axis with more than one rank, or
        the seq axis's."""
        for axis in ("model", "pipe"):
            if getattr(self, f"{axis}_size") > 1:
                return getattr(self, f"{axis}_group"), getattr(self, f"{axis}_rank"), getattr(self, f"{axis}_size")
        return self.seq_group, self.seq_rank, self.seq_size

    @property
    def inner_root(self) -> int:
        """Global rank of this data row's first rank."""
        return self.data_rank * self.inner[2]


def _world() -> tuple:
    if not dist.is_initialized():
        raise RuntimeError("a process layout needs an initialised process group (maybe_init_distributed)")
    return dist.get_rank(), dist.get_world_size()


def _group(ranks: List[int], world: int):
    """A process group of `ranks`. `dist.new_group` is collective over the
    whole world: every rank calls this for every group, in one order."""
    return dist.group.WORLD if len(ranks) == world else dist.new_group(ranks)


def _layout(inner: int, axis: str) -> SPMesh:
    """Data rows of `inner` ranks along `axis` over the initialised process
    group. Every rank creates every inner group, then every data group, in
    rank order, and keeps its own."""
    rank, world = _world()
    if inner < 1 or world % inner:
        raise ValueError(f"{world} processes not divisible by {axis}_parallel={inner}")
    rows = world // inner
    # a seq axis of one keeps a group: the sequence-parallel collectives
    # run over it whatever its size
    inner_groups = ([_group([d * inner + s for s in range(inner)], world) for d in range(rows)]
                    if inner > 1 or axis == SEQ_AXIS else [None] * rows)
    data_groups = ([_group([d * inner + s for d in range(rows)], world) for s in range(inner)]
                   if rows > 1 else [None] * inner)
    data_rank, inner_rank = divmod(rank, inner)
    kw = {f"{axis}_group": inner_groups[data_rank], f"{axis}_rank": inner_rank, f"{axis}_size": inner}
    return SPMesh(**{"seq_group": None, "seq_rank": 0, "seq_size": 1, **kw}, data_group=data_groups[inner_rank],
                  data_rank=data_rank, data_size=rows)


def make_sp_mesh(seq_parallel: int) -> SPMesh:
    """A (data, seq) layout over the initialised process group, with
    `seq_parallel` ranks per seq group and world // seq_parallel data rows.
    Raises when the world size is not divisible by `seq_parallel`."""
    return _layout(seq_parallel, SEQ_AXIS)


def make_mesh(model_parallel: int = 1) -> SPMesh:
    """A (data, model) layout over the initialised process group (the JAX
    package's `make_mesh`): model groups of `model_parallel` ranks, which
    cut the student's blocks (`shard_blocks_tp`), and world //
    model_parallel data rows. `make_mesh()` is pure data parallelism: every
    rank a data row."""
    return _layout(model_parallel, MODEL_AXIS)


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


def _all_reduce_f32(x: torch.Tensor, group) -> torch.Tensor:
    """`x` summed over `group` in float32 (a new tensor), in `x`'s dtype."""
    y = x.float().clone()
    dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
    return y.to(x.dtype)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce_f32(grad, ctx.mesh.model_group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return _all_reduce_f32(x, mesh.model_group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_model_group(x: torch.Tensor, mesh: SPMesh) -> torch.Tensor:
    """The input of a column-parallel product: identity forward; the
    backward sums the gradient over the model group, since each rank's
    columns give only their part of it (Megatron's f)."""
    return _CopyToModel.apply(x, mesh)


def reduce_from_model_group(x: torch.Tensor, mesh: SPMesh) -> torch.Tensor:
    """The output of a row-parallel product: each rank's partial sum,
    summed over the model group in float32; identity backward (Megatron's
    g)."""
    return _ReduceFromModel.apply(x, mesh)


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


def broadcast_in_row(tensors: Sequence[torch.Tensor], mesh: SPMesh) -> None:
    """Overwrite `tensors` on every rank of the data row (its seq, model or
    pipe group) with the row's first rank's (in place)."""
    group = mesh.inner[0]
    for t in tensors:
        dist.broadcast(t, src=mesh.inner_root, group=group)


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


def reduce_stage_grads(model: nn.Module, mesh: SPMesh) -> None:
    """Sum over the pipe group, in one all-reduce, the gradients that only
    one stage computes: each block's (its own stage) and the patch embed's,
    extra tokens' and positions' (stage 0). The final norm, the agg block
    and the heads run on every pipe rank on the same tokens and hold the
    same gradient there, so they are left alone (a sum would scale them by
    the number of stages). A parameter a stage did not reach gets a zero
    gradient first."""
    grads = []
    for name, p in model.named_parameters():
        if p.requires_grad and name.split(".", 1)[0] in STAGE_MODULES:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            grads.append(p.grad)
    _all_reduce_flat(grads, mesh.pipe_group)


# the backbone's modules whose gradient one pipeline stage computes
STAGE_MODULES = ("patch_embed", "cls_token", "scene_token", "pos_embed", "blocks")


def reduce_grads(model: nn.Module, mesh: SPMesh) -> None:
    """The gradient reduction of a layout's step: the backbone's gradients
    summed over the seq group (SP), or the stages' over the pipe group
    (PP, `reduce_stage_grads`), then every gradient averaged over the data
    group, one flat all-reduce per group. Under TP the cut weights' gradients
    are each rank's own and the others agree already. Each data row's loss
    is the mean over its own samples, so with equal local batches the
    average is the gradient of the global batch's mean."""
    if mesh.seq_size > 1:
        reduce_backbone_grads(model, mesh)
    if mesh.pipe_size > 1:
        reduce_stage_grads(model, mesh)
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


# ---------------------------------------------------------------- placement


def zero1_axis(shape: Sequence[int], n: int, floating: bool = True) -> Optional[int]:
    """The ZeRO-1 rule of `devias_tpu/core/dist.py::zero1_spec`: the first
    axis whose size is at least `n` and divisible by it, or None for a 0-d
    or non-float tensor and where no axis qualifies (it stays replicated)."""
    if len(shape) == 0 or not floating:
        return None
    return next((axis for axis, d in enumerate(shape) if d >= n and d % n == 0), None)


@dataclasses.dataclass(frozen=True)
class Shard:
    """How one tensor is cut over `group`: `parts` equal blocks along `axis`
    (3 for the fused qkv's q | k | v), each cut in `size` equal pieces; rank
    `rank` of the group holds piece `rank` of every block, in block order."""

    axis: int
    rank: int
    size: int
    group: Any
    parts: int = 1

    def view(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's piece of `full` as a view (one block only)."""
        n = full.shape[self.axis] // self.size
        return full.narrow(self.axis, self.rank * n, n)

    def local(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's pieces of `full`, a new contiguous tensor."""
        blocks = full.chunk(self.parts, self.axis)
        return torch.cat([Shard(self.axis, self.rank, self.size, None).view(b) for b in blocks], self.axis).clone()


def gather_shards(pieces: Sequence[torch.Tensor], shards: Sequence[Shard]) -> List[torch.Tensor]:
    """The full tensors of `pieces` (this rank's, cut as `shards` say, all
    over one group): one all-gather of their concatenation per dtype."""
    out: List[Optional[torch.Tensor]] = [None] * len(pieces)
    for dtype in dict.fromkeys(t.dtype for t in pieces):
        idx = [i for i, t in enumerate(pieces) if t.dtype == dtype]
        size, group = shards[idx[0]].size, shards[idx[0]].group
        flat = torch.cat([pieces[i].reshape(-1) for i in idx])
        parts = [torch.empty_like(flat) for _ in range(size)]
        dist.all_gather(parts, flat, group=group)
        offset = 0
        for i in idx:
            t, sh = pieces[i], shards[i]
            by_rank = [p[offset:offset + t.numel()].view(t.shape).chunk(sh.parts, sh.axis) for p in parts]
            offset += t.numel()
            out[i] = torch.cat([torch.cat([r[b] for r in by_rank], sh.axis) for b in range(sh.parts)], sh.axis)
    return out


def _gather_dict(tensors: Dict[str, torch.Tensor], shards: Dict[str, Shard]) -> Dict[str, torch.Tensor]:
    names = [k for k in tensors if k in shards]
    full = gather_shards([tensors[k] for k in names], [shards[k] for k in names]) if names else []
    return {**tensors, **dict(zip(names, full))}


def shard_blocks_tp(model: nn.Module, mesh: SPMesh) -> Dict[str, Shard]:
    """Cut the blocks of `model`'s backbone over `mesh`'s model group in
    place, Megatron-style, and return the cut parameters' `Shard`s by name:
    the fused qkv column-parallel and head-aligned (rank m keeps the q, k
    and v rows of heads m H/t ... (m+1) H/t - 1), proj row-parallel (its
    input columns), fc1 column-parallel (rows and bias), fc2 row-parallel.
    These are the leaves `devias_tpu/core/dist.py::tp_param_spec` cuts; the
    q and v biases, the norms and the row-parallel biases stay whole.
    Each block then runs its K1 on its H/t heads (`nn/vit.py`)."""
    t, m, group = mesh.model_size, mesh.model_rank, mesh.model_group
    cuts = {"attn.qkv.weight": Shard(0, m, t, group, parts=3), "attn.proj.weight": Shard(1, m, t, group),
            "mlp.fc1.weight": Shard(0, m, t, group), "mlp.fc1.bias": Shard(0, m, t, group),
            "mlp.fc2.weight": Shard(1, m, t, group)}
    shards = {}
    with torch.no_grad():
        for i, blk in enumerate(model.blocks):
            if blk.attn.num_heads % t:
                raise ValueError(f"{blk.attn.num_heads} heads not divisible by model_parallel={t}")
            for name, shard in cuts.items():
                p = blk.get_parameter(name)
                p.data = shard.local(p.data)
                shards[f"blocks.{i}.{name}"] = shard
            blk.attn.tp = blk.mlp.tp = mesh
    return shards


@dataclasses.dataclass
class Placement:
    """Where a `TrainState`'s tensors live across a layout
    (`shard_train_state`). `params`: the parameters (and EMA entries) cut
    between steps, by name (FSDP over the data group, TP over the model
    group); `moments`: the optimizer buffers cut over the data group, by
    parameter index (ZeRO-1 and FSDP; their parameters are updated through
    a view of this rank's slice). Under FSDP `full` says whether the
    parameters are gathered now: from a step's start to its end, and after
    `gather_params`."""

    model: nn.Module
    optimizer: Any
    fsdp: bool = False
    params: Dict[str, Shard] = dataclasses.field(default_factory=dict)
    moments: Dict[int, Shard] = dataclasses.field(default_factory=dict)
    full: bool = False

    def _named(self) -> Dict[str, nn.Parameter]:
        return dict(self.model.named_parameters())

    @torch.no_grad()
    def gather_params(self) -> None:
        """FSDP: gather the full parameters (one all-gather)."""
        if self.fsdp and not self.full:
            named = self._named()
            names = list(self.params)
            for n, full in zip(names, gather_shards([named[n].data for n in names],
                                                    [self.params[n] for n in names])):
                named[n].data = full
            self.full = True

    @torch.no_grad()
    def release_params(self) -> None:
        """FSDP: keep only this rank's slices of the parameters."""
        if self.fsdp and self.full:
            named = self._named()
            for n, shard in self.params.items():
                named[n].data = shard.local(named[n].data)
        self.full = False

    @torch.no_grad()
    def after_update(self) -> None:
        """After the optimizer's update of this rank's slices: FSDP frees the
        full weights, ZeRO-1 all-gathers the updated slices into the
        replicated parameters (one all-gather)."""
        if self.fsdp:
            self.release_params()
        elif self.moments:
            params = self.optimizer.param_groups[0]["params"]
            idx = list(self.moments)
            pieces = [self.moments[i].view(params[i].data).contiguous() for i in idx]
            for i, full in zip(idx, gather_shards(pieces, [self.moments[i] for i in idx])):
                params[i].data.copy_(full)

    def _param_cut(self) -> Dict[str, Shard]:
        """The parameters cut now (FSDP's only while released)."""
        return {} if self.fsdp and self.full else self.params

    def _state_cuts(self) -> Dict[str, Shard]:
        """`_param_cut` by state-dict key: a parameter shared by several
        modules (the tied agg rounds) has a key for each."""
        cuts = self._param_cut()
        by_id = {id(p): cuts[n] for n, p in self.model.named_parameters() if n in cuts}
        return {k: by_id[id(t)] for k, t in self.model.state_dict(keep_vars=True).items() if id(t) in by_id}

    def _buffer_cuts(self) -> Dict[int, Shard]:
        if self.moments:
            return self.moments
        return {i: self.params[n] for i, n in enumerate(self.optimizer.names) if n in self.params}

    # -- full tensors for a checkpoint (collective), and back
    def full_model_state(self) -> Dict[str, torch.Tensor]:
        return _gather_dict(self.model.state_dict(), self._state_cuts())

    def full_ema(self, ema: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return _gather_dict(ema, self.params)

    def full_optimizer_state(self, sd: dict) -> dict:
        cuts = self._buffer_cuts()
        keys = [(i, k) for i in sorted(cuts) for k in sorted(sd["state"].get(i, {})) if torch.is_tensor(
            sd["state"][i][k]) and sd["state"][i][k].dim() > 0]
        full = gather_shards([sd["state"][i][k] for i, k in keys], [cuts[i] for i, _ in keys]) if keys else []
        state = {i: dict(v) for i, v in sd["state"].items()}
        for (i, k), t in zip(keys, full):
            state[i][k] = t
        return {**sd, "state": state}

    def local_model_state(self, sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        cuts = self._state_cuts()
        return {k: cuts[k].local(v) if k in cuts else v for k, v in sd.items()}

    def local_ema(self, ema: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return {k: self.params[k].local(v) if k in self.params else v for k, v in ema.items()}

    def local_optimizer_state(self, sd: dict) -> dict:
        cuts = self._buffer_cuts()
        state = {int(i): {k: cuts[int(i)].local(t) if int(i) in cuts and torch.is_tensor(t) and t.dim() > 0 else t
                          for k, t in v.items()} for i, v in sd["state"].items()}
        return {**sd, "state": state}


def resident_bytes(state) -> Dict[str, int]:
    """Bytes this rank holds now of `state`'s parameters, optimizer buffers
    and EMA (a placed state's slices, or the whole tensors)."""
    return {"params": sum(p.numel() * p.element_size() for p in state.model.parameters()),
            "moments": sum(t.numel() * t.element_size() for st in state.optimizer.state.values()
                           for t in st.values() if torch.is_tensor(t)),
            "ema": sum(t.numel() * t.element_size() for t in (state.ema_params or {}).values())}


def shard_train_state(state, mesh: Optional[SPMesh], zero1: bool = False, fsdp: bool = False, tp: bool = False):
    """Place `state` (a `train/state.py::TrainState`) over `mesh` in place
    and return it (`devias_tpu/core/dist.py::shard_train_state`):

    - zero1: each rank keeps its slice of every optimizer buffer along
      `zero1_axis` over the data group (a buffer with no such axis stays
      whole); the update runs on this rank's slices and the updated slices
      are all-gathered into the replicated parameters;
    - fsdp (implies zero1): the parameters and the EMA are cut the same way
      between steps, and each step gathers the full weights at its start
      and frees them at its end;
    - tp: the student's blocks are cut over the model group
      (`shard_blocks_tp`), their moments and EMA with them.

    The gradients are reduced over the data group as under DP and the
    global-norm clip sees whole gradients (under TP the cut ones' norms are
    summed over the model group), so ZeRO-1 and FSDP take DP's steps element
    for element. `tp` with `zero1` or `fsdp` raises, as in JAX. Without a
    layout, or with one rank on the axis a mode cuts over, nothing is cut
    and the state stays unplaced."""
    if tp and (zero1 or fsdp):
        raise ValueError("tp placement with zero1/fsdp is not supported")
    zero1 = zero1 or fsdp
    if not (zero1 or tp):
        return state
    opt = state.optimizer
    placement = Placement(state.model, opt, fsdp=fsdp)
    params = opt.param_groups[0]["params"]
    with torch.no_grad():
        if tp and mesh is not None and mesh.model_size > 1:
            placement.params = shard_blocks_tp(state.model, mesh)
            opt.model_group = mesh.model_group
            opt.cut = [n in placement.params for n in opt.names]
        elif zero1 and mesh is not None and mesh.data_size > 1:
            n = mesh.data_size
            for i, (name, p) in enumerate(zip(opt.names, params)):
                axis = zero1_axis(p.shape, n, p.is_floating_point())
                if axis is not None:
                    placement.moments[i] = Shard(axis, mesh.data_rank, n, mesh.data_group)
                    if fsdp:
                        placement.params[name] = placement.moments[i]
            opt.shards = placement.moments
        for i, cut in placement._buffer_cuts().items():
            st = opt.state[params[i]]
            for k in list(st):
                if torch.is_tensor(st[k]) and st[k].dim() > 0:
                    st[k] = cut.local(st[k])
        if state.ema_params is not None:
            state.ema_params = placement.local_ema(state.ema_params)
        if fsdp:
            placement.full = True
            placement.release_params()
    if placement.params or placement.moments:
        state.placement = placement
    return state
