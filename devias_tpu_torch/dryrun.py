"""The port's dry run (port of the JAX package's `__graft_entry__.py`).

    python -m devias_tpu_torch.dryrun [N] [--device cpu]

`entry()` returns `(fn, example_args)`: the flagship eval forward (the
`slot_vit_base_patch16_224` student, ViT-B/16 on 16x224x224 clips, 8 tied
agg rounds over 2 slots, 400 + 365 head) in bfloat16 with K1, on `cuda`.
`dryrun_multichip(n)` starts n processes, joined by gloo on the CPU or on
fewer cards than n, and by NCCL where there are n cards, and runs one tiny
slot train step in each parallel mode the JAX dry run runs, printing one
line per mode and raising on the first failure:

- dp: `make_mesh()`, FAME on each rank's clips;
- dp zero1 and dp fsdp: the same step from the same weights, equal to dp's
  loss and parameters bitwise, with cut moments (and parameters);
- dp x tp: `make_mesh(model_parallel=2)` with the blocks cut;
- dp x sp: the sequence-parallel backbone against the plain one, then
  with dropout and drop-path;
- dp x pp: the full slot step under `make_pp_mesh(2)` against the
  one-process step on the same clips, then with dropout, drop-path and
  FAME;
- fsdp memory: the flagship's parameter tree placed with fsdp, this
  rank's resident bytes of parameters, moments and EMA against the logical
  bytes, at 1/n plus the leaves with no axis to cut, before and after a
  step on a small clip.

On the CPU (`--device cpu`) every model is the tiny one, the flagship's
geometry included. The process prints the entry's output shapes first,
then the mode lines of rank 0, and exits non-zero on a failure.
"""

from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys
from typing import Optional

import numpy as np
import torch

from devias_tpu_torch.cli.common import use_attention_kernel
from devias_tpu_torch.device import DeviceLike, resolve_device

TINY = dict(depth=2, embed_dim=64, num_heads=4)
SLOT = dict(num_classes=5, num_scene_classes=4, num_latents=2, agg_depth=2)
FLAGSHIP = dict(num_classes=400, num_scene_classes=365, num_latents=2, agg_depth=8, agg_weights_tie=True)
T, HW = 4, 32
RTOL = 1e-3


def _fused(dev: torch.device, kw: dict) -> bool:
    """K1 where it takes the model's head dim (`use_attention_kernel`)."""
    return use_attention_kernel(dev, kw.get("embed_dim", 768), kw.get("num_heads", 12))


def entry(device: DeviceLike = None, tiny: bool = False):
    """(fn, (model, video)): fn(model, video) -> (action_logit,
    scene_logit), the flagship eval forward in bfloat16 on `device` (`cuda`
    unless the caller asks for `cpu`), K1 on the card; `tiny` uses the
    2-layer, 64-wide backbone."""
    from devias_tpu_torch.nn import create_model

    dev = resolve_device(device)
    kw = dict(FLAGSHIP, **(TINY if tiny else {}))
    model = create_model("slot_vit_base_patch16_224", device=dev, dtype=torch.bfloat16,
                         fused_attention=_fused(dev, kw), **kw)
    video = torch.zeros((1, 16, 224, 224, 3), device=dev)

    def fn(model, video):
        with torch.inference_mode():
            out = model(video)
        return out["action_logit"], out["scene_logit"]

    return fn, (model, video)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def dryrun_multichip(n: int, device: DeviceLike = None) -> None:
    """Run the parallel modes over `n` processes of this module (module
    docstring) and relay rank 0's lines; raises RuntimeError when a process
    fails."""
    dev = resolve_device(device)
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-m", "devias_tpu_torch.dryrun", "--worker", str(r), str(port),
                               str(n), "--device", dev.type], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(n)]
    try:
        logs = [p.communicate(timeout=900)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
            p.wait()
    print(logs[0], end="", flush=True)
    bad = [r for r, p in enumerate(procs) if p.returncode]
    if bad:
        raise RuntimeError(f"dryrun_multichip({n}): ranks {bad} failed:\n" + "\n".join(logs[r] for r in bad)[-4000:])


# ---------------------------------------------------------------- one process


def _close(a: float, b: float, tol: float = RTOL) -> bool:
    return bool(np.isfinite(a)) and abs(a - b) <= tol * max(1.0, abs(b))


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"dryrun: {what}")


class _Run:
    """One process's modes; `say` prints on rank 0."""

    def __init__(self, rank: int, world: int, dev: torch.device):
        self.rank, self.world, self.dev = rank, world, dev
        self.tiny_flagship = dev.type == "cpu"
        rng = np.random.default_rng(0)
        B = 2 * world
        self.batch = {"videos": rng.normal(size=(B, T, HW, HW, 3)).astype(np.float32),
                      "labels": rng.integers(0, 5, size=B)}

    def say(self, line: str) -> None:
        if self.rank == 0:
            print(f"dryrun_multichip({self.world}): {line}", flush=True)

    def rows(self, n_rows: int, row: int) -> dict:
        b = self.batch["videos"].shape[0] // n_rows
        return {k: v[row * b:(row + 1) * b] for k, v in self.batch.items()}

    def slot(self, step_cfg=None, model_kw=None, **layout):
        """A tiny student, teacher, optimizer, state and slot step."""
        from devias_tpu_torch.aug import FAMEConfig
        from devias_tpu_torch.losses import SlotLossConfig
        from devias_tpu_torch.nn import create_model
        from devias_tpu_torch.train import (OptimConfig, TrainState, TrainStepConfig, make_optimizer,
                                            make_slot_train_step)

        kw = dict(SLOT, **TINY, **(model_kw or {}))
        model = create_model("slot_vit_base_patch16_224", device=self.dev, img_size=HW,
                             fused_attention=_fused(self.dev, kw), **kw)
        teacher = create_model("vit_base_patch16_224", device=self.dev, seed=1, num_classes=4, use_mean_pooling=False,
                               fused_attention=_fused(self.dev, TINY), **TINY)
        opt, lr_fn = make_optimizer(model, OptimConfig(lr=1e-3, total_steps=10, num_layers=TINY["depth"]),
                                    device=self.dev)
        state = TrainState.create(model, opt, use_ema=True, device=self.dev)
        step_cfg = step_cfg or TrainStepConfig(use_fame=True, fame=FAMEConfig(beta=0.25, prob_aug=0.5))
        step = make_slot_train_step(model, teacher, opt, SlotLossConfig(5, 4), step_cfg, lr_fn, device=self.dev,
                                    **layout)
        return model, state, step

    def run_step(self, state, step, batch, seed: int = 0) -> float:
        m = step(state, batch, generator=torch.Generator().manual_seed(seed), host_metrics=True)
        _check(np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"]), f"non-finite metrics {m}")
        return m["loss"]

    def data_modes(self) -> None:
        from devias_tpu_torch.core.dist import make_mesh, shard_train_state

        mesh = make_mesh()
        mine = self.rows(self.world, self.rank)
        model, state, step = self.slot(dp_mesh=mesh)
        loss = self.run_step(state, step, mine)
        _check(state.step == 1, "dp: the step count did not advance")
        self.say(f"dp loss={loss:.4f} ok")
        want = {n: p.detach().clone() for n, p in model.named_parameters()}
        for mode in ("zero1", "fsdp"):
            model, state, step = self.slot(dp_mesh=mesh)
            shard_train_state(state, mesh, zero1=mode == "zero1", fsdp=mode == "fsdp")
            got = self.run_step(state, step, mine)
            pl = state.placement
            n_cut = len(pl.moments) if mode == "zero1" else len(pl.params)
            pl.gather_params()
            same = all(torch.equal(p, want[n]) for n, p in model.named_parameters())
            _check(got == loss and same and n_cut > 0, f"dp {mode}: loss {got} against {loss}, bitwise {same}")
            self.say(f"dp {mode} loss={got:.4f} ({n_cut} cut {'moment' if mode == 'zero1' else 'param'} leaves, "
                     f"parameters bitwise dp's) ok")

    def tp_mode(self) -> None:
        from devias_tpu_torch.core.dist import make_mesh, shard_train_state

        mesh = make_mesh(model_parallel=2)
        _, state, step = self.slot(dp_mesh=mesh)
        shard_train_state(state, mesh, tp=True)
        loss = self.run_step(state, step, self.rows(mesh.data_size, mesh.data_rank))
        self.say(f"dp x tp loss={loss:.4f} ({len(state.placement.params)} cut param leaves) ok")

    def sp_modes(self) -> None:
        from devias_tpu_torch.core.dist import make_sp_mesh, seq_parallel_tokens
        from devias_tpu_torch.nn.vit import VideoViT, init_weights

        mesh = make_sp_mesh(2)
        videos = torch.from_numpy(self.rows(mesh.data_size, mesh.data_rank)["videos"]).to(self.dev)
        # a token loss that is not constant under the final LayerNorm
        w = torch.randn(TINY["embed_dim"], generator=torch.Generator().manual_seed(3)).to(self.dev)
        for sto in (False, True):
            kw = dict(TINY, drop_rate=0.1, drop_path_rate=0.2) if sto else TINY
            model = VideoViT(img_size=HW, fused_attention=_fused(self.dev, TINY), **kw)
            init_weights(model, torch.Generator().manual_seed(2))
            model.to(self.dev).train(sto)
            tokens = seq_parallel_tokens(model, videos, mesh, deterministic=not sto,
                                         generator=torch.Generator().manual_seed(7))
            loss = (tokens.float() @ w).square().mean()
            loss.backward()
            finite = all(torch.isfinite(p.grad).all() for p in model.parameters() if p.grad is not None)
            if sto:
                _check(bool(torch.isfinite(loss)) and finite, "dp x sp stochastic: non-finite")
                self.say(f"dp x sp stochastic loss={loss.item():.4f} ok")
            else:
                with torch.no_grad():
                    ref = (model.eval()(videos).float() @ w).square().mean().item()
                _check(_close(loss.item(), ref) and finite, f"dp x sp: loss {loss.item()} against {ref}")
                self.say(f"dp x sp loss={loss.item():.4f} (unsharded {ref:.4f}) ok")

    def pp_mode(self) -> None:
        from devias_tpu_torch.aug import FAMEConfig
        from devias_tpu_torch.core.pipeline import make_pp_mesh
        from devias_tpu_torch.train import TrainStepConfig

        mesh = make_pp_mesh(2)
        mine = self.rows(mesh.data_size, mesh.data_rank)
        cfg = TrainStepConfig(use_fame=False, pp_microbatches=2)
        _, state, step = self.slot(cfg, pp_mesh=mesh)
        loss = self.run_step(state, step, mine)
        _, ref_state, ref_step = self.slot(cfg)
        ref = self.run_step(ref_state, ref_step, self.batch)
        _check(_close(loss, ref), f"dp x pp: loss {loss} against the one-process {ref}")
        sto_cfg = TrainStepConfig(use_fame=True, fame=FAMEConfig(beta=0.25, prob_aug=0.5), pp_microbatches=2)
        _, sto_state, sto_step = self.slot(sto_cfg, dict(drop_path_rate=0.2, drop_rate=0.1), pp_mesh=mesh)
        sto = self.run_step(sto_state, sto_step, mine, seed=1)
        self.say(f"dp x pp FULL slot step loss={loss:.4f} (unsharded {ref:.4f}), stochastic loss={sto:.4f} ok")

    def fsdp_memory(self) -> None:
        """The flagship's tree (the tiny one on the CPU) placed with fsdp."""
        from devias_tpu_torch.core.dist import make_mesh, resident_bytes, shard_train_state, zero1_axis
        from devias_tpu_torch.losses import SlotLossConfig
        from devias_tpu_torch.nn import create_model
        from devias_tpu_torch.train import (OptimConfig, TrainState, TrainStepConfig, make_optimizer,
                                            make_slot_train_step)

        kw = dict(FLAGSHIP, **(TINY if self.tiny_flagship else {}))
        hw = 128
        # the flagship's compute dtype on the card, where K1 takes bf16
        dtype = torch.bfloat16 if self.dev.type == "cuda" else torch.float32
        model = create_model("slot_vit_base_patch16_224", device=self.dev, img_size=hw, dtype=dtype,
                             fused_attention=_fused(self.dev, kw), **kw)
        teacher = create_model("vit_base_patch16_224", device=self.dev, seed=1, num_classes=365,
                               use_mean_pooling=False, dtype=dtype, fused_attention=_fused(self.dev, kw),
                               **(TINY if self.tiny_flagship else {}))
        opt, lr_fn = make_optimizer(model, OptimConfig(lr=1e-3, total_steps=10), device=self.dev)
        state = TrainState.create(model, opt, use_ema=True, device=self.dev)
        n = self.world
        logical = want = 0
        for p in model.parameters():
            b = p.numel() * p.element_size()
            logical += 4 * b  # the parameter, two moments, the EMA entry
            want += 4 * (b // n if zero1_axis(p.shape, n) is not None else b)
        mesh = make_mesh()
        shard_train_state(state, mesh, fsdp=True)
        step = make_slot_train_step(model, teacher, opt, SlotLossConfig(400, 365), TrainStepConfig(use_fame=False),
                                    lr_fn, dp_mesh=mesh, device=self.dev)

        def resident():
            return sum(resident_bytes(state).values())

        before = resident()
        rng = np.random.default_rng(2)
        self.run_step(state, step, {"videos": rng.normal(size=(1, 2, hw, hw, 3)).astype(np.float32),
                                    "labels": rng.integers(0, 400, size=1)})
        after = resident()
        _check(before == want == after and want < logical, f"fsdp memory: resident {before}, {after}; want {want} "
                                                           f"of {logical}")
        geometry = "tiny" if self.tiny_flagship else "full"
        self.say(f"{geometry}-geometry fsdp resident {before / 1e6:.1f} MB vs logical {logical / 1e6:.1f} MB "
                 f"(1/{n} plus the uncut leaves, before and after a step) ok")

    def all(self) -> None:
        self.data_modes()
        if self.world % 2 == 0:
            self.tp_mode()
            self.sp_modes()
            self.pp_mode()
        self.fsdp_memory()


def _worker(rank: int, port: int, world: int, device: str) -> None:
    import torch.distributed as dist

    dev = resolve_device(device)
    backend = "gloo"
    if dev.type == "cuda":
        backend = "nccl" if torch.cuda.device_count() >= world else "gloo"
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    else:
        torch.set_num_threads(1)
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}", world_size=world, rank=rank)
    try:
        run = _Run(rank, world, dev)
        run.say(f"{backend} over {world} processes on {dev.type}")
        run.all()
    finally:
        dist.destroy_process_group()


def main(argv: Optional[list] = None) -> int:
    p = argparse.ArgumentParser("python -m devias_tpu_torch.dryrun")
    p.add_argument("n", nargs="?", type=int, default=None, help="processes (default: the card count)")
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    p.add_argument("--worker", nargs=3, type=int, metavar=("RANK", "PORT", "WORLD"), help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.worker:
        _worker(*args.worker, args.device)
        return 0
    dev = resolve_device(args.device)
    fn, example = entry(dev, tiny=dev.type == "cpu")
    print("entry ok:", [tuple(o.shape) for o in fn(*example)], flush=True)
    n = args.n or (torch.cuda.device_count() if dev.type == "cuda" else 2)
    dryrun_multichip(n, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
