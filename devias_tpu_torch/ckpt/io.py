"""Torch-native checkpoints with the reference's auto-resume semantics
(in place of `devias_tpu/ckpt/orbax_io.py`).

ref: utils/utils.py:442-517 — epoch-numbered checkpoints and
auto_load_model scanning for the newest saved epoch. One file per saved
epoch, `{dir}/checkpoint-{epoch}.pth`, in the reference's container layout:
{"model": state dict with the reference keys, "model_ema": the EMA's
tensors or None, "optimizer": the optimizer's state dict (its buffers and update
count), "epoch": e, "step": the train state's step, "rng": the step
generator's state or None}. Its "model" entry loads through
`ckpt/torch_import.py` like any reference checkpoint, so a trained port
checkpoint goes straight to `--finetune`. A weights-only checkpoint
(`save_weights`, what `cli/convert_checkpoint.py to_port` writes) has the
same container with no EMA, optimizer or generator state: it loads with
`--finetune`, and `load_checkpoint` refuses it.
"""

from __future__ import annotations

import os
import re
from typing import Optional, Tuple

import torch

from devias_tpu_torch.train.state import TrainState

_NAME = re.compile(r"^checkpoint-(\d+)\.pth$")


def _cpu(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to("cpu", copy=True)


def checkpoint_path(output_dir: str, epoch: int) -> str:
    return os.path.join(output_dir, f"checkpoint-{epoch}.pth")


def _write(output_dir: str, epoch: int, obj: dict) -> str:
    os.makedirs(output_dir, exist_ok=True)
    path = checkpoint_path(output_dir, epoch)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)
    return path


def save_checkpoint(output_dir: str, epoch: int, state: TrainState,
                    generator: Optional[torch.Generator] = None) -> str:
    """Write `state` (and `generator`'s state) as epoch `epoch`'s
    checkpoint, through a temporary file and a rename. Returns its path."""
    return _write(output_dir, epoch, {
        "model": {k: _cpu(v) for k, v in state.model.state_dict().items()},
        "model_ema": None if state.ema_params is None else {k: _cpu(v) for k, v in state.ema_params.items()},
        "optimizer": state.optimizer.state_dict(),
        "epoch": int(epoch),
        "step": int(state.step),
        "rng": None if generator is None else generator.get_state(),
    })


def save_weights(output_dir: str, epoch: int, state_dict: dict) -> str:
    """Write a weights-only checkpoint of `state_dict` as epoch `epoch`'s
    (no EMA, optimizer or generator state). Returns its path."""
    return _write(output_dir, epoch, {"model": {k: _cpu(v) for k, v in state_dict.items()}, "model_ema": None,
                                      "optimizer": None, "epoch": int(epoch), "step": 0, "rng": None})


def latest_checkpoint_step(output_dir: str) -> Optional[int]:
    """The newest saved epoch under `output_dir`, or None."""
    if not os.path.isdir(output_dir):
        return None
    epochs = [int(m.group(1)) for m in map(_NAME.match, os.listdir(output_dir)) if m]
    return max(epochs) if epochs else None


def load_checkpoint(path: str, state: TrainState, generator: Optional[torch.Generator] = None) -> int:
    """Restore a checkpoint into `state` (and `generator`) in place:
    parameters, EMA, optimizer moments and count, step. Returns its epoch."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if obj["optimizer"] is None:
        raise ValueError(f"{path} holds weights only (no optimizer state); load it with --finetune")
    state.model.load_state_dict(obj["model"], strict=True)
    if (obj["model_ema"] is None) != (state.ema_params is None):
        raise ValueError(f"{path}: the checkpoint's EMA and the train state's disagree on whether there is one")
    if state.ema_params is not None:
        with torch.no_grad():
            for k, v in obj["model_ema"].items():
                state.ema_params[k].copy_(v)
    state.optimizer.load_state_dict(obj["optimizer"])
    state.step = int(obj["step"])
    if generator is not None:
        if obj["rng"] is None:
            raise ValueError(f"{path} holds no generator state")
        generator.set_state(obj["rng"])
    return int(obj["epoch"])


def auto_resume(output_dir: str, state: TrainState,
                generator: Optional[torch.Generator] = None) -> Tuple[Optional[TrainState], Optional[int]]:
    """ref utils/utils.py:467-517: restore the newest checkpoint in
    `output_dir` into `state`; returns (state, epoch) or (None, None)."""
    epoch = latest_checkpoint_step(output_dir)
    if epoch is None:
        return None, None
    load_checkpoint(checkpoint_path(output_dir, epoch), state, generator)
    return state, epoch
