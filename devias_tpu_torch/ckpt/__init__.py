"""Checkpoints of the port: torch-native save and auto-resume, reference
`.pth` import with the finetune surgery and export, and the bridge from
flax trees."""

from devias_tpu_torch.ckpt.from_jax import load_jax_params, state_dict_from_jax
from devias_tpu_torch.ckpt.io import auto_resume, latest_checkpoint_step, load_checkpoint, save_checkpoint, save_weights
from devias_tpu_torch.ckpt.torch_export import export_state_dict, save_reference_checkpoint
from devias_tpu_torch.ckpt.torch_import import (
    import_torch_state_dict,
    load_reference_checkpoint,
    load_torch_checkpoint_file,
    merge_params,
)

__all__ = ["auto_resume", "export_state_dict", "import_torch_state_dict", "latest_checkpoint_step",
           "load_checkpoint", "load_jax_params", "load_reference_checkpoint", "load_torch_checkpoint_file",
           "merge_params", "save_checkpoint", "save_reference_checkpoint", "save_weights", "state_dict_from_jax"]
