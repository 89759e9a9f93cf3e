"""Checkpoint bridges of the port."""

from devias_tpu_torch.ckpt.from_jax import load_jax_params, state_dict_from_jax

__all__ = ["load_jax_params", "state_dict_from_jax"]
