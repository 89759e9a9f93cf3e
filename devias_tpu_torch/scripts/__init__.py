"""The training-health tools of the port, one module each, named after
the JAX package's `scripts/` counterparts:

- `full_scale_overfit`: 200 steps of the flagship slot step memorising 12
  fixed clips (`python -m devias_tpu_torch.scripts.full_scale_overfit`);
- `health_run`: 2000 steps of the published recipe's stochastic
  configuration, then the slot-disentanglement probe
  (`python -m devias_tpu_torch.scripts.health_run`);
- `profile_step`: a `torch.profiler` trace of the flagship step, its
  device time by kernel family, top kernels and tail
  (`python -m devias_tpu_torch.scripts.profile_step`).

Each runs on the card unless `--device cpu` is given.
"""
