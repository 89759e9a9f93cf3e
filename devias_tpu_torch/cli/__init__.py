"""Command-line entry points of the port (`python -m devias_tpu_torch.cli.<name>`)."""
