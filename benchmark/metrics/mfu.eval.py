"""Model operations of the eval batches over the window, against the bf16 peak."""

from harness.layers import mfu


def read(run):
    return mfu(run, "eval")
