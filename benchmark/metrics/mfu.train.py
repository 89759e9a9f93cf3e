"""Model operations of the train steps over the window, against the bf16 peak."""

from harness.layers import mfu


def read(run):
    return mfu(run, "train")
