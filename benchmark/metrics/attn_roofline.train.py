"""Share of K1's roofline over a train step's launches, from the profiled steps."""

from harness.layers import attention_roofline


def read(run):
    return attention_roofline(run, "train")
