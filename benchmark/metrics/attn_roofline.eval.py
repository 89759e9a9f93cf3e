"""Share of K1's roofline over an eval batch's launches, from the profiled batches."""

from harness.layers import attention_roofline


def read(run):
    return attention_roofline(run, "eval")
