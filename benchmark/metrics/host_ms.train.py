"""Host ms for a train step call to return (its enqueue), mean over the window."""

from harness.layers import host_ms


def read(run):
    return host_ms(run, "train")
