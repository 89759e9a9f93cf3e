"""Device idle share of the profiled train steps (reads high: the profiler adds host time)."""

from harness.layers import idle_share


def read(run):
    return idle_share(run, "train")
