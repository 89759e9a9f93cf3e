"""Device idle share of the profiled eval batches (reads high: the profiler adds host time)."""

from harness.layers import idle_share


def read(run):
    return idle_share(run, "eval")
