"""Replays of the program's train step captured as a CUDA graph (its `train_graph_replays` counter), per profiled step; None where the program keeps no such counter."""

from harness.spans import counter_per_unit


def read(run):
    return counter_per_unit(run, "train", "train_graph_replays")
