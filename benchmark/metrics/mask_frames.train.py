"""Frames the mask model masked per profiled train step (the program's `mask_frames` counter, which a replay of the step's CUDA graph adds again); None where the program keeps no such counter."""

from harness.spans import counter_per_unit


def read(run):
    return counter_per_unit(run, "train", "mask_frames")
