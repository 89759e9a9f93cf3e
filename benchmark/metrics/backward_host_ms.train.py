"""Host self ms of the program's `train.backward` span (autograd's enqueue of the backward), per profiled step."""

from harness.spans import span_ms


def read(run):
    return span_ms(run, "train", "train.backward")
