"""Host self ms of the program's `train.loss` span (the slot loss with its matching), per profiled step."""

from harness.spans import span_ms


def read(run):
    return span_ms(run, "train", "train.loss")
