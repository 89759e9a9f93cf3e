"""Host self ms of the program's `train.teacher` span (the frozen teacher's forward), per profiled step."""

from harness.spans import span_ms


def read(run):
    return span_ms(run, "train", "train.teacher")
