"""Host self ms of the program's `train.fame` span (FAME or FAME-HVU), per profiled step."""

from harness.spans import span_ms


def read(run):
    return span_ms(run, "train", "train.fame")
