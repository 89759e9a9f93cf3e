"""Host ms of the program's `train.step` span (the whole step call), per profiled step."""

from harness.spans import span_ms


def read(run):
    return span_ms(run, "train", "train.step", "total_ns")
