"""Host ms of the program's `nn.agg` span (the slot rounds; in a train step only under `train.student`), per profiled step."""

from harness.spans import span_ms


def read(run):
    return span_ms(run, "train", "nn.agg")
