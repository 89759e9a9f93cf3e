"""Host self ms of the program's `train.student` span (backbone and heads, without the `nn.agg` span inside it), per profiled step."""

from harness.spans import span_ms


def read(run):
    return span_ms(run, "train", "train.student")
