"""Host self ms of the program's `train.optimizer` span (FusedAdamW, zero_grad, the EMA and the step count), per profiled step."""

from harness.spans import span_ms


def read(run):
    return span_ms(run, "train", "train.optimizer")
