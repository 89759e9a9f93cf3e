"""Host ms of the program's `eval.forward` spans without the `h2d.stage` spans inside them (both forwards of a batch), per profiled batch."""

from harness.spans import span_ms


def read(run):
    forward = span_ms(run, "eval", "eval.forward", "total_ns")
    return None if forward is None else forward - (span_ms(run, "eval", "h2d.stage") or 0.0)
