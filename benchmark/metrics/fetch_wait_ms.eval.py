"""Host ms of the program's `eval.fetch` span (the wait for the card's results and their numpy conversion), per profiled batch."""

from harness.spans import span_ms


def read(run):
    return span_ms(run, "eval", "eval.fetch")
