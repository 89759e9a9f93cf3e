"""Host ms of the program's `h2d.stage` span (pinning each host batch and enqueueing its copy), per profiled batch; 0 where the forwards staged nothing (no card)."""

from harness.spans import span_ms


def read(run):
    if span_ms(run, "eval", "eval.forward") is None:
        return None
    return span_ms(run, "eval", "h2d.stage") or 0.0
