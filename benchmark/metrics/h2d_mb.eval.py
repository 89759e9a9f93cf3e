"""MB of host arrays the program sends to the card (its `h2d_bytes` counter), per profiled batch; 0 where the forwards sent nothing (no card)."""

from harness.spans import counter_per_unit, span_ms


def read(run):
    if span_ms(run, "eval", "eval.forward") is None:
        return None
    return (counter_per_unit(run, "eval", "h2d_bytes") or 0.0) / 1e6
