"""Host ms per batch inside the two forward functions final_test is handed, over the window."""

from harness.layers import host_ms


def read(run):
    return host_ms(run, "eval")
