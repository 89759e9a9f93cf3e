"""Host self ms of the program's `train.graph_wait` span (the wait for the replay two back before a replay of the train step's CUDA graph), per step in the steady state: the steps after the run-ahead has filled, as in the window (`TrainEntry.steady_spans`). It is the card's step less the host's, so a slower host lowers it too. None where no graph replayed."""

from harness.spans import span_ms


def read(run):
    return span_ms(run, "train", "train.graph_wait", steady=True)
