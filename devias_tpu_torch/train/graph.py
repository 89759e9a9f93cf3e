"""A train step captured as one CUDA graph and replayed
(`train/step.py::_run_step`).

Every launch of the slot and HVU steps reads its values on the card: the
optimizer's schedule table and counter (`train/optim.py`), FAME's
constants (`aug/fame.py`), the draws and the generators. So the whole
step (zero_grad, the micro-batches' forward and backward, the optimizer,
the EMA) can be captured once and replayed: one graph launch where the
host enqueued some 10^4 launches through autograd. `StepGraph` does that
for one step function:

* It engages where the call shows that capture is safe (`graph_safe`): a
  CUDA device, no process layout and no placed state, the port's
  optimizer, a CUDA generator, inputs and draws on the card; it captures
  only while no profiler records.
* The first such call captures and leaves no trace of its own: the
  micro-batches' forward and backward run once on a side stream, so that
  lazy initialisations happen outside the capture; their gradients are
  dropped, the generator's state is put back and the cache emptied of
  their blocks; then the whole step is captured on static copies of the
  inputs and draws with the generator registered, which runs nothing, and
  its first replay is the call's result.
* A later call with the captured signature (the inputs' and draws' shapes,
  dtypes and devices, the draws' structure and non-tensor values, the
  generator and state objects, update_freq) copies its inputs into the
  static ones on the stream and replays. Any other call runs eager. A
  changed optimizer `version` (a loaded state, a grown schedule table)
  drops the graph, and the next call captures again. A capture that fails
  (an operation that waits for the host) leaves the step eager for good.
* Replays run at most `RUN_AHEAD` steps ahead of the card: before replay n
  the host waits for the event recorded after replay n - 2 (span
  `train.graph_wait`).
* After each replay the host does what the step did on the host: the
  optimizer's and the state's counts go up by one, K1's launch counts gain
  the captured launches (`kernels/attention.py::add_launches`) and the
  counter `train_graph_replays` one. The metrics returned are copies,
  which the next replay does not overwrite.
"""

from __future__ import annotations

import collections
import warnings
from typing import Callable, Dict, Optional

import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

from devias_tpu_torch.kernels import attention
from devias_tpu_torch.train.optim import ScheduledOptimizer
from devias_tpu_torch.utils.profiling import count, recording, span

# replays in flight at most
RUN_AHEAD = 2


def graph_safe(device: torch.device, mesh, placement) -> bool:
    """Whether a step on `device` under `mesh` with a state placed as
    `placement` may be captured: a CUDA device, no layout (collectives and
    host-split generators) and no placed state."""
    return device.type == "cuda" and mesh is None and placement is None


def _meta(x):
    """What a tensor contributes to a signature (shape, dtype, device), or
    the value of anything else, which a capture bakes in."""
    if isinstance(x, torch.Tensor):
        return (tuple(x.shape), x.dtype, x.device)
    return ("value", x)


class StepGraph:
    """The captured step of one step function (module docstring)."""

    def __init__(self):
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.failed = False
        self.replays = 0
        self.inflight = collections.deque()
        self.launches = ({}, {})

    def run(self, state, optimizer, inputs: Dict[str, torch.Tensor], draws, generator: torch.Generator, U: int,
            forward_backward: Callable, body: Callable):
        """The step's outputs from a replay, capturing first where there is
        no graph; None where the call must run eager. `body(inputs, draws,
        generator)` is the whole step and returns (metrics, grad_norm);
        `forward_backward(inputs, draws, generator)` its micro-batches'
        forward and backward alone."""
        if self.failed or not isinstance(optimizer, ScheduledOptimizer):
            return None
        optimizer.extend_schedule()
        if self.graph is not None and self.version != optimizer.version:
            self.release()
        leaves, spec = tree_flatten(draws)
        device = next(iter(inputs.values())).device
        tensors = list(inputs.values()) + [t for t in leaves if isinstance(t, torch.Tensor)]
        if generator.device.type != "cuda" or any(t.device != device for t in tensors):
            return None
        signature = (spec, U, tuple((k, _meta(v)) for k, v in inputs.items()), tuple(_meta(x) for x in leaves))
        if self.graph is None:
            if recording() or not self._capture(state, optimizer, inputs, leaves, spec, generator, forward_backward,
                                                body, signature):
                return None
        elif signature != self.signature or generator is not self.generator or state is not self.state:
            return None
        else:
            for k, v in inputs.items():
                self.static_inputs[k].copy_(v)
            for s, x in zip(self.static_leaves, leaves):
                if isinstance(x, torch.Tensor):
                    s.copy_(x)
        self.replay()
        optimizer.count += 1
        state.step += 1
        metrics, grad_norm = self.outputs
        return {k: v.clone() for k, v in metrics.items()}, grad_norm.clone()

    def _capture(self, state, optimizer, inputs, leaves, spec, generator, forward_backward, body,
                 signature) -> bool:
        device = next(iter(inputs.values())).device
        static_inputs = {k: v.clone() for k, v in inputs.items()}
        static_leaves = [x.clone() if isinstance(x, torch.Tensor) else x for x in leaves]
        draws = tree_unflatten(static_leaves, spec)
        gen_state = generator.get_state()
        host = (optimizer.count, state.step)
        counts = (attention.launch_counts(), attention.launch_counts_by_heads())
        stream = torch.cuda.Stream(device)
        graph = torch.cuda.CUDAGraph()
        try:
            stream.wait_stream(torch.cuda.current_stream(device))
            with torch.cuda.stream(stream):
                forward_backward(static_inputs, draws, generator)
            optimizer.zero_grad(set_to_none=True)
            generator.set_state(gen_state)
            attention.set_launch_counts(*counts)
            torch.cuda.synchronize(device)
            torch.cuda.empty_cache()
            graph.register_generator_state(generator)
            with torch.cuda.stream(stream):
                graph.capture_begin(capture_error_mode="thread_local")
                try:
                    outputs = body(static_inputs, draws, generator)
                finally:
                    graph.capture_end()
            launches = attention.launches_since(*counts)
        except Exception as err:  # an operation a capture cannot hold: run eager
            warnings.warn(f"the train step runs eager: its capture as a CUDA graph failed ({err})")
            self.failed = True
            del graph
            torch.cuda.empty_cache()
            return False
        finally:
            optimizer.zero_grad(set_to_none=True)
            optimizer.count, state.step = host
            generator.set_state(gen_state)
            attention.set_launch_counts(*counts)
        torch.cuda.current_stream(device).wait_stream(stream)
        self.graph, self.outputs, self.launches = graph, outputs, launches
        self.static_inputs, self.static_leaves = static_inputs, static_leaves
        self.signature, self.generator, self.state, self.version = signature, generator, state, optimizer.version
        return True

    def _recorded_event(self):
        event = torch.cuda.Event()
        event.record()
        return event

    def replay(self) -> None:
        """One replay, after the one RUN_AHEAD back has finished, and its
        accounting."""
        if len(self.inflight) >= RUN_AHEAD:
            with span("train.graph_wait"):
                self.inflight.popleft().synchronize()
        self.graph.replay()
        self.inflight.append(self._recorded_event())
        attention.add_launches(*self.launches)
        count("train_graph_replays", 1)
        self.replays += 1

    def release(self) -> None:
        """Drop the graph and its memory; the next call captures again."""
        if self.graph is None:
            return
        torch.cuda.synchronize()
        self.graph.reset()
        self.graph = self.outputs = self.static_inputs = self.static_leaves = None
        self.generator = self.state = None
        self.inflight.clear()
        torch.cuda.empty_cache()
