"""One step of a chain captured once as a CUDA graph and replayed.

Two callers: the bootstrap refits (``lrt.batched_max_loglike``, one graph a
run, its draws made inside the step from a registered generator) and the
observed sampler (``gpmodelling.derive_posteriors``, one graph a call, its
draws made up front for each segment and read at a step index that lives on
the card).

A stretch-move step on a card is some 150 small operations and two
likelihood launches; launched one by one from Python, the host takes longer to
prepare them than the card takes to run them, and the card waits.  A
``StepGraph`` records the step's device work once and replays it with one
launch.  What the step computes must then live in tensors that outlive the
capture and that it updates in place (a chain's state, its log-probabilities,
the running best): a replay reads and writes the same memory as the capture,
and runs no Python.

The refits' random numbers come from a ``torch.Generator`` registered with the
graph (``CUDAGraph.register_generator_state``): each replay draws at the
generator's offset of that moment and advances it by the step's draws, as the
eager step does, so the replays give the eager chain's numbers bit for bit.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

__all__ = ["StepGraph"]


class StepGraph:
    """``step()`` captured on ``device`` (a CUDA device).

    ``step``: a function of no arguments whose device work reads and writes
    only tensors that outlive the capture, draws only from ``generator``,
    and neither synchronises nor copies from the host (a capture refuses
    both); run it eagerly once first, so that the capture finds every lazy
    initialisation done.  Capturing does not run the step: the tensors and
    the generator stay as they were.  ``replay()`` runs it and returns what
    the capture returned (tensors in the graph's own memory, rewritten by
    each replay)."""

    def __init__(self, step: Callable, device, generator: Optional[torch.Generator] = None):
        device = torch.device(device)
        self._graph = torch.cuda.CUDAGraph()
        if generator is not None:
            self._graph.register_generator_state(generator)
        current = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device)  # a capture cannot run on the default stream
        side.wait_stream(current)
        with torch.cuda.stream(side):
            self._graph.capture_begin(capture_error_mode="thread_local")
            try:
                self.out = step()
            finally:
                self._graph.capture_end()
        current.wait_stream(side)

    def replay(self):
        """Run the captured step on the current stream; its outputs."""
        self._graph.replay()
        return self.out
