"""CUDA graphs of the port: how one is captured, and how an engine holds
its graphs across threads and CUDA streams.

Two paths replay graphs over buffers of their own: the anchor's Adam
iteration (``drag/engine._AnchorGraph``, a graph a lane count) and the
pipeline block's bookkeeping (``drag/pipeline._BlockGraph``, the last
call's).  Both follow the rules here:

* :func:`capture`: one eager run of each function on a stream of its own
  that waits on the caller's (results thrown away), then the captures on
  that stream, in the mode that lets other threads use the card meanwhile;
* :class:`Holder`: one thread holds an engine's graphs at a time (the
  daemon's jobs share engines and run on streams of their own); the
  caller's stream first waits for the last holder's work on the buffers,
  and a graph made anew first waits for that work on the host and drops
  the old graph, since its buffers go back to the allocator before the new
  ones are made.

The batched beam (``drag/hypotheses``) holds its chunk buffers, which the
block graph reads, the same way; on the CPU a holder is its lock alone.
"""

from __future__ import annotations

import contextlib
import threading

import torch


def capture(device, *fns) -> list:
    """Each of ``fns`` as a CUDA graph on ``device``, in order: all of them
    run once eagerly, in order, on a side stream that waits on the current
    one, then each is captured on that stream."""
    current = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(current)
    with torch.cuda.stream(side):
        for fn in fns:
            fn()
    current.wait_stream(side)
    graphs = []
    for fn in fns:
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side,
                              capture_error_mode="thread_local"):
            fn()
        graphs.append(graph)
    return graphs


class Holder:
    """An engine's graphs, one a slot, held by one thread and stream at a
    time."""

    def __init__(self):
        self.slots = {}
        self.lock = threading.Lock()
        # recorded on the holder's stream after its last use of the buffers
        self.released = None

    @contextlib.contextmanager
    def hold(self, device, slot, matches, make):
        """The graph in ``slot`` for the ``with`` body, on ``device``: kept
        while ``matches(graph)`` holds, else (or where there is none) the
        old one dropped and ``make()``'s taken."""
        if torch.device(device).type != "cuda":
            with self.lock:
                if slot not in self.slots or not matches(self.slots[slot]):
                    self.slots.pop(slot, None)
                    self.slots[slot] = make()
                yield self.slots[slot]
            return
        with self.lock, torch.cuda.device(device):
            if self.released is None:
                self.released = torch.cuda.Event()
            stream = torch.cuda.current_stream(device)
            stream.wait_event(self.released)
            if slot not in self.slots or not matches(self.slots[slot]):
                self.released.synchronize()
                self.slots.pop(slot, None)
                self.slots[slot] = make()
            try:
                yield self.slots[slot]
            finally:
                self.released.record(stream)
