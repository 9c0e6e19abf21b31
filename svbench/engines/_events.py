"""A ring of reusable CUDA events that mark each batch's end on the
card's stream: one event record a batch, and no event created or
destroyed inside the window. The harness keeps at most two batches in
flight, so an event is waited on before the ring comes back to it."""

from __future__ import annotations

RING = 4


class Ring:
    def __init__(self, device):
        self.events = []
        if device.type == "cuda":
            import torch
            self.events = [torch.cuda.Event() for _ in range(RING)]
        self.n = 0

    def record(self):
        """The next event, recorded on the current stream, or None on
        the host."""
        if not self.events:
            return None
        ev = self.events[self.n % RING]
        self.n += 1
        ev.record()
        return ev
