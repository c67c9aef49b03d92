"""The virtual clock of the serving loops (a copy of the reference's
``SimClock``; the span tracer itself is not ported yet)."""
from __future__ import annotations


class SimClock:
    """Monotone virtual-time clock shared by loop and batcher."""

    __slots__ = ("t",)

    def __init__(self, t: float = 0.0):
        self.t = t

    def advance(self, t: float) -> None:
        if t > self.t:
            self.t = t
