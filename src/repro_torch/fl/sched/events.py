"""Deterministic virtual-time event queue, port of
``repro.fl.sched.events``.

The simulated clock only advances by popping the earliest pending event;
ties break by a monotonic push sequence number, so pop order is
bit-reproducible.
"""
from __future__ import annotations

import heapq
from typing import List, Tuple


class EventQueue:
    """Min-heap of (time, seq, cid, tag) events with a monotonic virtual
    clock ``now``; ``tag`` is an opaque small integer carried along."""

    def __init__(self):
        self._heap: List[Tuple[float, int, int, int]] = []
        self._seq = 0
        self.now = 0.0

    def __len__(self) -> int:
        return len(self._heap)

    def push(self, time: float, cid: int, tag: int = 0) -> None:
        if time < self.now:
            raise ValueError(
                f"event at t={time} is in the past (now={self.now})")
        heapq.heappush(self._heap,
                       (float(time), self._seq, int(cid), int(tag)))
        self._seq += 1

    def pop(self) -> Tuple[float, int, int]:
        """Pop the earliest (time, cid, tag) and advance the clock."""
        t, _, cid, tag = heapq.heappop(self._heap)
        self.now = max(self.now, t)
        return t, cid, tag

    def peek(self) -> Tuple[float, int, int]:
        """The earliest pending (time, cid, tag) without popping it."""
        t, _, cid, tag = self._heap[0]
        return t, cid, tag
