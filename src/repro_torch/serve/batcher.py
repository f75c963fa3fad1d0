"""Continuous-batching request queue (a copy of ``repro.serve.batcher``,
which imports no JAX: the port keeps its own).

The engine owns a fixed grid of ``max_slots`` batch slots (one decode cache
row each).  Requests queue FIFO; every tick the engine

  1. evicts finished requests (freeing their slots),
  2. admits queued requests into free slots (one bucketed prefill each),
  3. runs ONE decode step for all active slots at their own positions.

The batcher is pure bookkeeping — no torch — so its invariants (a request is
admitted exactly once, occupancy never exceeds ``max_slots``, eviction
frees exactly the finished slots, FIFO admission order) are testable
without compiling anything.
"""
from __future__ import annotations

import collections
import dataclasses
import itertools
from typing import Any, Optional


@dataclasses.dataclass
class Request:
    """One generation request and its runtime state."""

    rid: int
    prompt: tuple[int, ...]
    max_new_tokens: int
    temperature: float = 0.0
    frames: Any = None                 # audio family: (S_enc, d_model) frames
    stop_tokens: frozenset = frozenset()

    # runtime state, owned by the batcher/engine
    generated: list = dataclasses.field(default_factory=list)
    pending: list = dataclasses.field(default_factory=list)
    # ^ prompt tokens not yet consumed — chunked prefill for exact-length
    #   families feeds these through the shared decode step
    slot: int = -1
    position: int = -1                 # next cache index this request writes
    status: str = "queued"             # queued | active | done
    stopped: bool = False              # hit a stop token

    @property
    def prompt_len(self) -> int:
        return len(self.prompt)

    @property
    def done(self) -> bool:
        return self.stopped or len(self.generated) >= self.max_new_tokens


class Batcher:
    """Slot allocator + FIFO queue for continuous batching."""

    def __init__(self, max_slots: int):
        if max_slots < 1:
            raise ValueError("max_slots must be >= 1")
        self.max_slots = max_slots
        self.slots: list[Optional[Request]] = [None] * max_slots
        self.queue: collections.deque[Request] = collections.deque()
        self._rids = itertools.count()

    def submit(self, req: Request) -> int:
        req.rid = next(self._rids)
        req.status = "queued"
        self.queue.append(req)
        return req.rid

    def evict(self) -> list[Request]:
        """Free the slots of finished requests; returns them."""
        out = []
        for i, r in enumerate(self.slots):
            if r is not None and r.done:
                r.status = "done"
                self.slots[i] = None
                out.append(r)
        return out

    def admit(self) -> list[tuple[int, Request]]:
        """Fill free slots from the queue (FIFO); returns (slot, request)
        pairs for the engine to prefill."""
        out = []
        for i in range(self.max_slots):
            if self.slots[i] is None and self.queue:
                r = self.queue.popleft()
                r.slot, r.status = i, "active"
                self.slots[i] = r
                out.append((i, r))
        return out

    def active(self) -> list[tuple[int, Request]]:
        """Slots that should take part in the next decode step."""
        return [(i, r) for i, r in enumerate(self.slots)
                if r is not None and not r.done]

    @property
    def has_work(self) -> bool:
        return bool(self.queue) or any(r is not None for r in self.slots)

    def occupancy(self) -> float:
        return sum(r is not None for r in self.slots) / self.max_slots
