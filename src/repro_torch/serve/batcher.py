"""Micro-batcher: coalesce queued classification requests into fixed-size
vertex batches (continuous-batching style, at vertex granularity).

A request of k vertices is decomposed into k :class:`WorkItem`s; a
:class:`MicroBatch` is up to ``slots`` items. Requests therefore pack densely
(two 3-vertex requests share one 8-slot batch) and a request larger than one
batch is transparently split — the engine reassembles per-request results
from ``(req_id, pos)``.

Two flush policies, both deterministic given the caller-supplied clock:

* **full**     — a batch is emitted the moment ``slots`` items are queued.
* **deadline** — a partial batch is emitted once the *oldest* queued item has
                 waited ``max_delay`` seconds (bounded p99 under low load).

The batcher never reads a wall clock itself: every mutating call takes
``now``. The engine passes real time in live mode and a virtual clock in
replay mode, which is what makes single-threaded replay bit-deterministic.
The LLM path's :class:`RequestQueue` holds whole prompts instead. A copy of
``repro/serve/batcher.py``.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple


class WorkItem(NamedTuple):
    """One requested vertex: position ``pos`` of request ``req_id``."""

    req_id: int
    pos: int
    vertex: int
    t_enqueue: float


class MicroBatch(NamedTuple):
    items: Tuple[WorkItem, ...]

    @property
    def vertices(self) -> List[int]:
        return [it.vertex for it in self.items]


class MicroBatcher:
    """FIFO vertex queue with full/deadline flush.

    ``slots``     — requested-vertex capacity of one micro-batch.
    ``max_delay`` — seconds the oldest item may wait before a partial flush.
    """

    def __init__(self, slots: int, max_delay: float = 0.002):
        assert slots >= 1
        self.slots = slots
        self.max_delay = max_delay
        self._queue: List[WorkItem] = []
        self.batches_emitted = 0
        self.items_enqueued = 0

    def __len__(self) -> int:
        return len(self._queue)

    @property
    def pending(self) -> int:
        return len(self._queue)

    def add(self, req_id: int, vertices: Sequence[int], now: float,
            positions: Optional[Sequence[int]] = None) -> List[MicroBatch]:
        """Enqueue one request; return any batches that became full.

        ``positions`` overrides the per-item result positions (used when a
        prefix of the request was already served from cache)."""
        if positions is None:
            positions = range(len(vertices))
        for pos, v in zip(positions, vertices):
            self._queue.append(WorkItem(req_id, pos, int(v), now))
        self.items_enqueued += len(vertices)
        out = []
        while len(self._queue) >= self.slots:
            out.append(self._pop_batch(self.slots))
        return out

    def next_deadline(self) -> Optional[float]:
        """Absolute time at which the head of the queue must flush."""
        if not self._queue:
            return None
        return self._queue[0].t_enqueue + self.max_delay

    def flush_due(self, now: float) -> List[MicroBatch]:
        """Emit a partial batch iff the oldest item's deadline has passed."""
        out = []
        while self._queue and now >= self._queue[0].t_enqueue + self.max_delay:
            out.append(self._pop_batch(min(self.slots, len(self._queue))))
        return out

    def flush_all(self) -> List[MicroBatch]:
        """Drain the queue unconditionally (shutdown / synchronous predict)."""
        out = []
        while self._queue:
            out.append(self._pop_batch(min(self.slots, len(self._queue))))
        return out

    def cancel(self, req_id: int) -> int:
        """Drop every queued item of a shed request; returns items removed."""
        n = len(self._queue)
        self._queue = [it for it in self._queue if it.req_id != req_id]
        return n - len(self._queue)

    def _pop_batch(self, k: int) -> MicroBatch:
        items, self._queue = self._queue[:k], self._queue[k:]
        self.batches_emitted += 1
        return MicroBatch(items=tuple(items))



class RequestQueue:
    """FIFO queue at whole-request granularity.

    The LLM backend's unit of admission is a prompt — one request claims one
    KV cache slot end-to-end and is never split across batches, so its queue
    holds requests, not per-item work. Same contract as :class:`MicroBatcher`
    otherwise: no wall clock, deterministic under a caller-supplied stream.
    """

    def __init__(self):
        self._queue: List[Tuple[int, object]] = []   # (req_id, payload)
        self.items_enqueued = 0
        self.wait_high_water = 0

    def __len__(self) -> int:
        return len(self._queue)

    @property
    def pending(self) -> int:
        return len(self._queue)

    def add(self, req_id: int, payload: object) -> None:
        self._queue.append((req_id, payload))
        self.items_enqueued += 1
        self.wait_high_water = max(self.wait_high_water, len(self._queue))

    def pop(self) -> Tuple[int, object]:
        """Dequeue the oldest waiting request (FIFO)."""
        return self._queue.pop(0)

    def cancel(self, req_id: int) -> int:
        """Drop a shed request still waiting for a slot."""
        n = len(self._queue)
        self._queue = [(r, p) for r, p in self._queue if r != req_id]
        return n - len(self._queue)
