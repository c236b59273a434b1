"""The model-agnostic serving protocol: what a backend must provide for the
generic scheduling core (``serve/core.py``) to serve it.

One core, many models. The core owns everything model-independent — request
table, clock (live/replay), latency histogram, deadline shedding, the
``submit``/``pump``/``poll``/``drain``/``take_completed`` lifecycle. A
backend owns everything model-specific — how requests turn into batches
(``admit``/``plan``), what ONE device call looks like (``execute``), and the
model's own counters (``stats``). A copy of ``repro/serve/protocol.py``.
The port has two backends, each on one device:

* the GNN classifier (``serve/engine.py``): vertex-granular
  micro-batching, Alg.-2 neighborhood assembly, int8 embedding cache;
* the autoregressive LLM (``serve/llm_engine.py``): KV-cache slot
  scheduling, continuous batching, one decode step per pump.

The threaded driver of the JAX package is still to be ported.

A "batch" is opaque to the core — it is whatever ``plan``/``admit`` emitted
and only ``execute`` interprets it (a dp group of micro-batches for the GNN;
a prefill or a packed decode step for the LLM). ``execute`` returns
:class:`Completion` records; the core routes them into per-request output
buffers and finishes requests as they fill. A decode step naturally emits
one completion per active slot — multiple requests progress per pump.
"""
from __future__ import annotations

from typing import Any, List, NamedTuple, Optional, Protocol, Sequence

import numpy as np


class Overloaded(RuntimeError):
    """Request shed by admission control: the in-flight cap at submit, or
    the per-request deadline while queued (``stats()["shed_deadline"]``)."""


class Completion(NamedTuple):
    """One unit of result produced by ``execute``.

    ``pos`` indexes the request's output buffer (a vertex's row for the GNN,
    a token index for the LLM); ``final=True`` completes the request even if
    the buffer is not full (early EOS) — the core truncates the output to
    the filled prefix."""

    rid: int
    pos: int
    value: Any
    final: bool = False


class PendingRequest:
    """Core-owned per-request record. Backends may fill ``out`` directly at
    admit time (cache hits) and decrement ``remaining`` accordingly."""

    __slots__ = ("rid", "payload", "out", "remaining", "t_submit", "deadline")

    def __init__(self, rid: int, payload: Any, out: np.ndarray,
                 t_submit: float, deadline: Optional[float]):
        self.rid = rid
        self.payload = payload
        self.out = out
        self.remaining = len(out)
        self.t_submit = t_submit
        self.deadline = deadline        # seconds after t_submit, or None


class EngineBackend(Protocol):
    """What ``ServingCore`` schedules. All methods are called single-threaded
    (the driver serializes under one lock); ``now`` is the core's clock —
    monotonic seconds live, the virtual clock in replay mode."""

    # scheduling-unit capacity of one device call: micro-batch slots for the
    # GNN, KV cache slots for the LLM
    def capacity(self) -> int: ...

    # device calls issued so far (the backend counts — only it knows whether
    # a batch needed the device at all)
    device_calls: int

    def validate(self, payload: Any) -> None:
        """Reject a malformed payload BEFORE any state changes."""
        ...

    def new_request(self, payload: Any) -> np.ndarray:
        """Allocate the request's output buffer; its length is the number of
        completions that fully serve the request."""
        ...

    def admit(self, req: PendingRequest, now: float) -> List[Any]:
        """Enqueue one request; return any batches ready to execute NOW
        (full micro-batches, free-slot prefills). May complete (part of) the
        request inline by writing ``req.out`` and decrementing
        ``req.remaining`` — cache hits never reach the device."""
        ...

    def plan(self, now: float, force: bool) -> List[Any]:
        """Batches due at ``now`` (deadline flushes, one decode step).
        ``force=True`` = drain semantics: emit everything runnable,
        deadlines ignored. The core calls this repeatedly while draining —
        return [] when no work remains."""
        ...

    def execute(self, batch: Any, now: float) -> List[Completion]:
        """Run one batch — at most ONE device call — and return what it
        completed."""
        ...

    def cancel(self, rid: int) -> None:
        """Forget a shed request (drop queued work, free its slot). Late
        completions for an unknown rid are dropped by the core, so this is
        an efficiency hook, not a correctness requirement."""
        ...

    def busy(self) -> bool:
        """True when the backend makes progress from back-to-back pumps
        (e.g. active decode slots). The driver pumps hot instead of sleeping
        and suppresses starvation drains while this holds."""
        ...

    def stats(self) -> dict:
        """Backend-specific counters, merged into the core's stats()."""
        ...

    def reset_stats(self) -> None: ...

    def update_params(self, params: Any) -> None: ...

    def invalidate(self) -> None: ...


__all__ = ["Completion", "EngineBackend", "Overloaded", "PendingRequest",
           "Sequence"]
