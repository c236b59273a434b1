"""Threaded continuous-batching driver: concurrent submitters, one engine.

Counterpart of ``repro/serve/driver.py``, with its semantics. A
:class:`~repro_torch.serve.core.ServingCore` engine (the GNN
``InferenceEngine``, the ``LLMEngine``, any backend behind the
``serve/protocol.py`` seam) is single-threaded and event-driven: nothing
happens outside ``submit`` / ``pump`` / ``drain``. Under concurrent load
that leaves two gaps: nobody calls ``pump`` while every client thread
waits for its own result, so deadline flushes never fire; and with
``mesh_dp`` stacking, a partly filled device group can sit staged. The
driver closes both:

* all engine access is serialized under one lock: any number of threads
  may ``submit`` and get a ``concurrent.futures.Future`` back. Only the
  pump thread, or a caller holding the lock, touches the engine, so over a
  mesh rank 0's collectives are issued by one thread at a time;
* a background pump thread drives the deadline flushes;
* **starvation-aware flush**: if the oldest incomplete request has waited
  longer than ``starvation_ms``, the driver drains the engine, bounding
  the worst-case latency below a long batcher deadline (which exists to
  fill batches, not to park requests).

When the backend reports ``busy()`` (active LLM decode slots), the pump
loop skips its sleep (every pump retires one token per active sequence)
and the starvation drain is suppressed: a decoding request is mid-
generation, not starving. ``max_inflight`` sheds submits beyond that many
requests in flight with :class:`Overloaded`.

Results are routed back through futures, so submitter threads never
poll::

    with ServingDriver(engine) as drv:
        fut = drv.submit([17, 42])          # from any thread
        logits = fut.result(timeout=5)
"""
from __future__ import annotations

import threading
import time
from concurrent.futures import Future
from typing import Dict, Optional, Tuple

from repro_torch.serve.core import ServingCore
from repro_torch.serve.protocol import Overloaded

__all__ = ["Overloaded", "ServingDriver"]


class ServingDriver:
    """Thread-safe front of one engine with its own pump loop.

    ``auto=False`` skips the background thread: every flush then happens
    through explicit ``pump()`` / ``drain()`` calls, which deterministic
    tests use to control the interleaving exactly.
    """

    def __init__(self, engine: ServingCore, *,
                 starvation_ms: float = 25.0, poll_ms: float = 1.0,
                 auto: bool = True, max_inflight: int = 0):
        if engine.replay:
            raise ValueError("the driver uses real time; a replay engine "
                             "is driven directly")
        self._eng = engine
        self._starvation = starvation_ms / 1e3
        self._poll = poll_ms / 1e3
        self._max_inflight = max_inflight   # 0 = unbounded (no shedding)
        self._lock = threading.Lock()
        self._futures: Dict[int, Tuple[Future, float]] = {}
        self._stop = threading.Event()
        self._wake = threading.Event()
        self.starvation_flushes = 0
        self.shed = 0                 # requests refused at the admission gate
        self.inflight_high_water = 0
        self.last_error: Optional[BaseException] = None
        self._thread: Optional[threading.Thread] = None
        if auto:
            self._thread = threading.Thread(target=self._loop, daemon=True,
                                            name="serve-driver-pump")
            self._thread.start()

    # -- client API (any thread) --------------------------------------------

    def submit(self, payload, *,
               deadline_ms: Optional[float] = None) -> Future:
        """Enqueue one request; the Future resolves to the engine's output
        (logits rows for the GNN, generated token ids for the LLM).

        ``deadline_ms`` arms per-request shedding: if still incomplete that
        long after submit, the engine fails it with :class:`Overloaded`
        (delivered through the Future)."""
        fut: Future = Future()
        with self._lock:
            if self._stop.is_set():
                raise RuntimeError("submit() after close(): nothing would "
                                   "ever flush this request")
            if (self._max_inflight
                    and len(self._futures) >= self._max_inflight):
                # admission control keeps the admitted requests' tail
                # latency bounded instead of queueing without bound
                self.shed += 1
                raise Overloaded(
                    f"{len(self._futures)} requests in flight "
                    f"(max_inflight={self._max_inflight})")
            rid = self._eng.submit(payload, deadline_ms=deadline_ms)
            self._futures[rid] = (fut, time.monotonic())
            self.inflight_high_water = max(self.inflight_high_water,
                                           len(self._futures))
            self._collect_locked()          # submit may complete inline
        self._wake.set()
        return fut

    def pump(self) -> None:
        """One manual service turn (deadline and starvation check)."""
        with self._lock:
            self._service_locked(time.monotonic())

    def drain(self) -> None:
        """Flush everything queued and resolve every completed future.

        An engine failure mid-drain is routed to every in-flight future
        before it propagates to the caller: otherwise their waiters would
        hang on futures nobody will resolve."""
        with self._lock:
            try:
                self._eng.drain()
            except Exception as exc:
                self.last_error = exc
                self._fail_all_locked(exc)
                raise
            self._collect_locked()

    def close(self) -> None:
        """Drain outstanding work and stop the pump thread. Never raises: a
        failure of the final drain resolves every in-flight future with
        the exception (through ``drain``) and is kept in ``last_error``;
        ``close()`` runs in ``__exit__`` and clean-up paths, where raising
        would mask the original error and strand ``fut.result()``
        waiters."""
        self._stop.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        try:
            self.drain()
        except Exception:
            pass          # routed to the futures and last_error by drain()

    def __enter__(self) -> "ServingDriver":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def stats(self) -> dict:
        with self._lock:
            out = self._eng.stats()
            out["inflight"] = len(self._futures)
            out["inflight_high_water"] = self.inflight_high_water
            out["starvation_flushes"] = self.starvation_flushes
            out["shed"] = self.shed
        return out

    # -- internals ----------------------------------------------------------

    def _collect_locked(self) -> None:
        for rid, result in self._eng.take_completed().items():
            entry = self._futures.pop(rid, None)
            if entry is not None:
                entry[0].set_result(result)
        for rid, exc in self._eng.take_failed().items():
            entry = self._futures.pop(rid, None)
            if entry is not None:
                entry[0].set_exception(exc)

    def _service_locked(self, now: float) -> None:
        self._eng.pump()
        self._collect_locked()       # deadline completions are not starving
        if self._futures and not self._eng.busy():
            oldest = min(t for _, t in self._futures.values())
            if now - oldest >= self._starvation:
                # bound the tail latency: a sparse period must not park
                # requests behind the batch-fill deadline
                self._eng.drain()
                self.starvation_flushes += 1
                self._collect_locked()

    def _fail_all_locked(self, exc: BaseException) -> None:
        futures, self._futures = self._futures, {}
        for fut, _ in futures.values():
            if not fut.done():
                fut.set_exception(exc)

    def _loop(self) -> None:
        while not self._stop.is_set():
            # a busy backend (active decode slots) makes back-to-back pumps
            # productive: no poll interval between tokens
            if not self._eng.busy():
                self._wake.wait(self._poll)
                self._wake.clear()
            try:
                with self._lock:
                    self._service_locked(time.monotonic())
            except Exception as exc:
                # a silently dead pump thread would hang every in-flight
                # future: fail them with the error and keep serving later
                # traffic
                self.last_error = exc
                with self._lock:
                    self._fail_all_locked(exc)
