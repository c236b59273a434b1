"""Model-agnostic serving core: request lifecycle over any EngineBackend.

The core is the half of the old GNN ``InferenceEngine`` that never cared
about graphs: request table, live/replay clock, latency histogram,
``submit``/``pump``/``poll``/``drain``, bulk completion pickup for the
threaded driver, and per-request deadline shedding. It schedules whatever
the backend's ``admit``/``plan`` emit and routes the ``execute``
completions back into per-request buffers.

Single-threaded and event-driven by design — nothing happens outside
``submit``/``pump``/``poll``/``drain`` calls; ``ServingDriver`` adds the
lock and the pump thread. In **replay mode** the clock is virtual (advanced
only by ``advance()``/explicit ``now=``), so an identical request stream
produces bit-identical outputs."""
from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

import numpy as np

from repro_torch.obs.metrics import LatencyHistogram
from repro_torch.serve.protocol import (Completion, EngineBackend,
                                        Overloaded, PendingRequest)

# drain() alternates plan(force=True)/execute until the backend reports no
# work; a backend that cannot finish its admitted requests in this many
# rounds is wedged (every round must retire >= 1 token/batch)
_MAX_DRAIN_ROUNDS = 1_000_000


class ServingCore:
    """Generic scheduling/lifecycle engine over one :class:`EngineBackend`."""

    def __init__(self, backend: EngineBackend, *, replay: bool = False):
        self._backend = backend
        self.replay = replay
        self._requests: Dict[int, PendingRequest] = {}
        self._done: Dict[int, np.ndarray] = {}
        self._failed: Dict[int, BaseException] = {}
        self._next_id = 0
        self._vnow = 0.0                        # virtual clock (replay mode)

        self.completed = 0
        self.shed_deadline = 0
        self.latencies = LatencyHistogram()
        self._t_first: Optional[float] = None
        self._t_last: Optional[float] = None

    # -- clock ---------------------------------------------------------------

    def _now(self, now: Optional[float]) -> float:
        # caller-supplied timestamps are honored only in replay mode; in
        # live mode everything is stamped with one monotonic clock so
        # latency stats and batcher deadlines never mix time bases
        if not self.replay:
            return time.monotonic()
        if now is not None:
            self._vnow = max(self._vnow, now)
            return now
        return self._vnow

    def _wall(self, now: float) -> float:
        """Completion timestamp: the virtual clock in replay, fresh
        monotonic time live (device calls took real time since ``now``)."""
        return now if self.replay else time.monotonic()

    def advance(self, dt: float) -> float:
        """Advance the virtual clock (replay mode only)."""
        assert self.replay, "advance() is for replay mode"
        self._vnow += dt
        return self._vnow

    # -- request API ---------------------------------------------------------

    @property
    def device_calls(self) -> int:
        return self._backend.device_calls

    def busy(self) -> bool:
        return self._backend.busy()

    def submit(self, payload: Any, now: Optional[float] = None, *,
               deadline_ms: Optional[float] = None) -> int:
        """Enqueue one request; returns its request id.

        ``now`` is honored only in replay mode (virtual clock). A request
        still incomplete ``deadline_ms`` after submit is shed: failed with
        :class:`Overloaded` (picked up via ``take_failed``/the driver's
        future) and counted in ``stats()["shed_deadline"]``."""
        now = self._now(now)
        self._backend.validate(payload)
        rid = self._next_id
        self._next_id += 1
        req = PendingRequest(rid, payload, self._backend.new_request(payload),
                             now, deadline_ms / 1e3
                             if deadline_ms is not None else None)
        self._requests[rid] = req
        if self._t_first is None:
            self._t_first = self._wall(now)

        batches = self._backend.admit(req, now)
        if req.remaining == 0:
            # served entirely at admit time (cache hits)
            self._finish(rid, self._wall(now))
            return rid
        self._run(batches, now)
        return rid

    def pump(self, now: Optional[float] = None) -> None:
        """One service turn: shed expired requests, run any batches due."""
        now = self._now(now)
        self._shed_expired(now)
        self._run(self._backend.plan(now, force=False), now)

    def drain(self, now: Optional[float] = None) -> None:
        """Run everything runnable until the backend has no work left."""
        now = self._now(now)
        self._shed_expired(now)
        for _ in range(_MAX_DRAIN_ROUNDS):
            batches = self._backend.plan(now, force=True)
            if not batches:
                return
            self._run(batches, now)
        raise RuntimeError("drain() did not converge: backend keeps "
                           "emitting batches without retiring requests")

    def poll(self, rid: int,
             now: Optional[float] = None) -> Optional[np.ndarray]:
        """Deadline-pump, then return the finished output if complete."""
        self.pump(now)
        return self._done.pop(rid, None)

    def predict(self, payload: Any,
                now: Optional[float] = None) -> np.ndarray:
        """Synchronous convenience: submit + drain + poll."""
        rid = self.submit(payload, now)
        self.drain(now)
        return self._done.pop(rid)

    def take_completed(self) -> Dict[int, np.ndarray]:
        """Pop every finished request at once: {rid: output}. The threaded
        driver's bulk alternative to per-rid ``poll``."""
        done, self._done = self._done, {}
        return done

    def take_failed(self) -> Dict[int, BaseException]:
        """Pop every shed/failed request at once: {rid: exception}."""
        failed, self._failed = self._failed, {}
        return failed

    def invalidate(self) -> None:
        """Graph/model changed: backend drops derived state (cache bump)."""
        self._backend.invalidate()

    def update_params(self, params) -> None:
        """Swap model weights (same pytree structure; no recompile)."""
        self._backend.update_params(params)

    # -- internals -----------------------------------------------------------

    def _run(self, batches: List[Any], now: float) -> None:
        for batch in batches:
            self._apply(self._backend.execute(batch, now), now)

    def _apply(self, comps: List[Completion], now: float) -> None:
        t_done = self._wall(now)
        for c in comps:
            req = self._requests.get(c.rid)
            if req is None:
                continue                    # shed mid-flight; drop the result
            req.out[c.pos] = c.value
            req.remaining -= 1
            if req.remaining == 0 or c.final:
                self._finish(c.rid, t_done)

    def _finish(self, rid: int, t_done: float) -> None:
        req = self._requests.pop(rid)
        out = req.out
        if req.remaining > 0:               # early-final: truncate to filled
            out = out[:len(out) - req.remaining]
        self.latencies.observe(t_done - req.t_submit)
        self.completed += 1
        self._t_last = t_done
        self._done[rid] = out

    def _shed_expired(self, now: float) -> None:
        expired = [rid for rid, req in self._requests.items()
                   if req.deadline is not None
                   and now - req.t_submit >= req.deadline]
        for rid in expired:
            req = self._requests.pop(rid)
            self._backend.cancel(rid)
            self.shed_deadline += 1
            self._failed[rid] = Overloaded(
                f"request {rid} shed: still incomplete "
                f"{(now - req.t_submit) * 1e3:.1f} ms after submit "
                f"(deadline_ms={req.deadline * 1e3:g})")

    # -- stats ---------------------------------------------------------------

    def reset_stats(self) -> None:
        """Zero the latency/throughput counters (e.g. after jit warmup).
        Backend state (cache contents) and pending requests are
        untouched."""
        self.completed = 0
        self.shed_deadline = 0
        self.latencies = LatencyHistogram()
        self._t_first = None
        self._t_last = None
        self._backend.reset_stats()

    def stats(self) -> dict:
        lat = self.latencies.snapshot()
        span = ((self._t_last - self._t_first)
                if (self._t_first is not None and self._t_last is not None)
                else 0.0)
        out = {
            "completed": self.completed,
            "device_calls": self._backend.device_calls,
            "capacity": self._backend.capacity(),
            "shed_deadline": self.shed_deadline,
            "p50_ms": lat["p50_ms"],
            "p95_ms": lat["p95_ms"],
            "p99_ms": lat["p99_ms"],
            "mean_ms": lat["mean_ms"],
            "req_per_s": self.completed / span if span > 0 else float("inf"),
        }
        out.update(self._backend.stats())
        return out
