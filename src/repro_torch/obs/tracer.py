"""Phase-level host tracing: lightweight context-manager spans.

Counterpart of the host half of ``repro/obs/tracer.py``. Named spans
aggregate (count, total seconds, max) per phase path; ``span()`` returns
one shared no-op context when disabled; the span stack is thread-local
(the async-checkpoint worker records beside the driver) and aggregation
is lock-protected; a span opened inside another records under the joined
path (``"chunk/eval"``). :func:`phase` also opens a
``torch.profiler.record_function`` range, so the phase names label a
profiler trace (the reference's ``jax.named_scope``), and a scope of the
collective ledger (``obs.comm``), so the collectives inside are
attributed to the phase; ``trace_dir``
captures a ``torch.profiler`` trace between ``start_profile`` and
``stop_profile``. A span measures host wall time: CUDA work launched
inside it may still be running when it closes.
"""
from __future__ import annotations

import os
import threading
import time
from typing import Dict, Optional

import torch

from repro_torch.obs import comm


class _NullSpan:
    """The shared disabled-mode span: no state, no clock, no allocation."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False


NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("_tracer", "_name", "_t0", "path", "seconds")

    def __init__(self, tracer: "Tracer", name: str):
        self._tracer = tracer
        self._name = name
        self.path = name
        self.seconds = 0.0

    def __enter__(self) -> "_Span":
        stack = self._tracer._stack()
        stack.append(self._name)
        self.path = "/".join(stack)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        self.seconds = time.perf_counter() - self._t0
        self._tracer._stack().pop()
        self._tracer._record(self.path, self.seconds)
        return False


class Tracer:
    """Aggregating span recorder. ``span(name)`` is the only hot-path API."""

    def __init__(self, enabled: bool = True,
                 trace_dir: Optional[str] = None):
        self.enabled = enabled
        self.trace_dir = trace_dir
        self._lock = threading.Lock()
        self._local = threading.local()
        self._stats: Dict[str, list] = {}     # path -> [count, total, max]
        self._profiler = None

    def span(self, name: str):
        """Context manager timing one phase; the no-op singleton when
        disabled."""
        if not self.enabled:
            return NULL_SPAN
        return _Span(self, name)

    def record(self, name: str, seconds: float) -> None:
        """Record an externally-measured duration under ``name``."""
        if self.enabled:
            self._record(name, seconds)

    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def _record(self, path: str, seconds: float) -> None:
        with self._lock:
            ent = self._stats.get(path)
            if ent is None:
                self._stats[path] = [1, seconds, seconds]
            else:
                ent[0] += 1
                ent[1] += seconds
                ent[2] = max(ent[2], seconds)

    def summary(self) -> Dict[str, Dict[str, float]]:
        """``{path: {count, total_s, mean_ms, max_ms}}``."""
        with self._lock:
            return {path: {"count": c, "total_s": tot,
                           "mean_ms": tot / c * 1e3, "max_ms": mx * 1e3}
                    for path, (c, tot, mx) in sorted(self._stats.items())}

    def totals(self) -> Dict[str, float]:
        """Leaf-phase totals (the Fig. 8 breakdown input)."""
        out: Dict[str, float] = {}
        with self._lock:
            for path, (_, tot, _) in self._stats.items():
                leaf = path.rsplit("/", 1)[-1]
                out[leaf] = out.get(leaf, 0.0) + tot
        return out

    def start_profile(self) -> bool:
        """Start a ``torch.profiler`` trace (CPU and, with a card, CUDA
        activity) written to ``trace_dir`` at ``stop_profile``; a no-op
        without one. Returns whether a trace was started."""
        if self.trace_dir is None or self._profiler is not None:
            return False
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self._profiler = profile(activities=acts)
        self._profiler.__enter__()
        return True

    def stop_profile(self) -> None:
        if self._profiler is not None:
            prof, self._profiler = self._profiler, None
            prof.__exit__(None, None, None)
            os.makedirs(self.trace_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(self.trace_dir,
                                                  "trace.json"))


# the process-global tracer library code reports to; disabled by default
_GLOBAL = Tracer(enabled=False)


def get_tracer() -> Tracer:
    return _GLOBAL


def set_tracer(tracer: Tracer) -> Tracer:
    global _GLOBAL
    _GLOBAL = tracer
    return tracer


class _PhaseCtx:
    """A ``record_function`` range, a global-tracer span and a ledger
    scope in one context."""

    __slots__ = ("_rf", "_sp", "_sc")

    def __init__(self, name: str):
        self._rf = torch.profiler.record_function(name)
        self._sp = _GLOBAL.span(name)
        self._sc = comm.scope(name)

    def __enter__(self):
        self._rf.__enter__()
        self._sp.__enter__()
        self._sc.__enter__()
        return self

    def __exit__(self, *exc) -> bool:
        self._sc.__exit__(*exc)
        self._sp.__exit__(*exc)
        return bool(self._rf.__exit__(*exc))


def phase(name: str) -> _PhaseCtx:
    """Annotate one Fig.-8 phase in library code."""
    return _PhaseCtx(name)
