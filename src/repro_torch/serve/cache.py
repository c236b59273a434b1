"""Embedding cache: per-vertex output vectors keyed by (graph_version, id).

Hot vertices (Zipfian request streams) skip the neighborhood assembly and
jitted forward entirely. Entries are stored row-quantized to int8 with one
FP32 absmax scale per row (``repro_torch.core.precision``), quartering cache
memory vs FP32 — the cached value is an *approximation* both because of
quantization and because a sampled-support forward is itself a stochastic
estimator; callers opt in via ``ServeOptions.use_cache``.

Invalidation is by **graph version**: mutating the graph (or retraining the
model) bumps the version, after which every existing entry misses. Stale
versions are garbage-collected lazily on eviction. Capacity eviction is LRU.
Single-threaded by design (the engine serializes batch completion).
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import precision


class EmbeddingCache:
    """LRU cache of per-vertex float vectors with quantized storage.

    ``quantize`` — "int8" (default; 1 B/elem + scale) or "f32" (exact).
    """

    def __init__(self, capacity: int, quantize: str = "int8"):
        assert capacity >= 1
        assert quantize in ("int8", "f32"), quantize
        self.capacity = capacity
        self.quantize = quantize
        self.version = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self._store: "OrderedDict[Tuple[int, int], tuple]" = OrderedDict()

    def __len__(self) -> int:
        return len(self._store)

    def bump_version(self) -> int:
        """Invalidate every entry (graph mutated / model updated)."""
        self.version += 1
        return self.version

    def get(self, vertex: int) -> Optional[np.ndarray]:
        out = self.peek(vertex)
        if out is None:
            self.misses += 1
        else:
            self.hits += 1
        return out

    def peek(self, vertex: int) -> Optional[np.ndarray]:
        """Like :meth:`get` (refreshes LRU) but without counting a hit or
        miss — for engine-internal re-checks that would otherwise double
        count a vertex already missed at submit time."""
        key = (self.version, int(vertex))
        entry = self._store.get(key)
        if entry is None:
            return None
        self._store.move_to_end(key)
        if self.quantize == "int8":
            q, scale = entry
            return precision.dequantize_int8(q, scale)
        return entry[0].copy()

    def put(self, vertex: int, value: np.ndarray) -> None:
        key = (self.version, int(vertex))
        value = np.asarray(value, np.float32)
        if self.quantize == "int8":
            self._store[key] = precision.quantize_int8(value)
        else:
            self._store[key] = (value.copy(),)
        self._store.move_to_end(key)
        while len(self._store) > self.capacity:
            self._store.popitem(last=False)
            self.evictions += 1

    def put_many(self, vertices: Sequence[int], values: np.ndarray) -> None:
        for v, row in zip(vertices, np.asarray(values, np.float32)):
            self.put(v, row)

    def stats(self) -> dict:
        total = self.hits + self.misses
        return {
            "size": len(self._store),
            "hits": self.hits,
            "misses": self.misses,
            "hit_rate": self.hits / total if total else 0.0,
            "evictions": self.evictions,
            "version": self.version,
        }
