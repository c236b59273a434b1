"""Online GNN inference on one GPU: the classification backend of the
serving core.

Counterpart of ``repro/serve/engine.py`` (single device). One engine owns
a GCN, the graph CSR and the features on the device, a micro-batcher and an
optional int8 embedding cache. Every micro-batch has ``slots + support``
vertices: its ``batch_ids`` and ``col_scale`` are copied host -> device,
the Alg.-2 block is assembled there (the fused CUDA extraction kernel with
``extract_impl="cuda"``), the GCN forward runs (the fused CUDA tail with
``GCNConfig.elementwise_impl="cuda"``) and the logits come back with
``.cpu()``.

Request lifecycle::

    rid = eng.submit([v0, v1, ...])     # enqueue; full batches run inline
    eng.pump()                          # flush deadline-expired batches
    out = eng.poll(rid)                 # (k, num_classes) logits or None

``predict(ids)`` is the synchronous convenience wrapper. In **replay
mode** the clock is virtual, so an identical request stream produces
bit-identical outputs.

The engine runs on the card unless ``ServeOptions.device`` names the CPU;
with no card it raises. Serving over a mesh (``serve/distributed.py`` of
the JAX package) is still to be ported.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import gcn_model as M
from repro_torch.device import resolve_device, use_full_f32_matmul
from repro_torch.graphs.csr import CSRMatrix
from repro_torch.serve import assembler as asm
from repro_torch.serve.batcher import MicroBatch, MicroBatcher
from repro_torch.serve.cache import EmbeddingCache
from repro_torch.serve.core import ServingCore
from repro_torch.serve.protocol import Completion, PendingRequest

_MESH_TODO = ("serving over a mesh (serve/distributed.py) is not ported "
              'yet: ROADMAP queue 1, "Distributed serving and the threaded '
              'driver"')


@dataclasses.dataclass(frozen=True)
class ServeOptions:
    """Knobs of the serving path."""

    slots: int = 64             # requested-vertex capacity per micro-batch
    support: int = 192          # support vertices appended per micro-batch
    max_delay_ms: float = 2.0   # deadline flush for partial batches
    micro_batch: bool = True    # False -> naive: one device call per request
    use_cache: bool = False
    cache_capacity: int = 8192
    cache_quantize: str = "int8"
    support_seed: int = 0
    replay: bool = False        # virtual clock; deterministic replays
    # extraction backend for neighborhood assembly: "torch" (reference) or
    # "cuda" (fused gather kernel, kernels/extract_gather.py)
    extract_impl: str = "torch"
    # None = the card; "cpu" runs every kernel's plain version
    device: Optional[str] = None
    # -- serving over a mesh: not ported yet, must stay at the defaults ----
    mesh_shape: tuple = (1, 1, 1)
    mesh_dp: int = 1
    force_distributed: bool = False


class GNNBackend:
    """Vertex-classification backend: Alg.-2 assembly + int8 cache +
    single-device forward. A "batch" at the protocol seam is a list of one
    :class:`MicroBatch`, served by ONE device call."""

    def __init__(self, params: M.Params, cfg: M.GCNConfig, A: CSRMatrix,
                 features: np.ndarray, options: ServeOptions,
                 e_cap: Optional[int] = None):
        if (tuple(options.mesh_shape) != (1, 1, 1) or options.mesh_dp != 1
                or options.force_distributed):
            raise NotImplementedError(_MESH_TODO)
        self.device = resolve_device(options.device)
        use_full_f32_matmul()          # no TF32: GEMMs stay f32, as in JAX
        self.cfg = cfg
        self.opts = options
        self.spec = asm.make_spec(A, options.slots, options.support, e_cap)
        self._params = M.params_to(params, self.device)
        self._batcher = MicroBatcher(options.slots,
                                     options.max_delay_ms / 1e3)
        self._cache = (EmbeddingCache(options.cache_capacity,
                                      options.cache_quantize)
                       if options.use_cache else None)

        self._pool = asm.make_support_pool(self.spec.n, options.support_seed)

        dev = self.device
        self._rp = torch.from_numpy(np.asarray(A.indptr, np.int32)).to(dev)
        self._ci = torch.from_numpy(np.asarray(A.indices, np.int32)).to(dev)
        self._val = torch.from_numpy(np.asarray(A.data, np.float32)).to(dev)
        self._feats = torch.from_numpy(
            np.ascontiguousarray(features, np.float32)).to(dev)
        self._builder = asm.make_builder(self.spec,
                                         impl=options.extract_impl,
                                         max_row_nnz=A.max_row_nnz())

        self.device_calls = 0
        self.queue_high_water = 0      # max items pending in the batcher
        self._slots_filled = 0         # requested vertices actually batched
        self._slots_total = 0          # slot capacity of every batch run

    # -- protocol ------------------------------------------------------------

    def capacity(self) -> int:
        return self.spec.slots

    def validate(self, payload: Sequence[int]) -> None:
        vertices = [int(v) for v in payload]
        if not vertices:
            raise ValueError("empty request")
        if not all(0 <= v < self.spec.n for v in vertices):
            raise ValueError(f"vertex out of range [0, {self.spec.n})")

    def new_request(self, payload: Sequence[int]) -> np.ndarray:
        return np.zeros((len(payload), self.cfg.num_classes), np.float32)

    def admit(self, req: PendingRequest, now: float) -> List[Any]:
        vertices = [int(v) for v in req.payload]
        # cache hits are served at submit time and never occupy batch slots
        # (hot vertices skip neighborhood assembly entirely)
        miss_pos, miss_verts = [], []
        for pos, v in enumerate(vertices):
            row = self._cache.get(v) if self._cache is not None else None
            if row is not None:
                req.out[pos] = row
                req.remaining -= 1
            else:
                miss_pos.append(pos)
                miss_verts.append(v)
        if req.remaining == 0:
            return []

        if not self.opts.micro_batch and len(miss_verts) > self.spec.slots:
            raise ValueError("request too large for naive mode")
        batches = self._batcher.add(req.rid, miss_verts, now, miss_pos)
        if not self.opts.micro_batch:
            # naive path: one device call per request, no coalescing
            batches += self._batcher.flush_all()
        self.queue_high_water = max(self.queue_high_water,
                                    self._batcher.pending)
        return [[b] for b in batches]

    def plan(self, now: float, force: bool) -> List[Any]:
        batches = (self._batcher.flush_all() if force
                   else self._batcher.flush_due(now))
        return [[b] for b in batches]

    def cancel(self, rid: int) -> None:
        self._batcher.cancel(rid)

    def busy(self) -> bool:
        return False        # queued work waits for its deadline by design

    def update_params(self, params: M.Params) -> None:
        self._params = M.params_to(params, self.device)
        self.invalidate()

    def invalidate(self) -> None:
        """Graph/model changed: next lookups miss (cache version bump)."""
        if self._cache is not None:
            self._cache.bump_version()

    # -- batching internals --------------------------------------------------

    def _miss_rows(self, batch: MicroBatch):
        """(cache-served rows, still-missing distinct vertices) of a batch.

        The re-check deliberately skips hit/miss counters: these vertices
        already missed at submit time, but an earlier batch may have filled
        them while they sat in the queue."""
        distinct = np.unique(np.asarray(batch.vertices, np.int64))
        rows: Dict[int, np.ndarray] = {}
        if self._cache is None:
            return rows, distinct
        miss_list = []
        for v in distinct:
            row = self._cache.peek(v)
            if row is not None:
                rows[int(v)] = row
            else:
                miss_list.append(v)
        return rows, np.asarray(miss_list, np.int64)

    @torch.inference_mode()
    def forward_plan(self, plan: asm.BatchPlan) -> np.ndarray:
        """ONE device call: assemble the planned micro-batch's block, run
        the GCN, return the (total, num_classes) logits on the host."""
        dev = self.device
        ids = torch.from_numpy(plan.batch_ids).to(dev)
        col_scale = torch.from_numpy(plan.col_scale).to(dev)
        adj = self._builder.assemble(self._rp, self._ci, self._val, ids,
                                     col_scale, e_cap=self.spec.e_cap)
        logits = M.forward(self._params, adj, self._feats[ids], self.cfg,
                           train=False)
        return logits.cpu().numpy()

    def execute(self, group: List[MicroBatch],
                now: float) -> List[Completion]:
        (batch,) = group
        # occupancy: distinct requested vertices vs the batch's static slot
        # capacity — the complement is padding the device computes for
        # nothing
        self._slots_filled += min(len(set(batch.vertices)), self.spec.slots)
        self._slots_total += self.spec.slots
        rows, miss = self._miss_rows(batch)
        if miss.size:
            plan = asm.plan_batch(miss, self.spec, self._pool)
            fresh = self.forward_plan(plan)[plan.req_pos]  # (|miss|, C)
            self.device_calls += 1
            for v, row in zip(miss, fresh):
                rows[int(v)] = row
            if self._cache is not None:
                self._cache.put_many(miss, fresh)
        return [Completion(it.req_id, it.pos, rows[it.vertex])
                for it in batch.items]

    # -- stats ---------------------------------------------------------------

    def reset_stats(self) -> None:
        self.device_calls = 0
        self.queue_high_water = 0
        self._slots_filled = 0
        self._slots_total = 0

    def stats(self) -> dict:
        out = {
            "batches": self._batcher.batches_emitted,
            "pending": self._batcher.pending,
            "queue_high_water": self.queue_high_water,
            # slot occupancy of the batches actually run; the complement is
            # the device cycles spent on padding
            "occupancy": (self._slots_filled / self._slots_total
                          if self._slots_total else 0.0),
            "padding_waste": (1.0 - self._slots_filled / self._slots_total
                              if self._slots_total else 0.0),
        }
        if self._cache is not None:
            out["cache"] = self._cache.stats()
        return out


class InferenceEngine(ServingCore):
    """Serve "classify these vertex IDs" requests against a GCN."""

    def __init__(self, params: M.Params, cfg: M.GCNConfig, A: CSRMatrix,
                 features: np.ndarray, options: ServeOptions = ServeOptions(),
                 e_cap: Optional[int] = None):
        backend = GNNBackend(params, cfg, A, features, options, e_cap)
        super().__init__(backend, replay=options.replay)
        self.backend = backend
        self.cfg = cfg
        self.opts = options
        self.spec = backend.spec

    @property
    def queue_high_water(self) -> int:
        return self.backend.queue_high_water
