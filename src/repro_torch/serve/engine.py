"""Online GNN inference: the classification backend of the serving core,
on one GPU or over the 4D mesh.

Counterpart of ``repro/serve/engine.py``. One engine owns a GCN, the graph
CSR and the features on the device, a micro-batcher and an optional int8
embedding cache. Every micro-batch has ``slots + support`` vertices, planned
on the host into ``plan_ranges`` vertex ranges (``plan_batch_ranges``; one
range by default, which is ``plan_batch``'s plan bit for bit): its ids and
per-column scales are copied host -> device, the Alg.-2 block is assembled
there (the fused CUDA extraction kernel with ``extract_impl="cuda"``), the
GCN forward runs (the fused CUDA tail with
``GCNConfig.elementwise_impl="cuda"``) and the logits come back with
``.cpu()``.

Over a mesh (``mesh_shape=(g, g, g)``, ``mesh_dp``, or
``force_distributed``; ``serve/distributed.py``) every rank builds the same
engine under ``torchrun``; rank 0 serves, and the others run
``serve_worker(engine)`` until rank 0's ``close()``. A group of ``mesh_dp``
micro-batches is staged and served by ONE device call.

Request lifecycle::

    rid = eng.submit([v0, v1, ...])     # enqueue; full batches run inline
    eng.pump()                          # flush deadline-expired batches
    out = eng.poll(rid)                 # (k, num_classes) logits or None

``predict(ids)`` is the synchronous convenience wrapper. In **replay
mode** the clock is virtual, so an identical request stream produces
bit-identical outputs.

The engine runs on the card unless ``ServeOptions.device`` names the CPU
(a mesh on the CPU runs over gloo); with no card it raises.
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
from repro_torch.tree import leaves


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
    # -- serving over the 4D mesh (serve/distributed.py) ---------------------
    # (1, 1, 1) is the single-device path (the correctness oracle); a cube
    # (g, g, g) fans every micro-batch out across the PMM grid.
    mesh_shape: tuple = (1, 1, 1)
    # data-parallel serving groups: the mesh gains a 'd' axis of this size
    # and ONE device call serves `mesh_dp` stacked micro-batches.
    mesh_dp: int = 1
    # stratify the support plan into this many vertex ranges WITHOUT a mesh
    # (0 = derive from mesh_shape). The oracle knob: a single-device engine
    # with plan_ranges=g builds the micro-batches of a (g, g, g) mesh
    # engine, so the parallel forward is the only difference.
    plan_ranges: int = 0
    # run the mesh path even on a (1, 1, 1) mesh (one rank; the math is the
    # same either way)
    force_distributed: bool = False


class GNNBackend:
    """Vertex-classification backend: Alg.-2 assembly + int8 cache +
    single-device or 3D-PMM forward. A "batch" at the protocol seam is one
    dp GROUP, a list of :class:`MicroBatch` served by ONE device call."""

    def __init__(self, params: M.Params, cfg: M.GCNConfig, A: CSRMatrix,
                 features: np.ndarray, options: ServeOptions,
                 e_cap: Optional[int] = None):
        g3 = tuple(options.mesh_shape)
        if len(g3) != 3 or not g3[0] == g3[1] == g3[2] >= 1:
            raise ValueError(f"mesh_shape={g3} must be a cube (g, g, g)")
        g_mesh = g3[0]
        self._dp = options.mesh_dp
        if self._dp < 1:
            raise ValueError(f"mesh_dp={self._dp} must be at least 1")
        self._distributed = (g_mesh > 1 or self._dp > 1
                             or options.force_distributed)
        if not options.micro_batch and self._dp > 1:
            raise ValueError(
                "naive mode (micro_batch=False) promises one device call per "
                "request; dp staging (mesh_dp > 1) would batch them")
        use_full_f32_matmul()          # no TF32: GEMMs stay f32, as in JAX
        self.cfg = cfg
        self.opts = options
        self.spec = asm.make_spec(A, options.slots, options.support, e_cap)
        self._batcher = MicroBatcher(options.slots,
                                     options.max_delay_ms / 1e3)
        self._cache = (EmbeddingCache(options.cache_capacity,
                                      options.cache_quantize)
                       if options.use_cache else None)
        self._staged: List = []                # (MicroBatch, t) awaiting dp
        self.device_calls = 0
        self.queue_high_water = 0      # max items pending in the batcher
        self._slots_filled = 0         # requested vertices actually batched
        self._slots_total = 0          # slot capacity of every batch run

        if self._distributed:
            from repro_torch.serve.distributed import (build_serve_plan,
                                                       make_serve_mesh)
            if options.plan_ranges not in (0, g_mesh):
                raise ValueError("plan_ranges is fixed to the mesh grid side "
                                 "when serving over a mesh")
            mesh = make_serve_mesh(g_mesh, self._dp, options.device)
            self.device = mesh.device
            self._dist = build_serve_plan(
                A, np.asarray(features, np.float32), cfg, mesh, self.spec,
                extract_impl=options.extract_impl,
                support_seed=options.support_seed,
                param_shapes=tuple(tuple(t.shape) for t in leaves(params)))
            self._n_pad_plan = self._dist.pg.n_pad
            self._pools = self._dist.pools
            self._graph_sh = self._dist.shard_graph()
            self._params = self._dist.shard_params(params)
            return

        self._dist = None
        self.device = resolve_device(options.device)
        self._params = M.params_to(params, self.device)
        g_plan = options.plan_ranges or 1
        n_local = -(-self.spec.n // g_plan)
        self._n_pad_plan = n_local * g_plan
        self._pools = asm.make_support_pools(
            self.spec.n, self._n_pad_plan, g_plan, options.support_seed,
            min_size=self.spec.total // g_plan)

        dev = self.device
        self._rp = torch.from_numpy(np.asarray(A.indptr, np.int32)).to(dev)
        self._ci = torch.from_numpy(np.asarray(A.indices, np.int32)).to(dev)
        self._val = torch.from_numpy(np.asarray(A.data, np.float32)).to(dev)
        self._feats = torch.from_numpy(
            np.ascontiguousarray(features, np.float32)).to(dev)
        self._builder = asm.make_builder(self.spec,
                                         impl=options.extract_impl,
                                         max_row_nnz=A.max_row_nnz())

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
        return self._stage(batches)

    def plan(self, now: float, force: bool) -> List[Any]:
        if force:
            groups = self._stage(self._batcher.flush_all())
            # a partially filled dp group must not wait for more batches
            if self._staged:
                groups.append(self._take_staged())
            return groups
        groups = self._stage(self._batcher.flush_due(now))
        # a partially filled dp group waits at most one max_delay
        if (self._staged
                and now >= self._staged[0][1] + self.opts.max_delay_ms / 1e3):
            groups.append(self._take_staged())
        return groups

    def cancel(self, rid: int) -> None:
        self._batcher.cancel(rid)
        staged = []
        for b, t in self._staged:
            items = tuple(it for it in b.items if it.req_id != rid)
            if items:
                staged.append((MicroBatch(items), t))
        self._staged = staged

    def busy(self) -> bool:
        return False        # queued work waits for its deadline by design

    def update_params(self, params: M.Params) -> None:
        """New global params; over a mesh rank 0 sends them to every rank
        and each shards its own."""
        if self._distributed:
            self._dist.send_params(params)
            self._params = self._dist.shard_params(params)
        else:
            self._params = M.params_to(params, self.device)
        self.invalidate()

    def invalidate(self) -> None:
        """Graph/model changed: next lookups miss (cache version bump)."""
        if self._cache is not None:
            self._cache.bump_version()

    # -- the mesh's other ranks -----------------------------------------------

    def serve_worker(self) -> int:
        """Every rank but 0 of a mesh: join rank 0's device calls until it
        closes its engine (``serve_worker`` of ``serve/distributed.py``)."""
        if not self._distributed:
            raise RuntimeError("serve_worker runs on the ranks of a mesh "
                               "engine")
        return self._dist.worker_loop(self._params, self._graph_sh)

    def close(self) -> None:
        """Release the mesh's other ranks (rank 0; idempotent; nothing to
        do on one device)."""
        if self._distributed and self._dist.mesh.rank == 0:
            self._dist.stop()

    # -- batching internals --------------------------------------------------

    def _stage(self, batches: List[MicroBatch]) -> List[List[MicroBatch]]:
        """Full micro-batches -> executable dp groups. With ``mesh_dp`` 1
        each runs at once; otherwise batches stage until ``mesh_dp`` are
        ready (continuous batching over the mesh's data axis)."""
        if self._dp == 1:
            return [[b] for b in batches]
        groups = []
        for b in batches:
            # the batch's OLDEST item's enqueue time: the batcher's wait
            # and the staging wait share one max_delay budget
            self._staged.append((b, b.items[0].t_enqueue))
            if len(self._staged) >= self._dp:
                groups.append(self._take_staged())
        return groups

    def _take_staged(self) -> List[MicroBatch]:
        group, self._staged = [b for b, _ in self._staged], []
        return group

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
    def forward_plan(self, plan: asm.ShardedBatchPlan) -> np.ndarray:
        """ONE device call on one device: assemble the planned
        micro-batch's block, run the GCN, return the (total, num_classes)
        logits on the host, rows in flat batch order."""
        dev = self.device
        ids = torch.from_numpy(plan.batch_ids.reshape(-1)).to(dev)
        col_scale = torch.from_numpy(plan.col_scale.reshape(-1)).to(dev)
        adj = self._builder.assemble(self._rp, self._ci, self._val, ids,
                                     col_scale, e_cap=self.spec.e_cap)
        logits = M.forward(self._params, adj, self._feats[ids], self.cfg,
                           train=False)
        return logits.cpu().numpy()

    def _forward_plans(self, plans: List[asm.ShardedBatchPlan]
                       ) -> np.ndarray:
        """ONE device call for up to ``mesh_dp`` planned micro-batches;
        returns (len(plans), total, num_classes) logits in flat batch
        order."""
        if not self._distributed:
            (plan,) = plans                     # dp staging implies a mesh
            return self.forward_plan(plan)[None]
        # pad the group to the dp extent by repeating the first plan (the
        # duplicate groups' outputs are never read)
        pad = [plans[0]] * (self._dp - len(plans))
        ids3d = np.stack([p.batch_ids for p in plans + pad])
        scale3d = np.stack([p.col_scale for p in plans + pad])
        logits = self._dist.step(self._params, self._graph_sh, ids3d,
                                 scale3d)
        return logits[:len(plans), :, :self.cfg.num_classes]

    def execute(self, group: List[MicroBatch],
                now: float) -> List[Completion]:
        staged = []                             # (batch, rows, miss, plan)
        plans = []
        for batch in group:
            # occupancy: distinct requested vertices vs the batch's static
            # slot capacity: the complement is padding the device computes
            # for nothing
            self._slots_filled += min(len(set(batch.vertices)),
                                      self.spec.slots)
            self._slots_total += self.spec.slots
            rows, miss = self._miss_rows(batch)
            plan = None
            if miss.size:
                plan = asm.plan_batch_ranges(miss, self.spec, self._pools,
                                             self._n_pad_plan)
                plans.append(plan)
            staged.append((batch, rows, miss, plan))

        if plans:
            logits = self._forward_plans(plans)
            self.device_calls += 1
            k = 0
            for batch, rows, miss, plan in staged:
                if plan is None:
                    continue
                fresh = logits[k][plan.req_pos]   # (|miss|, C), miss order
                k += 1
                for v, row in zip(miss, fresh):
                    rows[int(v)] = row
                if self._cache is not None:
                    self._cache.put_many(miss, fresh)

        return [Completion(it.req_id, it.pos, rows[it.vertex])
                for batch, rows, _, _ in staged for it in batch.items]

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
            "staged": len(self._staged),
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

    def close(self) -> None:
        """Over a mesh, rank 0 releases the other ranks' ``serve_worker``
        loops; call once serving is done (a no-op on one device)."""
        self.backend.close()
