"""Neighborhood assembly for serving: the Alg.-2 machinery applied to an
*arbitrary requested* vertex set instead of a ``(seed, step)``-derived one.

Counterpart of ``repro/serve/assembler.py`` (the planning half is a
numpy copy). Serving completes the requested vertices R (probability 1)
with a uniformly drawn **support set** U ⊂ V \\ R that supplies
neighborhood context, and rescales per column:

    scale(col) = 1            if col ∈ R ∪ {diag}
    scale(col) = (N-r)/|U|    if col ∈ U          (1/p_support)

so that ``E_U[ Ã_S x_S ] = Ã x`` restricted to the requested rows (Eq. 24
specialised to a two-stratum sample). The support pool is a fixed
permutation of V derived from a seed, so the support set for a given
requested set is a pure function of ``(seed, R)``: any replica assembling
the same micro-batch builds the identical block.

Extraction goes through ``core.minibatch.MinibatchBuilder``, so serving
takes either extraction backend (``"torch"`` or the fused ``"cuda"``
kernel). Every micro-batch has exactly ``slots + support`` distinct
vertices.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

from repro_torch.core import sampling as smp
from repro_torch.core.minibatch import MinibatchBuilder
from repro_torch.graphs.csr import CSRMatrix


class AssemblySpec(NamedTuple):
    """Static shapes of one serving micro-batch."""

    n: int          # true vertex count of the graph
    slots: int      # requested-vertex capacity (micro-batcher slots)
    support: int    # support vertices appended for neighborhood context
    e_cap: int      # static bound on extracted nnz (Alg. 2)

    @property
    def total(self) -> int:
        return self.slots + self.support


def make_spec(A: CSRMatrix, slots: int, support: int,
              e_cap: int | None = None) -> AssemblySpec:
    n = A.n_rows
    if slots + support > n:
        raise ValueError(f"batch ({slots}+{support}) exceeds graph size {n}")
    e_cap = e_cap or max((slots + support) * A.max_row_nnz(), 1)
    return AssemblySpec(n=n, slots=slots, support=support, e_cap=e_cap)


def make_support_pool(n: int, seed: int = 0) -> np.ndarray:
    """Fixed uniform permutation of V — the deterministic support stream."""
    return np.random.default_rng(seed).permutation(n).astype(np.int32)


class BatchPlan(NamedTuple):
    """Host-side plan for one micro-batch (all arrays static-shape)."""

    batch_ids: np.ndarray   # (total,) sorted distinct int32 vertex ids
    col_scale: np.ndarray   # (total,) float32 per-column rescale
    req_pos: np.ndarray     # (k,) position of each requested vertex in batch_ids
    num_requested: int      # r = |unique requested|


def plan_batch(requested: np.ndarray, spec: AssemblySpec,
               support_pool: np.ndarray) -> BatchPlan:
    """Complete the requested set with support vertices and compute the
    per-column rescale. ``requested`` is (k,), k <= slots, possibly with
    duplicates (two queued requests may name the same vertex)."""
    requested = np.asarray(requested, np.int64)
    assert requested.size <= spec.slots, "micro-batch overflow"
    uniq = np.unique(requested)                      # sorted, distinct
    r = int(uniq.size)
    need = spec.total - r
    # first `need` pool entries outside R: a uniform (need)-subset of V \ R.
    # Scanning the (r + need)-prefix suffices — at most r of its entries can
    # be requested — keeping host work O(total), not O(n), per batch.
    cand = support_pool[:r + need]
    fill = cand[~np.isin(cand, uniq)][:need]
    batch_ids = np.sort(np.concatenate([uniq, fill.astype(np.int64)]))
    is_req = np.isin(batch_ids, uniq)
    inv_p = (spec.n - r) / need if need > 0 else 1.0
    col_scale = np.where(is_req, 1.0, inv_p).astype(np.float32)
    req_pos = np.searchsorted(batch_ids, requested).astype(np.int32)
    return BatchPlan(batch_ids=batch_ids.astype(np.int32),
                     col_scale=col_scale, req_pos=req_pos, num_requested=r)


def make_support_pools(n: int, n_pad: int, g: int, seed: int = 0,
                       min_size: int = 0) -> list[np.ndarray]:
    """Per-vertex-range support streams for the stratified planner.

    Range ``i`` covers padded ids ``[i * n_local, (i+1) * n_local)``; its pool
    is a fixed permutation of the range's *true* vertices. With ``g = 1`` the
    single pool is bit-identical to ``make_support_pool(n, seed)``.

    ``min_size`` is the per-range batch capacity (``total / g``): a range
    whose true-vertex count is below it could never fill its slots, so the
    configuration is rejected here, at construction.
    """
    assert n_pad % g == 0 and n_pad >= n
    n_local = n_pad // g
    rng = np.random.default_rng(seed)
    pools = []
    for i in range(g):
        lo, hi = i * n_local, min((i + 1) * n_local, n)
        if hi - lo < max(min_size, 1):
            raise ValueError(
                f"vertex range {i} holds {max(hi - lo, 0)} true vertices < "
                f"the {min_size} batch slots it must fill (n={n}, g={g}) — "
                "shrink the batch or the grid")
        pools.append((rng.permutation(hi - lo) + lo).astype(np.int32))
    return pools


class ShardedBatchPlan(NamedTuple):
    """Host-side plan of one micro-batch stratified over g vertex ranges.
    Flattening ``batch_ids`` row-major gives a globally sorted id list
    (ranges are contiguous and ascending), so ``req_pos`` indexes the flat
    order exactly like :class:`BatchPlan`."""

    batch_ids: np.ndarray   # (g, total/g) int32 global ids, sorted per range
    col_scale: np.ndarray   # (g, total/g) float32 per-column rescale
    req_pos: np.ndarray     # (k,) flat position of each requested vertex
    num_requested: int      # |unique requested|


def plan_batch_ranges(requested: np.ndarray, spec: AssemblySpec,
                      pools: list[np.ndarray], n_pad: int
                      ) -> ShardedBatchPlan:
    """Stratified serving plan: exactly ``total/g`` batch vertices per vertex
    range. Within range ``i`` holding ``r_i`` requested vertices, the
    ``need_i`` support columns are a uniform subset of the range's remaining
    ``n_i - r_i`` true vertices, so their unbiased scale is
    ``(n_i - r_i) / need_i``. At ``g = 1`` this is bit-identical to
    :func:`plan_batch`.
    """
    g = len(pools)
    assert spec.total % g == 0, (spec.total, g)
    b_loc = spec.total // g
    assert spec.slots <= b_loc, (
        f"slots={spec.slots} can overflow one range (capacity {b_loc}); "
        "raise support so total/g >= slots")
    n_local = n_pad // g
    requested = np.asarray(requested, np.int64)
    assert requested.size <= spec.slots, "micro-batch overflow"
    uniq = np.unique(requested)
    rows_ids, rows_scale = [], []
    for i in range(g):
        lo = i * n_local
        in_range = uniq[(uniq >= lo) & (uniq < lo + n_local)]
        r_i = int(in_range.size)
        need = b_loc - r_i
        pool = pools[i]
        assert need <= pool.size - r_i, (
            f"range {i}: need {need} support from {pool.size - r_i} free "
            "vertices — shrink the batch or the grid")
        cand = pool[:r_i + need]
        fill = cand[~np.isin(cand, in_range)][:need]
        ids = np.sort(np.concatenate([in_range, fill.astype(np.int64)]))
        inv_p = (pool.size - r_i) / need if need > 0 else 1.0
        scale = np.where(np.isin(ids, in_range), 1.0, inv_p)
        rows_ids.append(ids.astype(np.int32))
        rows_scale.append(scale.astype(np.float32))
    batch_ids = np.stack(rows_ids)
    col_scale = np.stack(rows_scale)
    req_pos = np.searchsorted(batch_ids.reshape(-1),
                              requested).astype(np.int32)
    return ShardedBatchPlan(batch_ids=batch_ids, col_scale=col_scale,
                            req_pos=req_pos, num_requested=int(uniq.size))


def make_builder(spec: AssemblySpec, *, impl: str = "torch",
                 max_row_nnz: int = 0) -> MinibatchBuilder:
    """The serving instance of the batch-construction layer: one 'stratum'
    of ``total`` vertices; the per-column rescale comes from the planner."""
    return MinibatchBuilder(
        scfg=smp.SampleConfig(n_pad=spec.n, g=1, batch=spec.total,
                              e_cap=spec.e_cap),
        impl=impl, max_row_nnz=max_row_nnz)
