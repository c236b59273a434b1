"""2D block partitioning of the graph for 3D PMM (numpy).

A copy of the partitioner of ``repro/graphs/partition.py``. With the cube
grid ``gx = gy = gz = g`` all three rotation planes induce the same
``g x g`` block partition of A; blocks are stored as padded CSR so they
stack into rectangular arrays:

  block_rp : (g, g, n_local + 1) int32   row pointer, local rows
  block_ci : (g, g, e_pad)       int32   LOCAL column ids in [0, n_local);
                                         padding slots hold ``n_local``
  block_val: (g, g, e_pad)       float32 values; padding slots hold 0

Vertices are padded to ``n_pad = g * n_local``; ghost vertices have no
edges, zero features, and label ``-1`` (masked from the loss).

The locality modes' structures are copies of the reference's too: the
BFS reordering after which equal contiguous id spans are the partition
mode's clusters (:func:`locality_order`, :func:`permute_csr`), the
extraction bound of a clustered sample (:func:`max_cluster_block_nnz`)
and walk mode's replicated neighbor table and visit distribution
(:func:`build_walk_tables`).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from repro_torch.graphs.csr import CSRMatrix, coo_to_csr


def block_ranges(n_pad: int, g: int) -> np.ndarray:
    """Start offsets of the g equal vertex ranges (length g+1)."""
    if n_pad % g:
        raise ValueError(f"n_pad={n_pad} is not a multiple of g={g}")
    return np.arange(g + 1, dtype=np.int64) * (n_pad // g)


@dataclasses.dataclass
class PartitionedGraph:
    """The g x g padded-CSR block partition of a normalized adjacency."""

    n: int                   # true vertex count
    n_pad: int               # padded vertex count (g * n_local)
    g: int                   # grid side (gx = gy = gz = g)
    n_local: int             # vertices per range
    e_pad: int               # padded nnz per block
    block_rp: np.ndarray     # (g, g, n_local + 1) int32
    block_ci: np.ndarray     # (g, g, e_pad) int32, local cols, pad = n_local
    block_val: np.ndarray    # (g, g, e_pad) float32
    max_block_row_nnz: int   # max nnz of any single row within any block

    features: np.ndarray     # (n_pad, d_in) float32, ghost rows zero
    labels: np.ndarray       # (n_pad,) int32, ghosts = -1
    train_mask: np.ndarray   # (n_pad,) bool, ghosts False
    num_classes: int
    # partition mode: 0 = no cluster structure; else the vertex order is
    # BFS-locality-reordered and every range is tiled by `clusters` equal
    # contiguous clusters (the cluster of a local id is id // cluster_size)
    clusters: int = 0
    # the most nnz any ONE cluster's rows put into any single block: the
    # extraction bound of partition sampling (e_cap = q * this)
    max_cluster_block_nnz: int = 0

    @property
    def feature_dim(self) -> int:
        return int(self.features.shape[1])

    @property
    def cluster_size(self) -> int:
        if self.clusters <= 0:
            raise ValueError("the graph has no cluster structure")
        return self.n_local // self.clusters


def partition_csr_2d(A: CSRMatrix, g: int, n_pad: int
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int, int]:
    """Partition a square CSR matrix into g x g padded-CSR blocks.

    Returns (block_rp, block_ci, block_val, e_pad, max_block_row_nnz).
    """
    n = A.n_rows
    if n_pad % g or n_pad < n:
        raise ValueError(f"n_pad={n_pad} must be a multiple of g={g} and at "
                         f"least n={n}")
    n_local = n_pad // g

    # assign every nonzero to its block
    rows = np.repeat(np.arange(n, dtype=np.int64),
                     A.indptr[1:] - A.indptr[:-1])
    cols = A.indices.astype(np.int64)
    vals = A.data
    bi = rows // n_local
    bj = cols // n_local
    lr = rows - bi * n_local     # local row
    lc = cols - bj * n_local     # local col

    # count nnz per block to size the padding
    nnz_per_block = np.zeros((g, g), dtype=np.int64)
    np.add.at(nnz_per_block, (bi, bj), 1)
    e_pad = max(int(nnz_per_block.max(initial=0)), 1)

    block_rp = np.zeros((g, g, n_local + 1), dtype=np.int32)
    block_ci = np.full((g, g, e_pad), n_local, dtype=np.int32)
    block_val = np.zeros((g, g, e_pad), dtype=np.float32)

    # sort nonzeros by (block, local_row, local_col) and fill
    key = ((bi * g + bj) * n_local + lr) * n_local + lc
    order = np.argsort(key, kind="stable")
    bi, bj, lr, lc, vals = (bi[order], bj[order], lr[order], lc[order],
                            vals[order])

    max_row_nnz = 0
    # block start offsets in the sorted stream
    flat_block = bi * g + bj
    starts = np.searchsorted(flat_block, np.arange(g * g))
    ends = np.searchsorted(flat_block, np.arange(g * g), side="right")
    for fb in range(g * g):
        i, j = fb // g, fb % g
        s, e = starts[fb], ends[fb]
        cnt = e - s
        block_ci[i, j, :cnt] = lc[s:e]
        block_val[i, j, :cnt] = vals[s:e]
        # row pointer via bincount of local rows
        rc = np.bincount(lr[s:e], minlength=n_local)
        block_rp[i, j, 1:] = np.cumsum(rc)
        if cnt:
            max_row_nnz = max(max_row_nnz, int(rc.max(initial=0)))
    return block_rp, block_ci, block_val, e_pad, max_row_nnz


# ---------------------------------------------------------------------------
# Locality clustering (partition sampling mode) and walk tables
# ---------------------------------------------------------------------------
#
# Cluster-GCN samples whole clusters instead of scattered vertices. Without
# METIS, a BFS (Cuthill-McKee-style, unreversed) reordering puts neighbors
# at nearby new ids, after which equal contiguous id spans ARE the
# clusters: ranges and clusters are both positional spans of the reordered
# id space, and a vertex's cluster is one integer divide.

def locality_order(A: CSRMatrix) -> np.ndarray:
    """BFS visit order over the graph: ``order[k]`` is the original vertex
    id placed at new position ``k``. Frontier-vectorized BFS from the
    lowest-degree unvisited seed of each component, O(N + E)."""
    n = A.n_rows
    indptr, indices = A.indptr, A.indices
    deg = indptr[1:] - indptr[:-1]
    visited = np.zeros(n, dtype=bool)
    order = np.empty(n, dtype=np.int64)
    pos = 0
    seed_order = np.argsort(deg, kind="stable")   # low-degree periphery first
    seed_ptr = 0
    while pos < n:
        while seed_ptr < n and visited[seed_order[seed_ptr]]:
            seed_ptr += 1
        frontier = np.array([seed_order[seed_ptr]], dtype=np.int64)
        visited[frontier] = True
        while frontier.size:
            order[pos:pos + frontier.size] = frontier
            pos += frontier.size
            counts = deg[frontier]
            flat = np.repeat(indptr[frontier], counts) + (
                np.arange(counts.sum()) -
                np.repeat(np.cumsum(counts) - counts, counts))
            nbrs = indices[flat]
            nbrs = np.unique(nbrs[~visited[nbrs]])
            visited[nbrs] = True
            frontier = nbrs
    return order


def permute_csr(A: CSRMatrix, order: np.ndarray) -> CSRMatrix:
    """Symmetric permutation P A P^T: vertex ``order[k]`` becomes id ``k``."""
    n = A.n_rows
    inv = np.empty(n, dtype=np.int64)
    inv[order] = np.arange(n, dtype=np.int64)
    rows = np.repeat(np.arange(n, dtype=np.int64),
                     A.indptr[1:] - A.indptr[:-1])
    return coo_to_csr(inv[rows], inv[A.indices.astype(np.int64)], A.data,
                      (n, n))


def max_cluster_block_nnz(block_rp: np.ndarray, clusters: int) -> int:
    """The most nnz any one cluster's rows contribute within any single
    block: the bound partition-mode extraction is sized by."""
    g, n_local = block_rp.shape[0], block_rp.shape[2] - 1
    if n_local % clusters:
        raise ValueError(f"clusters={clusters} does not divide the range "
                         f"size n_local={n_local}")
    cs = n_local // clusters
    rc = block_rp[:, :, 1:] - block_rp[:, :, :-1]          # (g, g, n_local)
    per_cluster = rc.reshape(g, g, clusters, cs).sum(axis=3)
    return int(per_cluster.max(initial=0))


def build_walk_tables(pg: PartitionedGraph, k: int
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """The replicated tables of walk-mode sampling:

    * ``walk_nbr`` (n_pad, k) int32 — global ids of up to ``k`` IN-RANGE
      neighbors per vertex, from the diagonal block (rows with fewer than
      ``k`` cycle through what they have; isolated and ghost rows
      self-loop), so a walk stays in its range, as the communication-free
      extraction requires;
    * ``p_tilde`` (n_pad,) float32 — the visit distribution within each
      range, degree-proportional (the walk's stationary distribution;
      sums to 1 per range), which the plan scales to the inclusion
      estimate ``min(1, b * p_tilde)`` of the SAINT edge rescale.
    """
    g, n_local = pg.g, pg.n_local
    n_pad = pg.n_pad
    nbr = np.tile(np.arange(n_pad, dtype=np.int32)[:, None], (1, k))
    p_tilde = np.zeros(n_pad, dtype=np.float64)
    for i in range(g):
        lo = i * n_local
        deg = np.zeros(n_local, dtype=np.float64)
        for j in range(g):
            rp = pg.block_rp[i, j]
            deg += rp[1:] - rp[:-1]
        tot = deg.sum()
        if tot > 0:
            p_tilde[lo:lo + n_local] = deg / tot
        rp = np.asarray(pg.block_rp[i, i])
        ci = np.asarray(pg.block_ci[i, i])
        counts = rp[1:] - rp[:-1]
        has = counts > 0
        safe = np.maximum(counts, 1)
        for s in range(k):
            src = rp[:-1] + s % safe
            vals = ci[np.minimum(src, ci.shape[0] - 1)] + lo
            nbr[lo:lo + n_local][has, s] = vals[has]
    return nbr, p_tilde.astype(np.float32)


def build_partitioned_graph(dataset, g: int, *,
                            clusters: int = 0) -> PartitionedGraph:
    """Partition a SyntheticDataset (or anything with the same fields) for
    a cube grid of side g. ``clusters > 0`` also BFS-locality-reorders the
    vertices and records a cluster structure of that many equal contiguous
    clusters per range (partition sampling): ``n_local`` is padded up so
    that the clusters tile it, and ``max_cluster_block_nnz`` gives the
    tightened extraction bound."""
    A = dataset.adj_norm
    n = A.n_rows
    order = None
    if clusters > 0:
        order = locality_order(A)
        A = permute_csr(A, order)
    n_local = -(-n // g)  # ceil
    if clusters > 0:
        # pad the range so that `clusters` equal clusters tile it
        n_local = -(-n_local // clusters) * clusters
    n_pad = n_local * g
    block_rp, block_ci, block_val, e_pad, max_row_nnz = partition_csr_2d(
        A, g, n_pad)

    d_in = dataset.features.shape[1]
    feats = np.zeros((n_pad, d_in), dtype=np.float32)
    labels = np.full((n_pad,), -1, dtype=np.int32)
    train_mask = np.zeros((n_pad,), dtype=bool)
    keep = slice(None) if order is None else order
    feats[:n] = np.asarray(dataset.features)[keep]
    labels[:n] = np.asarray(dataset.labels)[keep]
    train_mask[:n] = np.asarray(dataset.train_mask)[keep]

    return PartitionedGraph(
        n=n, n_pad=n_pad, g=g, n_local=n_local, e_pad=e_pad,
        block_rp=block_rp, block_ci=block_ci, block_val=block_val,
        max_block_row_nnz=max_row_nnz,
        features=feats, labels=labels, train_mask=train_mask,
        num_classes=dataset.num_classes, clusters=clusters,
        max_cluster_block_nnz=(max_cluster_block_nnz(block_rp, clusters)
                               if clusters > 0 else 0))
