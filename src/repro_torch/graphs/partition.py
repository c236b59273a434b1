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
edges, zero features, and label ``-1`` (masked from the loss). The
locality clustering of the partition sampling mode is ROADMAP queue 1,
item 7.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from repro_torch.graphs.csr import CSRMatrix


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
    clusters: int = 0        # locality clusters per range (partition mode)
    max_cluster_block_nnz: int = 0

    @property
    def feature_dim(self) -> int:
        return int(self.features.shape[1])


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


def build_partitioned_graph(dataset, g: int, *,
                            clusters: int = 0) -> PartitionedGraph:
    """Partition a SyntheticDataset (or anything with the same fields) for
    a cube grid of side g. ``clusters > 0`` (the locality reordering of
    partition sampling) is ROADMAP queue 1, item 7."""
    if clusters:
        raise NotImplementedError(
            f"clusters={clusters}: the locality reordering is ROADMAP "
            "queue 1, item 7 (locality sampling modes and ingestion)")
    A = dataset.adj_norm
    n = A.n_rows
    n_local = -(-n // g)  # ceil
    n_pad = n_local * g
    block_rp, block_ci, block_val, e_pad, max_row_nnz = partition_csr_2d(
        A, g, n_pad)

    d_in = dataset.features.shape[1]
    feats = np.zeros((n_pad, d_in), dtype=np.float32)
    labels = np.full((n_pad,), -1, dtype=np.int32)
    train_mask = np.zeros((n_pad,), dtype=bool)
    feats[:n] = dataset.features
    labels[:n] = dataset.labels
    train_mask[:n] = dataset.train_mask

    return PartitionedGraph(
        n=n, n_pad=n_pad, g=g, n_local=n_local, e_pad=e_pad,
        block_rp=block_rp, block_ci=block_ci, block_val=block_val,
        max_block_row_nnz=max_row_nnz,
        features=feats, labels=labels, train_mask=train_mask,
        num_classes=dataset.num_classes)
