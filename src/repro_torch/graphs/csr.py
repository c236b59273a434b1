"""CSR/COO sparse-matrix utilities for GNN training and serving.

A copy of ``repro/graphs/csr.py``: host-side graph preparation in numpy
(graphs are built once, on the CPU); the serving engine copies the resulting
arrays to the device as torch tensors. The port keeps its own copy so that
it imports nothing of the JAX package.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


@dataclasses.dataclass
class CSRMatrix:
    """A CSR sparse matrix with float values.

    Attributes:
      indptr:  (n_rows + 1,) int32 row pointer.
      indices: (nnz,) int32 column indices, sorted within each row.
      data:    (nnz,) float32 values.
      shape:   (n_rows, n_cols).
    """

    indptr: np.ndarray
    indices: np.ndarray
    data: np.ndarray
    shape: Tuple[int, int]

    @property
    def nnz(self) -> int:
        return int(self.indices.shape[0])

    @property
    def n_rows(self) -> int:
        return self.shape[0]

    @property
    def n_cols(self) -> int:
        return self.shape[1]

    def row_degrees(self) -> np.ndarray:
        return (self.indptr[1:] - self.indptr[:-1]).astype(np.int32)

    def max_row_nnz(self) -> int:
        if self.n_rows == 0:
            return 0
        return int(self.row_degrees().max(initial=0))

    def validate(self) -> None:
        assert self.indptr.shape == (self.n_rows + 1,)
        assert self.indptr[0] == 0 and self.indptr[-1] == self.nnz
        assert np.all(np.diff(self.indptr) >= 0), "indptr must be monotone"
        if self.nnz:
            assert self.indices.min() >= 0
            assert self.indices.max() < self.n_cols
        # sorted within rows
        for r in range(min(self.n_rows, 64)):  # spot check
            row = self.indices[self.indptr[r]:self.indptr[r + 1]]
            assert np.all(np.diff(row) >= 0), f"row {r} not sorted"


def coo_to_csr(rows: np.ndarray, cols: np.ndarray, vals: np.ndarray,
               shape: Tuple[int, int], *, sum_duplicates: bool = True) -> CSRMatrix:
    """Convert COO triples to CSR, sorting and (optionally) merging duplicates."""
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    vals = np.asarray(vals, dtype=np.float32)
    n_rows, n_cols = shape
    # sort by (row, col)
    key = rows * n_cols + cols
    order = np.argsort(key, kind="stable")
    rows, cols, vals, key = rows[order], cols[order], vals[order], key[order]
    if sum_duplicates and rows.size:
        uniq, inv = np.unique(key, return_inverse=True)
        merged = np.zeros(uniq.shape[0], dtype=np.float64)
        np.add.at(merged, inv, vals)
        rows = (uniq // n_cols).astype(np.int64)
        cols = (uniq % n_cols).astype(np.int64)
        vals = merged.astype(np.float32)
    indptr = np.zeros(n_rows + 1, dtype=np.int64)
    np.add.at(indptr, rows + 1, 1)
    indptr = np.cumsum(indptr)
    return CSRMatrix(indptr.astype(np.int32), cols.astype(np.int32),
                     vals.astype(np.float32), (n_rows, n_cols))


def csr_to_dense(A: CSRMatrix) -> np.ndarray:
    out = np.zeros(A.shape, dtype=np.float32)
    for r in range(A.n_rows):
        s, e = A.indptr[r], A.indptr[r + 1]
        out[r, A.indices[s:e]] = A.data[s:e]
    return out


def csr_transpose(A: CSRMatrix) -> CSRMatrix:
    """Transpose by round-tripping through COO."""
    rows = np.repeat(np.arange(A.n_rows, dtype=np.int64),
                     A.indptr[1:] - A.indptr[:-1])
    return coo_to_csr(A.indices.astype(np.int64), rows, A.data,
                      (A.n_cols, A.n_rows), sum_duplicates=False)


def add_self_loops(A: CSRMatrix, *, weight: float = 1.0) -> CSRMatrix:
    """Return A + weight * I (square matrices only). Existing diagonals are summed."""
    assert A.n_rows == A.n_cols, "self loops need a square matrix"
    rows = np.repeat(np.arange(A.n_rows, dtype=np.int64),
                     A.indptr[1:] - A.indptr[:-1])
    diag = np.arange(A.n_rows, dtype=np.int64)
    rows = np.concatenate([rows, diag])
    cols = np.concatenate([A.indices.astype(np.int64), diag])
    vals = np.concatenate([A.data, np.full(A.n_rows, weight, np.float32)])
    return coo_to_csr(rows, cols, vals, A.shape, sum_duplicates=True)


def sym_normalize(A: CSRMatrix) -> CSRMatrix:
    """GCN normalization:  D^{-1/2} (A) D^{-1/2}  (Kipf & Welling, Eq. 3).

    Call after `add_self_loops` to obtain \\hat{D}^{-1/2} \\hat{A} \\hat{D}^{-1/2}.
    """
    assert A.n_rows == A.n_cols
    deg = np.zeros(A.n_rows, dtype=np.float64)
    rows = np.repeat(np.arange(A.n_rows), A.indptr[1:] - A.indptr[:-1])
    np.add.at(deg, rows, A.data)  # weighted out-degree
    # for symmetric graphs in-degree == out-degree; use row sums as \hat{D}
    dinv = np.where(deg > 0, 1.0 / np.sqrt(deg), 0.0)
    data = A.data * dinv[rows] * dinv[A.indices]
    return CSRMatrix(A.indptr.copy(), A.indices.copy(),
                     data.astype(np.float32), A.shape)


def make_undirected(rows: np.ndarray, cols: np.ndarray,
                    n: int) -> Tuple[np.ndarray, np.ndarray]:
    """Symmetrize an edge list (and drop duplicate edges)."""
    r = np.concatenate([rows, cols])
    c = np.concatenate([cols, rows])
    key = r.astype(np.int64) * n + c
    _, idx = np.unique(key, return_index=True)
    return r[idx], c[idx]
