"""Synthetic graph generation.

The container has no network access, so the paper's datasets (ogbn-products,
Reddit, Isolate-3-8M, Products-14M, ogbn-papers100M) are replaced by synthetic
stand-ins whose *labels are learnable from graph structure*, so that sampling-
accuracy comparisons (paper Table I / Fig. 6) are meaningful:

- SBM (stochastic block model) graphs: communities = classes. A GNN that
  aggregates neighborhoods can recover the community far better than an MLP on
  features alone, because intra-community edges dominate. Features are noisy
  community prototypes, so *both* feature and structure signal exist, as in
  real node-classification benchmarks.
- RMAT graphs: power-law degree structure for scaling/perf benchmarks (labels
  assigned by degree bucket, mirroring the paper's synthetic-feature protocol
  for Isolate-3-8M / Products-14M).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from repro_torch.graphs.csr import (CSRMatrix, add_self_loops, coo_to_csr,
                                    csr_transpose, make_undirected,
                                    sym_normalize)


@dataclasses.dataclass
class SyntheticDataset:
    """A ready-to-train node-classification dataset."""

    name: str
    adj_norm: CSRMatrix          # \hat{D}^{-1/2} \hat{A} \hat{D}^{-1/2}
    adj_norm_t: CSRMatrix        # its transpose (for backward SpMM)
    features: np.ndarray         # (N, d_in) float32
    labels: np.ndarray           # (N,) int32
    train_mask: np.ndarray       # (N,) bool
    val_mask: np.ndarray
    test_mask: np.ndarray
    num_classes: int

    @property
    def num_vertices(self) -> int:
        return self.adj_norm.n_rows

    @property
    def num_edges(self) -> int:
        return self.adj_norm.nnz

    @property
    def feature_dim(self) -> int:
        return int(self.features.shape[1])


def make_sbm_graph(n: int, num_blocks: int, p_in: float, p_out: float,
                   seed: int = 0) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Stochastic block model. Returns (rows, cols, block_of_vertex).

    Edges are sampled with expected degree ~ p_in*(n/k) + p_out*(n - n/k),
    using a fast per-block pair-sampling scheme rather than an O(n^2) Bernoulli
    sweep, so n up to ~1e6 is fine on CPU.
    """
    rng = np.random.default_rng(seed)
    block = rng.integers(0, num_blocks, size=n).astype(np.int32)
    order = np.argsort(block, kind="stable")
    block_sorted = block[order]
    starts = np.searchsorted(block_sorted, np.arange(num_blocks))
    ends = np.searchsorted(block_sorted, np.arange(num_blocks), side="right")

    rows_parts, cols_parts = [], []

    def sample_pairs(src_ids, dst_ids, p):
        n_src, n_dst = len(src_ids), len(dst_ids)
        total = n_src * n_dst
        if total == 0 or p <= 0:
            return
        m = rng.binomial(total, min(p, 1.0))
        if m == 0:
            return
        flat = rng.integers(0, total, size=m)
        rows_parts.append(src_ids[flat // n_dst])
        cols_parts.append(dst_ids[flat % n_dst])

    for bi in range(num_blocks):
        ids_i = order[starts[bi]:ends[bi]]
        sample_pairs(ids_i, ids_i, p_in)
        for bj in range(bi + 1, num_blocks):
            ids_j = order[starts[bj]:ends[bj]]
            sample_pairs(ids_i, ids_j, p_out)

    if rows_parts:
        rows = np.concatenate(rows_parts)
        cols = np.concatenate(cols_parts)
    else:
        rows = np.zeros(0, np.int64)
        cols = np.zeros(0, np.int64)
    keep = rows != cols  # no self loops here; added explicitly later
    rows, cols = make_undirected(rows[keep], cols[keep], n)
    return rows, cols, block


def make_rmat_graph(n: int, avg_degree: int, seed: int = 0,
                    a: float = 0.57, b: float = 0.19,
                    c: float = 0.19) -> Tuple[np.ndarray, np.ndarray]:
    """RMAT/Kronecker power-law graph. n must be a power of two (padded if not)."""
    rng = np.random.default_rng(seed)
    scale = int(np.ceil(np.log2(max(n, 2))))
    n_pad = 1 << scale
    m = n * avg_degree // 2
    probs = np.array([a, b, c, 1.0 - a - b - c])
    rows = np.zeros(m, dtype=np.int64)
    cols = np.zeros(m, dtype=np.int64)
    for level in range(scale):
        quad = rng.choice(4, size=m, p=probs)
        rows |= ((quad >> 1) & 1).astype(np.int64) << level
        cols |= (quad & 1).astype(np.int64) << level
    keep = (rows < n) & (cols < n) & (rows != cols)
    rows, cols = make_undirected(rows[keep], cols[keep], n)
    del n_pad
    return rows, cols


def _features_from_labels(labels: np.ndarray, num_classes: int, d_in: int,
                          noise: float, rng: np.random.Generator) -> np.ndarray:
    prototypes = rng.normal(size=(num_classes, d_in)).astype(np.float32)
    feats = prototypes[labels] + noise * rng.normal(
        size=(labels.shape[0], d_in)).astype(np.float32)
    return feats.astype(np.float32)


def _split_masks(n: int, rng: np.random.Generator,
                 train_frac=0.6, val_frac=0.2):
    perm = rng.permutation(n)
    n_train = int(train_frac * n)
    n_val = int(val_frac * n)
    train = np.zeros(n, bool)
    val = np.zeros(n, bool)
    test = np.zeros(n, bool)
    train[perm[:n_train]] = True
    val[perm[n_train:n_train + n_val]] = True
    test[perm[n_train + n_val:]] = True
    return train, val, test


def make_synthetic_dataset(
    name: str = "sbm-small",
    n: int = 4096,
    num_classes: int = 8,
    d_in: int = 64,
    kind: str = "sbm",
    avg_degree: int = 16,
    feature_noise: float = 2.0,
    p_in_out_ratio: float = 8.0,
    seed: int = 0,
) -> SyntheticDataset:
    """Build a complete node-classification dataset.

    For `kind="sbm"`, labels are the SBM communities; `feature_noise` controls
    how much a structure-blind model is handicapped. For `kind="rmat"`, labels
    are degree buckets (the paper's protocol for datasets without labels).
    """
    rng = np.random.default_rng(seed + 1)
    if kind == "sbm":
        # choose p_in/p_out to hit the requested average degree
        k = num_classes
        # avg_deg = p_in*(n/k) + p_out*(n - n/k); p_in = ratio * p_out
        ratio = p_in_out_ratio
        p_out = avg_degree / (ratio * (n / k) + (n - n / k))
        p_in = ratio * p_out
        rows, cols, block = make_sbm_graph(n, k, p_in, p_out, seed=seed)
        labels = block.astype(np.int32)
    elif kind == "rmat":
        rows, cols = make_rmat_graph(n, avg_degree, seed=seed)
        deg = np.zeros(n, np.int64)
        np.add.at(deg, rows, 1)
        # degree-bucket labels (paper §VI-C: classes proportional to degree)
        qs = np.quantile(deg, np.linspace(0, 1, num_classes + 1)[1:-1])
        labels = np.searchsorted(qs, deg).astype(np.int32)
    else:
        raise ValueError(f"unknown graph kind: {kind}")

    vals = np.ones(rows.shape[0], np.float32)
    A = coo_to_csr(rows, cols, vals, (n, n))
    A_hat = sym_normalize(add_self_loops(A))
    A_hat_t = csr_transpose(A_hat)
    feats = _features_from_labels(labels, num_classes, d_in, feature_noise, rng)
    train, val, test = _split_masks(n, rng)
    return SyntheticDataset(
        name=name, adj_norm=A_hat, adj_norm_t=A_hat_t, features=feats,
        labels=labels, train_mask=train, val_mask=val, test_mask=test,
        num_classes=num_classes)
