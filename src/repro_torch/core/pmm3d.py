"""Local sparse products of the 3D-PMM layer program.

Counterpart of ``repro/core/pmm3d.py``; this slice needs only
:func:`csr_spmm_local`, the aggregation of full-graph evaluation. The plane
state, the parallel RMSNorm/loss and the reshards come with the 4D step
(ROADMAP queue 1, item 3).
"""
from __future__ import annotations

import warnings

import torch


def csr_spmm_local(rp: torch.Tensor, ci: torch.Tensor, val: torch.Tensor,
                   h: torch.Tensor, n_rows: int) -> torch.Tensor:
    """Local sparse ``A @ H`` on a padded-CSR shard (full-graph eval, where
    densifying an (n_local, n_local) block would be wasteful).

    The reference gathers ``val[:, None] * h[ci]`` for every edge, which at
    the full ogbn-products stand-in is 55 M edges x 256 x 4 B = 56 GB; here
    the edges up to ``rp[-1]`` form a CSR tensor and one sparse product
    computes the same sum (the reference computes it outside any kernel
    too). Padding slots past ``rp[-1]`` carry no value and are left out."""
    if rp.shape[0] != n_rows + 1:
        raise ValueError(f"rp has {rp.shape[0]} entries for {n_rows} rows")
    nnz = int(rp[-1])
    with warnings.catch_warnings():       # "sparse CSR support is in beta"
        warnings.simplefilter("ignore", UserWarning)
        a = torch.sparse_csr_tensor(
            rp.to(torch.int64), ci[:nnz].to(torch.int64),
            val[:nnz].to(h.dtype), size=(n_rows, h.shape[0]),
            check_invariants=False)
    return a @ h
