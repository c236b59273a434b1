"""Induced-subgraph extraction (ScaleGNN Alg. 2 phases 2-4) in PyTorch.

Counterpart of the extraction core of ``repro/core/sampling.py``
(``SampleConfig``, ``_extract_triples``, ``_edge_scale``,
``extract_dense_block``): the port's ``"torch"`` extraction backend and the
reference the fused CUDA kernel (``kernels/extract_gather.py``) is held
against. Phase 2 is the prefix-sum vectorized CSR row gather, phase 3 the
binary-search column membership filter + compact remap, phase 4 the
rescale/assembly into a dense ``(b_r, b_c)`` block. Static shapes
throughout: ``e_cap`` bounds the extracted edges, as in the JAX version.

The samplers (Alg. 1) and the block-ELL extraction come with the training
slice.
"""
from __future__ import annotations

from typing import NamedTuple, Union

import torch


class SampleConfig(NamedTuple):
    """Static sampling parameters (the fields the extraction needs; the
    locality-aware fields of the JAX version come with its samplers)."""

    n_pad: int          # padded vertex count (multiple of g)
    g: int              # grid side; 1 for single-device
    batch: int          # total mini-batch size B (multiple of g)
    e_cap: int          # static bound on extracted nnz per block

    @property
    def n_local(self) -> int:
        return self.n_pad // self.g

    @property
    def b_local(self) -> int:
        return self.batch // self.g

    def validate(self) -> "SampleConfig":
        """Reject a batch larger than the vertex set (it would under-fill
        the sample and bias the Eq. 23 rescale)."""
        if self.batch > self.n_pad:
            raise ValueError(f"batch={self.batch} exceeds the vertex count "
                             f"n_pad={self.n_pad}")
        if self.b_local > self.n_local:
            raise ValueError(f"per-range batch {self.b_local} exceeds the "
                             f"range size {self.n_local}")
        return self


def _extract_triples(rp, ci, val, rows_local, cols_local, e_cap):
    """Alg. 2 phases 2-3 (shared core): prefix-sum vectorized CSR row
    extraction + binary-search column membership filter.

    Returns (own, pos, member, v, col), each ``(e_cap,)``:
      own    — compact row index of each extracted slot
      pos    — compact column index (membership position)
      member — bool, slot is a real edge whose target is sampled
      v      — edge value
      col    — raw column id of each slot (local to the shard)
    """
    b_r = rows_local.shape[0]
    b_c = cols_local.shape[0]
    rows = rows_local.long()
    rp = rp.long()

    # Phase 2: per-row nnz -> prefix sum -> searchsorted back-map -> one
    # coalesced gather (paper Alg. 2 lines 6-10).
    r_cnt = rp[rows + 1] - rp[rows]
    pfx = torch.cumsum(r_cnt, 0)
    total = pfx[-1]
    slot = torch.arange(e_cap, dtype=torch.int64, device=rp.device)
    own = torch.searchsorted(pfx, slot, right=True)
    own = torch.clamp(own, 0, b_r - 1)
    row_start = pfx[own] - r_cnt[own]
    offset = slot - row_start
    src = rp[rows[own]] + offset
    valid = slot < total
    src = torch.where(valid, src, torch.zeros_like(src))
    col = ci[src]
    v = val[src]

    # Phase 3: membership + compact remap via one binary search
    # (paper Alg. 2 lines 11-14).
    pos = torch.searchsorted(cols_local, col.to(cols_local.dtype))
    pos = torch.clamp(pos, 0, b_c - 1)
    member = (cols_local[pos] == col) & valid
    return own, pos, member, v, col


def _edge_scale(rows_local, own, pos, col, rescale_offdiag, is_diag_block):
    """Phase-4 rescale factor per extracted slot (Eq. 24).

    ``rescale_offdiag`` is a scalar (one inclusion probability, Eq. 23) or
    a (b_c,) per-column tensor (serving: requested at p=1, support at
    p_support). ``is_diag_block`` marks that the row/column vertex sets
    coincide, so self-loops (local ids equal) stay unrescaled.
    """
    resc = torch.as_tensor(rescale_offdiag, dtype=torch.float32,
                           device=col.device)
    offdiag = resc[pos] if resc.dim() == 1 else resc.expand(col.shape)
    diag = bool(is_diag_block) & (rows_local.long()[own] == col)
    return torch.where(diag, torch.ones_like(offdiag), offdiag)


def extract_dense_block(
    rp: torch.Tensor,            # (n_local + 1,) int32 local row pointer
    ci: torch.Tensor,            # (e_pad,) int32 local col ids
    val: torch.Tensor,           # (e_pad,) float32
    rows_local: torch.Tensor,    # (b_r,) sorted local sampled row ids
    cols_local: torch.Tensor,    # (b_c,) sorted local sampled col ids
    e_cap: int,
    *,
    rescale_offdiag: Union[torch.Tensor, float] = 1.0,
    is_diag_block: bool = False,
) -> torch.Tensor:
    """Extract the dense (b_r, b_c) float32 sampled block of a CSR shard.

    ``e_cap`` must bound the total nnz of the sampled rows; entries beyond it
    are dropped (choose ``e_cap = b_r * max_row_nnz`` for exactness).
    Rescale semantics are in ``_edge_scale``.
    """
    b_r, b_c = rows_local.shape[0], cols_local.shape[0]
    out = torch.zeros((b_r, b_c), dtype=torch.float32,
                      device=rows_local.device)
    if ci.shape[0] == 0:                     # empty graph shard
        return out
    own, pos, member, v, col = _extract_triples(
        rp, ci, val, rows_local, cols_local, e_cap)
    scale = _edge_scale(rows_local, own, pos, col, rescale_offdiag,
                        is_diag_block)
    contrib = torch.where(member, v * scale, torch.zeros_like(v))
    return out.index_put_((own, pos), contrib, accumulate=True)
