"""Mini-batch construction — the single-device owner of Alg. 2 phases 2-4.

Counterpart of ``repro/core/minibatch.py`` for one device: the
``BlockFormat`` enum and a ``MinibatchBuilder`` whose ``extract_block``
assembles one rescaled dense block through the configured extraction
backend, and whose ``assemble`` is the serving call (row and column sets
coincide). Backends:

* ``"torch"`` — ``core.sampling.extract_dense_block`` (COO triples bounded
  by ``e_cap``, then a scatter), the reference;
* ``"cuda"``  — the fused kernel ``kernels.extract_gather`` (edges bounded
  per row by ``max_row_nnz``), whose plain PyTorch version runs for CPU
  tensors.

Sampling (Alg. 1), the block-ELL format and the distributed per-plane
extraction come with the training slices.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Union

import torch

from repro_torch.core import sampling as smp


class BlockFormat(enum.Enum):
    """Layout of an extracted mini-batch adjacency block."""

    DENSE = "dense"
    ELL = "ell"


@dataclasses.dataclass(frozen=True)
class MinibatchBuilder:
    """Owns the extraction backend between 'a vertex set' and 'the block
    the model consumes'. ``impl='cuda'`` requires ``max_row_nnz`` (the
    per-row edge bound, e.g. ``CSRMatrix.max_row_nnz()``): the fused kernel
    walks each row's edges up to it instead of using the COO-level
    ``e_cap``."""

    scfg: smp.SampleConfig
    fmt: BlockFormat = BlockFormat.DENSE
    impl: str = "torch"               # 'torch' | 'cuda'
    max_row_nnz: int = 0              # per-row nnz bound (cuda)

    def __post_init__(self):
        if self.impl not in ("torch", "cuda"):
            raise ValueError(f"impl={self.impl!r}: 'torch' | 'cuda'")
        if self.fmt is not BlockFormat.DENSE:
            raise NotImplementedError(
                "the block-ELL format comes with the spmm_ell kernel: "
                "ROADMAP queue 1, item 2 (single-device training)")
        self.scfg.validate()
        if self.impl == "cuda" and self.max_row_nnz <= 0:
            raise ValueError("the fused extraction needs the per-row edge "
                             "bound (max_row_nnz)")

    def extract_block(self, rp: torch.Tensor, ci: torch.Tensor,
                      val: torch.Tensor, rows_local: torch.Tensor,
                      cols_local: torch.Tensor, *,
                      col_scale: Union[torch.Tensor, float], diag: bool,
                      e_cap: Optional[int] = None) -> torch.Tensor:
        """Extract ONE rescaled dense float32 block. ``col_scale`` is the
        off-diagonal rescale, a scalar (training, Eq. 23) or a (b_c,)
        per-column tensor (serving); ``diag`` marks coinciding row/column
        vertex sets, enabling the Eq. 24 self-loop exemption."""
        e_cap = self.scfg.e_cap if e_cap is None else e_cap
        if self.impl == "cuda":
            # the fused kernel bounds edges per row (max_row_nnz), the torch
            # path in total (e_cap); they are equivalent only when neither
            # truncates — reject configs where the torch path would drop
            # edges
            if e_cap < rows_local.shape[0] * self.max_row_nnz:
                raise ValueError(
                    f"e_cap={e_cap} truncates ({rows_local.shape[0]} rows x "
                    f"max_row_nnz={self.max_row_nnz}): the fused kernel "
                    "would not, so the backends would diverge")
            from repro_torch.kernels.extract_gather import extract_dense_fused
            return extract_dense_fused(
                rp, ci, val, rows_local, cols_local, col_scale=col_scale,
                diag=diag, max_deg=self.max_row_nnz)
        return smp.extract_dense_block(
            rp, ci, val, rows_local, cols_local, e_cap,
            rescale_offdiag=col_scale, is_diag_block=diag)

    def assemble(self, rp: torch.Tensor, ci: torch.Tensor, val: torch.Tensor,
                 batch_ids: torch.Tensor, col_scale: torch.Tensor,
                 e_cap: Optional[int] = None) -> torch.Tensor:
        """Serving assembly: row and column sets coincide (diag block), the
        rescale is the planner's per-column vector (requested at p=1,
        support at p_support — ``serve/assembler.py``)."""
        return self.extract_block(rp, ci, val, batch_ids, batch_ids,
                                  col_scale=col_scale, diag=True,
                                  e_cap=e_cap)
