"""Mini-batch construction — the single-device owner of Alg. 2 end to end.

Counterpart of ``repro/core/minibatch.py`` for one device: the
``BlockFormat`` enum, the ``Minibatch`` one training step consumes, and a
``MinibatchBuilder`` that owns sampling (phase 1: mode ``exact`` |
``stratified``, schedule ``step`` | ``epoch``, the sample a pure function
of ``(seed, epoch, step, dp_index)``), the rescale constants (Eq. 23-24)
and block extraction (phases 2-4) in the configured format and backend:

* ``"torch"`` — ``core.sampling.extract_dense_block`` /
  ``extract_block_ell`` (COO triples bounded by ``e_cap``), the reference;
* ``"cuda"``  — the fused dense kernel ``kernels.extract_gather`` (edges
  bounded per row by ``max_row_nnz``), followed for the ELL format by
  ``kernels.spmm_ell.dense_to_block_ell_ranked``; its plain PyTorch
  version runs for CPU tensors.

Both backends give identical blocks in both formats. ``build`` is the
training call at g = 1; the per-plane loop of the 4D step is ROADMAP
queue 1, item 3. ``assemble`` is the serving call.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Any, Optional, Tuple, Union

import torch

from repro_torch.core import sampling as smp
from repro_torch.device import resolve_device
from repro_torch.obs.tracer import phase

_MESH = "ROADMAP queue 1, item 3 (4D distributed step)"


class BlockFormat(enum.Enum):
    """Layout of an extracted mini-batch adjacency block."""

    DENSE = "dense"
    ELL = "ell"

    @classmethod
    def from_spmm_impl(cls, impl: str) -> "BlockFormat":
        """Map ``TrainOptions.spmm_impl`` ('dense' | 'ell')."""
        return cls(impl)


@dataclasses.dataclass(frozen=True)
class Minibatch:
    """One constructed mini-batch: the adjacency blocks (one at g = 1: a
    dense tensor or a block-ELL (tiles, colidx) pair), the batch's feature
    rows and label rows."""

    adj: Tuple[Any, ...]
    feats: torch.Tensor
    labels: torch.Tensor


@dataclasses.dataclass(frozen=True)
class MinibatchBuilder:
    """Owns every decision between 'a seed/step or vertex set' and 'the
    block the model consumes'. ``impl='cuda'`` requires ``max_row_nnz``
    (the per-row edge bound, e.g. ``PartitionedGraph.max_block_row_nnz``):
    the fused kernel walks each row's edges up to it instead of using the
    COO-level ``e_cap``."""

    scfg: smp.SampleConfig
    mode: str = "stratified"          # 'stratified' | 'exact'
    schedule: str = "step"            # 'step' | 'epoch' (without-replacement)
    fmt: BlockFormat = BlockFormat.DENSE
    impl: str = "torch"               # 'torch' | 'cuda'
    ell_tile: int = 128               # (bm = bn) tile side
    ell_slots: int = 16               # max nonzero col-tiles per row-block
    max_row_nnz: int = 0              # per-row nnz bound (cuda)
    seed: int = 0

    def __post_init__(self):
        if self.mode in ("partition", "walk"):
            raise NotImplementedError(
                f"mode={self.mode!r} is {smp._LOCALITY}")
        if self.mode not in ("exact", "stratified"):
            raise ValueError(f"mode={self.mode!r}: 'exact' | 'stratified'")
        if self.schedule not in ("step", "epoch"):
            raise ValueError(f"schedule={self.schedule!r}: 'step' | 'epoch'")
        if self.impl not in ("torch", "cuda"):
            raise ValueError(f"impl={self.impl!r}: 'torch' | 'cuda'")
        self.scfg.validate()
        if self.impl == "cuda" and self.max_row_nnz <= 0:
            raise ValueError("the fused extraction needs the per-row edge "
                             "bound (max_row_nnz)")

    @classmethod
    def from_options(cls, scfg: smp.SampleConfig, opts,
                     max_row_nnz: int = 0) -> "MinibatchBuilder":
        """Build from ``forward.TrainOptions`` (duck-typed)."""
        return cls(scfg=scfg, mode=opts.sample_kind,
                   schedule=opts.sample_mode,
                   fmt=BlockFormat.from_spmm_impl(opts.spmm_impl),
                   impl=opts.extract_impl, ell_tile=opts.ell_tile,
                   ell_slots=opts.ell_slots, max_row_nnz=max_row_nnz,
                   seed=opts.seed)

    # -- phase 1: sampling ---------------------------------------------------

    @property
    def steps_per_epoch(self) -> int:
        return self.scfg.steps_per_epoch

    def epoch_of(self, step: int) -> int:
        """The epoch a global step falls in (boundaries at fixed multiples
        of ``steps_per_epoch``)."""
        return int(step) // self.steps_per_epoch

    def sample(self, gen: torch.Generator,
               t: Optional[int] = None) -> torch.Tensor:
        """(g, b) global vertex ids — sampling-mode dispatch. ``t`` is the
        step within the epoch (required under the 'epoch' schedule, where
        ``gen`` is seeded with the epoch key; ignored under 'step')."""
        if self.schedule == "epoch":
            if t is None:
                raise ValueError("the epoch schedule needs the in-epoch step")
            if self.mode == "exact":
                return smp.sample_epoch_exact(gen, self.scfg.n_pad,
                                              self.scfg.batch, t)[None]
            return smp.sample_epoch_stratified(gen, self.scfg, t)
        if self.mode == "exact":
            return smp.sample_uniform_exact(gen, self.scfg.n_pad,
                                            self.scfg.batch)[None]
        return smp.sample_stratified(gen, self.scfg)

    def sample_ids(self, step: int, epoch: Optional[int], dp_index: int,
                   *, device: Union[str, torch.device, None] = None
                   ) -> torch.Tensor:
        """The (g, b) sample as a pure function of ``(seed, epoch, step,
        dp_index)``, drawn on ``device`` (the card by default): per-step key
        under 'step', epoch-permutation slice under 'epoch'."""
        dev = resolve_device(device)
        step = int(step)
        if self.schedule == "epoch":
            epoch = self.epoch_of(step) if epoch is None else int(epoch)
            t = step - epoch * self.steps_per_epoch
            gen = smp.make_generator(smp.epoch_key(self.seed, epoch,
                                                   dp_index), dev)
            return self.sample(gen, t)
        return self.sample(smp.make_generator(
            smp.step_key(self.seed, step, dp_index), dev))

    def rescale_constants(self) -> Tuple[float, float]:
        """(1/p_same, 1/p_cross): Eq. 23, range-dependent under
        stratification, the paper's single constant in exact mode."""
        if self.mode == "exact":
            n, b = self.scfg.n_pad, self.scfg.batch
            inv = (n - 1) / (b - 1) if b > 1 else 1.0
            return inv, inv
        return smp.rescale_constants(self.scfg)

    def col_scale_fn(self, s2d: torch.Tensor):
        """The off-diagonal rescale as an ``(i, j) -> scale`` closure over
        the (g, b) sample: a scalar per block pair (Eq. 23)."""
        del s2d                       # the exact/stratified scale is per pair
        inv_same, inv_cross = self.rescale_constants()
        return lambda i, j: smp.stratified_col_scale(i, j, inv_same,
                                                     inv_cross)

    # -- phases 2-4: block extraction ---------------------------------------

    def extract_block(self, rp: torch.Tensor, ci: torch.Tensor,
                      val: torch.Tensor, rows_local: torch.Tensor,
                      cols_local: torch.Tensor, *,
                      col_scale: Union[torch.Tensor, float], diag: bool,
                      e_cap: Optional[int] = None,
                      fmt: Optional[BlockFormat] = None):
        """Extract ONE rescaled float32 block in the configured format and
        backend: a dense ``(b_r, b_c)`` tensor or a block-ELL ``(tiles,
        colidx)`` pair. ``col_scale`` is the off-diagonal rescale, a scalar
        (training, Eq. 23) or a (b_c,) per-column tensor (serving); ``diag``
        marks coinciding row/column vertex sets, enabling the Eq. 24
        self-loop exemption."""
        e_cap = self.scfg.e_cap if e_cap is None else e_cap
        fmt = self.fmt if fmt is None else fmt
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
            dense = extract_dense_fused(
                rp, ci, val, rows_local, cols_local, col_scale=col_scale,
                diag=diag, max_deg=self.max_row_nnz)
            if fmt is BlockFormat.DENSE:
                return dense
            from repro_torch.kernels.spmm_ell import dense_to_block_ell_ranked
            return dense_to_block_ell_ranked(dense, self.ell_tile,
                                             self.ell_tile, self.ell_slots)
        if fmt is BlockFormat.ELL:
            return smp.extract_block_ell(
                rp, ci, val, rows_local, cols_local, e_cap,
                rescale_offdiag=col_scale, is_diag_block=diag,
                bm=self.ell_tile, bn=self.ell_tile, n_slots=self.ell_slots)
        return smp.extract_dense_block(
            rp, ci, val, rows_local, cols_local, e_cap,
            rescale_offdiag=col_scale, is_diag_block=diag)

    # -- the single-device training path -------------------------------------

    def build(self, rp: torch.Tensor, ci: torch.Tensor, val: torch.Tensor,
              features: torch.Tensor, labels: torch.Tensor, step: int, *,
              epoch: Optional[int] = None, dp_index: int = 0,
              ids: Optional[torch.Tensor] = None) -> Minibatch:
        """Alg. 2 on one device (the reference's ``build_local`` at g = 1):
        sample from ``(seed, epoch, step, dp_index)`` — or take the (1, b)
        ``ids`` given — then extract the batch's block and slice its
        features and labels. At g = 1 the three rotation planes of the 4D
        step hold the same block, so it is extracted once and serves every
        layer."""
        if self.scfg.g != 1:
            raise NotImplementedError(
                f"g={self.scfg.g}: the per-plane extraction of the mesh is "
                f"{_MESH}")
        with phase("sample"):
            s2d = (self.sample_ids(step, epoch, dp_index, device=rp.device)
                   if ids is None else ids)
        s = s2d[0]
        with phase("extract"):
            blk = self.extract_block(rp, ci, val, s, s,
                                     col_scale=self.col_scale_fn(s2d)(0, 0),
                                     diag=True)
            return Minibatch(adj=(blk,), feats=features[s.long()],
                             labels=labels[s.long()])

    def build_single(self, gen: torch.Generator, rp: torch.Tensor,
                     ci: torch.Tensor, val: torch.Tensor,
                     features: torch.Tensor,
                     labels: torch.Tensor) -> smp.MiniBatch:
        """One-device dense batch in the configured sampling mode
        (Alg. 1)."""
        if self.mode == "exact":
            s = self.sample(gen)[0]
            inv_p, _ = self.rescale_constants()
            adj = self.extract_block(rp, ci, val, s, s, col_scale=inv_p,
                                     diag=True, fmt=BlockFormat.DENSE)
            return smp.MiniBatch(adj=adj, feats=features[s.long()],
                                 labels=labels[s.long()], vertex_ids=s)
        return smp.make_minibatch_stratified(gen, rp, ci, val, features,
                                             labels, self.scfg)

    # -- the serving path (arbitrary requested vertex sets) ------------------

    def assemble(self, rp: torch.Tensor, ci: torch.Tensor, val: torch.Tensor,
                 batch_ids: torch.Tensor, col_scale: torch.Tensor,
                 e_cap: Optional[int] = None) -> torch.Tensor:
        """Serving assembly: row and column sets coincide (diag block), the
        rescale is the planner's per-column vector (requested at p=1,
        support at p_support — ``serve/assembler.py``)."""
        return self.extract_block(rp, ci, val, batch_ids, batch_ids,
                                  col_scale=col_scale, diag=True,
                                  e_cap=e_cap, fmt=BlockFormat.DENSE)
