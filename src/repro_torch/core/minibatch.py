"""Mini-batch construction — the one owner of Alg. 2 end to end.

Counterpart of ``repro/core/minibatch.py``: the ``BlockFormat`` enum, the
``Minibatch`` one training step consumes, and a ``MinibatchBuilder`` that
owns sampling (phase 1: mode ``exact`` |
``stratified`` | ``partition`` | ``walk``, schedule ``step`` | ``epoch``, the
sample a pure function of ``(seed, epoch, step, dp_index)``), the rescale
(Eq. 23-24: a scalar per block pair, or the locality modes' per-pair
matrix) and block extraction (phases 2-4) in the configured format and
backend:

* ``"torch"`` — ``core.sampling.extract_dense_block`` /
  ``extract_block_ell`` (COO triples bounded by ``e_cap``), the reference;
* ``"cuda"``  — the fused dense kernel ``kernels.extract_gather`` (edges
  bounded per row by ``max_row_nnz``), followed for the ELL format by
  ``kernels.spmm_ell.dense_to_block_ell_ranked``; its plain PyTorch
  version runs for CPU tensors.

Both backends give identical blocks in both formats and both block types
(``block_dtype`` float32 or bfloat16: the values are computed in float32
and rounded once at the end, as the reference's fused kernel does; on
graphs without duplicate edges the bf16 block is the float32 block's cast).
The fused kernel
rescales by a scalar or per column only, so the locality modes, whose
rescale is per pair, need ``"torch"``, as the reference's need its
``"jax"`` backend; a per-pair rescale inside the kernel is ROADMAP queue
1, "the per-pair rescale inside the extraction kernel". Walk mode's
replicated tables (``{"nbr", "p"}``) reach the sampler as ``aux``.

``build_local`` is the training call on one rank of the 4D mesh: the
rank's block of each rotation plane (``extract_plane_blocks``, with no
communication) and its feature and label rows; ``build`` is the same
call on the 1x1x1x1 mesh.
``assemble`` is the serving call.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Any, Mapping, Optional, Sequence, Tuple, Union

import torch

from repro_torch.core import pmm3d
from repro_torch.core import sampling as smp
from repro_torch.device import resolve_device
from repro_torch.obs.tracer import phase

# the coordinates of the single-device step
SINGLE = {"d": 0, "x": 0, "y": 0, "z": 0}
MODES = ("exact", "stratified", "partition", "walk")


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
    """One constructed mini-batch on one rank: the adjacency block of each
    rotation plane (a dense tensor or a block-ELL (tiles, colidx) pair; a
    plane whose block another plane already holds shares it), the local
    feature rows on plane (x, z) and the label rows over the final row
    axis."""

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
    mode: str = "stratified"          # 'stratified' | 'exact' |
                                      # 'partition' | 'walk'
    schedule: str = "step"            # 'step' | 'epoch' (without-replacement)
    fmt: BlockFormat = BlockFormat.DENSE
    impl: str = "torch"               # 'torch' | 'cuda'
    block_dtype: torch.dtype = torch.float32  # of the extracted blocks
    ell_tile: int = 128               # (bm = bn) tile side
    ell_slots: int = 16               # max nonzero col-tiles per row-block
    max_row_nnz: int = 0              # per-row nnz bound (cuda)
    seed: int = 0

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(f"mode={self.mode!r}: one of {MODES}")
        if self.schedule not in ("step", "epoch"):
            raise ValueError(f"schedule={self.schedule!r}: 'step' | 'epoch'")
        if self.impl not in ("torch", "cuda"):
            raise ValueError(f"impl={self.impl!r}: 'torch' | 'cuda'")
        self.scfg.validate()
        if self.mode == "partition" and self.scfg.clusters <= 0:
            raise ValueError(
                "partition mode needs SampleConfig.clusters: partition the "
                "graph with build_partitioned_graph(..., clusters=C)")
        if self.mode == "walk" and (self.scfg.walk_len <= 0
                                    or self.scfg.walk_k <= 0):
            raise ValueError("walk mode needs SampleConfig.walk_len and "
                             "walk_k (the table of graphs.build_walk_tables)")
        if self.mode in ("partition", "walk") and self.impl == "cuda":
            raise ValueError(
                f"{self.mode} mode rescales per pair of vertices (a (b, b) "
                "matrix), which the fused extraction kernel does not: use "
                "extract_impl='torch', as the reference needs 'jax' "
                '(ROADMAP queue 1, "the per-pair rescale inside the '
                'extraction kernel")')
        if self.block_dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"block_dtype={self.block_dtype}: float32 or "
                             "bfloat16")
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
                   impl=opts.extract_impl,
                   block_dtype=(torch.bfloat16 if opts.block_dtype == "bf16"
                                else torch.float32),
                   ell_tile=opts.ell_tile, ell_slots=opts.ell_slots,
                   max_row_nnz=max_row_nnz, seed=opts.seed)

    # -- phase 1: sampling ---------------------------------------------------

    @property
    def steps_per_epoch(self) -> int:
        return self.scfg.steps_per_epoch

    def epoch_of(self, step: smp.Key) -> smp.Key:
        """The epoch a global step falls in (boundaries at fixed multiples
        of ``steps_per_epoch``): an int for an int step, a floor division
        on the device for a device step."""
        if isinstance(step, torch.Tensor):
            return torch.div(step, self.steps_per_epoch,
                             rounding_mode="floor")
        return int(step) // self.steps_per_epoch

    def sample(self, key: torch.Tensor, t: Optional[smp.Key] = None,
               aux: Optional[Mapping[str, torch.Tensor]] = None
               ) -> torch.Tensor:
        """(g, b) global vertex ids — sampling-mode dispatch. ``key`` is the
        0-d int64 key (``sampling.key_tensor``) on the device that draws;
        ``t`` is the step within the epoch (required under the 'epoch'
        schedule, where ``key`` is the epoch key; ignored under 'step');
        ``aux`` carries walk mode's replicated tables."""
        epoch = self.schedule == "epoch"
        if epoch and t is None:
            raise ValueError("the epoch schedule needs the in-epoch step")
        if self.mode == "walk":
            if aux is None:
                raise ValueError("walk mode needs its tables (aux)")
            return smp.sample_walk_stratified(key, self.scfg, aux["nbr"],
                                              t=t if epoch else None)
        if self.mode == "partition":
            return smp.sample_partition_epoch(key, self.scfg,
                                              t if epoch else 0)
        if epoch:
            if self.mode == "exact":
                return smp.sample_epoch_exact(key, self.scfg.n_pad,
                                              self.scfg.batch, t)[None]
            return smp.sample_epoch_stratified(key, self.scfg, t)
        if self.mode == "exact":
            return smp.sample_uniform_exact(key, self.scfg.n_pad,
                                            self.scfg.batch)[None]
        return smp.sample_stratified(key, self.scfg)

    def sample_ids(self, step: smp.Key, epoch: Optional[smp.Key],
                   dp_index: int, *,
                   device: Union[str, torch.device, None] = None,
                   aux: Optional[Mapping[str, torch.Tensor]] = None
                   ) -> torch.Tensor:
        """The (g, b) sample as a pure function of ``(seed, epoch, step,
        dp_index)``: per-step key under 'step', epoch-permutation slice
        under 'epoch'. Python counters draw on ``device`` (the card by
        default); a step or epoch that is a device tensor (a ``TrainState``
        counter) draws on its own device, which derives the key itself: no
        counter is read on the host.

        Partition + epoch with ``dp_groups > 1`` is special: the DP groups
        share the un-folded epoch key and take interleaved slices of one
        cluster permutation, so together they cover every cluster once per
        epoch, disjointly."""
        counters = [c for c in (step, epoch) if isinstance(c, torch.Tensor)]
        dev = counters[0].device if counters else resolve_device(device)
        if self.schedule == "epoch":
            if epoch is None:
                epoch = self.epoch_of(step)
            t = step - epoch * self.steps_per_epoch
            if self.mode == "partition" and self.scfg.dp_groups > 1:
                key = smp.key_tensor(smp.epoch_key(self.seed, epoch, 0), dev)
                return smp.sample_partition_epoch(key, self.scfg, t,
                                                  dp_slot=dp_index)
            key = smp.epoch_key(self.seed, epoch, dp_index)
            return self.sample(smp.key_tensor(key, dev), t, aux)
        return self.sample(smp.key_tensor(
            smp.step_key(self.seed, step, dp_index), dev), aux=aux)

    def rescale_constants(self) -> Tuple[float, float]:
        """(1/p_same, 1/p_cross): Eq. 23, range-dependent under
        stratification, the paper's single constant in exact mode."""
        if self.mode == "exact":
            n, b = self.scfg.n_pad, self.scfg.batch
            inv = (n - 1) / (b - 1) if b > 1 else 1.0
            return inv, inv
        return smp.rescale_constants(self.scfg)

    def col_scale_fn(self, s2d: torch.Tensor,
                     aux: Optional[Mapping[str, torch.Tensor]] = None):
        """The off-diagonal rescale as an ``(i, j) -> scale`` closure over
        the (g, b) sample: a scalar per block pair for exact and stratified
        (Eq. 23); a (b, b) per-pair matrix for partition (within a cluster,
        across clusters, across ranges) and walk (SAINT's 1/q_uv, from
        ``aux["p"]``)."""
        if self.mode == "partition":
            inv_cc, inv_cr = smp.partition_rescale_constants(self.scfg)
            return lambda i, j: smp.partition_col_scale(
                s2d[i], s2d[j], i, j, self.scfg, inv_cc, inv_cr)
        if self.mode == "walk":
            return lambda i, j: smp.walk_col_scale(s2d[i], s2d[j], aux["p"])
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
        """Extract ONE rescaled block in the configured format, backend and
        type (``block_dtype``): a dense ``(b_r, b_c)`` tensor or a
        block-ELL ``(tiles, colidx)`` pair. ``col_scale`` is the
        off-diagonal rescale, a scalar
        (training, Eq. 23), a (b_c,) per-column tensor (serving) or a
        (b_r, b_c) per-pair matrix (the locality modes: ``"torch"`` only);
        ``diag``
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
                diag=diag, max_deg=self.max_row_nnz, dtype=self.block_dtype)
            if fmt is BlockFormat.DENSE:
                return dense
            from repro_torch.kernels.spmm_ell import dense_to_block_ell_ranked
            return dense_to_block_ell_ranked(dense, self.ell_tile,
                                             self.ell_tile, self.ell_slots)
        if fmt is BlockFormat.ELL:
            return smp.extract_block_ell(
                rp, ci, val, rows_local, cols_local, e_cap,
                rescale_offdiag=col_scale, is_diag_block=diag,
                bm=self.ell_tile, bn=self.ell_tile, n_slots=self.ell_slots,
                dtype=self.block_dtype)
        return smp.extract_dense_block(
            rp, ci, val, rows_local, cols_local, e_cap,
            rescale_offdiag=col_scale, is_diag_block=diag,
            dtype=self.block_dtype)

    # -- the training path (one rank of the mesh) ----------------------------

    def extract_plane_blocks(self, planes: Sequence[Tuple[Any, Any, Any]],
                             ids2d: torch.Tensor, num_layers: int,
                             coords: Mapping[str, int], *, col_scale_fn,
                             fmt: Optional[BlockFormat] = None
                             ) -> Tuple[Any, ...]:
        """The rotation-plane extraction: for each of the first ``min(3,
        num_layers)`` planes this rank extracts its (i, j) block of the
        batch adjacency from ``planes[l]``, the CSR block of that plane
        (``ids2d`` is the (g, b) sample, i and j the rank's coordinates on
        the plane's two axes). Planes with the same (i, j) hold the same
        block, which is extracted once (every plane at g = 1)."""
        n_loc = self.scfg.n_local
        st = pmm3d.initial_state()
        done, blocks = {}, []
        for li in range(min(3, num_layers)):
            i, j = (coords[a] for a in st.adj_plane)     # (p, r)
            if (i, j) not in done:
                rp, ci, val = planes[li]
                done[(i, j)] = self.extract_block(
                    rp, ci, val, ids2d[i] - i * n_loc, ids2d[j] - j * n_loc,
                    col_scale=col_scale_fn(i, j), diag=i == j, fmt=fmt)
            blocks.append(done[(i, j)])
            st = st.rotate()
        return tuple(blocks)

    def local_rows(self, rows_local: torch.Tensor, ids2d: torch.Tensor,
                   index: int) -> torch.Tensor:
        """The rows of this rank's shard of per-vertex rows (features,
        labels) that belong to the batch: range ``index``'s sample."""
        return rows_local[(ids2d[index] - index * self.scfg.n_local).long()]

    def build_local(self, planes: Sequence[Tuple[Any, Any, Any]],
                    feats_loc: torch.Tensor, labels_loc: torch.Tensor,
                    step: smp.Key, num_layers: int,
                    coords: Mapping[str, int], *,
                    epoch: Optional[smp.Key] = None,
                    ids: Optional[torch.Tensor] = None,
                    aux: Optional[Mapping[str, torch.Tensor]] = None
                    ) -> Minibatch:
        """Alg. 2 on one rank, with no communication: sample from ``(seed,
        epoch, step, coords["d"])`` (Python counters or device tensors,
        which no host reads) — or take the (g, b) ``ids`` of this rank's DP
        group — then extract the rank's block of each rotation
        plane, and slice its feature rows (on plane (x, z)) and label rows
        (over the final row axis). ``aux`` holds walk mode's replicated
        tables (``{"nbr", "p"}``), so its gathers stay on the rank."""
        with phase("sample"):
            s2d = (self.sample_ids(step, epoch, coords["d"],
                                   device=feats_loc.device, aux=aux)
                   if ids is None else ids)
        with phase("extract"):
            blocks = self.extract_plane_blocks(
                planes, s2d, num_layers, coords,
                col_scale_fn=self.col_scale_fn(s2d, aux))
            r_f = pmm3d.state_after_layers(num_layers).row
            return Minibatch(
                adj=blocks,
                feats=self.local_rows(feats_loc, s2d, coords["x"]),
                labels=self.local_rows(labels_loc, s2d, coords[r_f]))

    def build(self, rp: torch.Tensor, ci: torch.Tensor, val: torch.Tensor,
              features: torch.Tensor, labels: torch.Tensor, step: smp.Key,
              *, epoch: Optional[smp.Key] = None, dp_index: int = 0,
              ids: Optional[torch.Tensor] = None,
              aux: Optional[Mapping[str, torch.Tensor]] = None
              ) -> Minibatch:
        """:meth:`build_local` on the 1x1x1x1 mesh (DP group
        ``dp_index``): the batch's one block, features and labels."""
        if self.scfg.g != 1:
            raise ValueError(f"g={self.scfg.g}: a rank of the mesh builds "
                             "its batch with build_local")
        return self.build_local(((rp, ci, val),), features, labels, step, 1,
                                dict(SINGLE, d=dp_index), epoch=epoch,
                                ids=ids, aux=aux)

    def build_single(self, key: torch.Tensor, rp: torch.Tensor,
                     ci: torch.Tensor, val: torch.Tensor,
                     features: torch.Tensor,
                     labels: torch.Tensor) -> smp.MiniBatch:
        """One-device dense batch in the configured sampling mode
        (Alg. 1), drawn from ``key``."""
        if self.mode not in ("exact", "stratified"):
            raise ValueError(
                f"build_single supports the Alg. 1 modes; {self.mode} mode "
                "builds on a rank of the mesh (build_local)")
        if self.mode == "exact":
            s = self.sample(key)[0]
            inv_p, _ = self.rescale_constants()
            adj = self.extract_block(rp, ci, val, s, s, col_scale=inv_p,
                                     diag=True, fmt=BlockFormat.DENSE)
            return smp.MiniBatch(adj=adj, feats=features[s.long()],
                                 labels=labels[s.long()], vertex_ids=s)
        return smp.make_minibatch_stratified(key, rp, ci, val, features,
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
