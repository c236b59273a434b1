"""The ONE distributed layer-loop executor (ScaleGNN §III/§IV), its
training options and its dropout generators.

Counterpart of ``repro/core/forward.py``: ``TrainOptions`` (every field,
the same defaults except ``extract_impl``, which names the port's
backends), ``_dropout_key`` and ``ForwardEngine`` with its ``"none"``
overlap path. The engine runs the 3D-PMM layer program on this rank's
shards of a ``fourd.Mesh`` — input projection, L layers of [aggregate ->
GEMM -> residual reshard -> tail -> rotate], output head — with one
all-reduce per product (``core/pmm3d.py``). The aggregation backend is
``"dense"`` (a dense block, ``blk @ h``), ``"ell"`` (a block-ELL ``(tiles,
colidx)`` pair through the SpMM kernel) or ``"csr"`` (a padded-CSR triple
over the whole local shard: full-graph eval). The tail is plain PyTorch or
the fused CUDA kernel (``TrainOptions.fused_elementwise``): fully fused
when the feature dim is whole on the rank (g = 1, or RMSNorm off), else
the distributed RMSNorm (an FP32 all-reduce) followed by the kernel
without its norm. At 1x1x1x1 every all-reduce is the identity and the
engine computes exactly ``core.gcn_model.forward``. Values this slice
cannot honour raise ``NotImplementedError`` naming their ROADMAP item.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Sequence, Union

import torch

from repro_torch.core import pmm3d
from repro_torch.core import sampling as smp
from repro_torch.core.gcn_model import GCNConfig
from repro_torch.core.precision import BF16_WIRE, psum_maybe_bf16
from repro_torch.obs.tracer import phase

_COMM = 'ROADMAP queue 1, "Ring overlap and compressed collectives"'
BACKENDS = ("dense", "ell", "csr")


@dataclasses.dataclass(frozen=True)
class TrainOptions:
    """Optimization toggles of the training step (paper §V); see the
    reference for the meaning of each."""

    bf16_collectives: bool = False     # §V-B
    fused_elementwise: bool = False    # §V-C: the fused tail kernel
    reshard_impl: str = "gather"
    dropout: float = 0.0               # dropout of the training step
    seed: int = 0
    sample_mode: str = "step"          # "step" | "epoch"
    sample_kind: str = "stratified"    # "stratified" ("partition", "walk")
    clusters: int = 0
    walk_len: int = 4
    walk_k: int = 8
    block_dtype: str = "f32"           # "f32" ("bf16")
    spmm_impl: str = "dense"           # "dense" | "ell" (block-ELL kernel)
    ell_tile: int = 128                # (bm = bn) tile side
    ell_slots: int = 16                # max nonzero col-tiles per row-block
    extract_impl: str = "torch"        # "torch" | "cuda" (fused kernel)
    overlap_impl: str = "none"         # "none" ("ring")
    compress: str = "none"             # "none" ("bf16", "int8", "int4")
    compress_schedule: str = "uniform"

    def __post_init__(self):
        if self.bf16_collectives:
            raise NotImplementedError(BF16_WIRE)
        if self.compress != "none" or self.overlap_impl == "ring":
            raise NotImplementedError(
                f"compress={self.compress!r}, overlap_impl="
                f"{self.overlap_impl!r}: {_COMM}")
        if self.sample_kind in ("partition", "walk"):
            raise NotImplementedError(
                f"sample_kind={self.sample_kind!r} is {smp._LOCALITY}")
        if self.block_dtype == "bf16":
            raise NotImplementedError(
                "block_dtype='bf16' is not ported: the extraction writes "
                "float32 blocks")
        for name, value, allowed in (
                ("reshard_impl", self.reshard_impl, ("gather", "permute")),
                ("overlap_impl", self.overlap_impl, ("none",)),
                ("sample_kind", self.sample_kind, ("stratified",)),
                ("sample_mode", self.sample_mode, ("step", "epoch")),
                ("block_dtype", self.block_dtype, ("f32",)),
                ("spmm_impl", self.spmm_impl, ("dense", "ell")),
                ("extract_impl", self.extract_impl, ("torch", "cuda")),
                ("compress_schedule", self.compress_schedule,
                 ("uniform", "variable"))):
            if value not in allowed:
                raise ValueError(f"{name}={value!r}: one of {allowed}")
        if not 0.0 <= self.dropout < 1.0:
            raise ValueError(f"dropout={self.dropout}")


def _dropout_key(opts: TrainOptions, step: int, layer: int, row: int = 0,
                 col: int = 0, dp: int = 0) -> int:
    """Per-block dropout key: (seed + 1, step, layer) mixed, then the
    coordinates of the block's rows and columns and its DP group folded
    in, as the reference folds them. The replicas of a block along the
    third axis get the same key, hence the same mask, or they would
    diverge."""
    k = smp.fold_in(smp.fold_in(opts.seed + 1, step), layer)
    for coord in (row, col, dp):
        k = smp.fold_in(k, coord)
    return k


def _keep_mask(opts: TrainOptions, key: int, shape: tuple,
               device: Union[str, torch.device]) -> torch.Tensor:
    """A bool keep-mask, ``rand < 1 - p`` drawn on ``device`` from the
    generator of ``key``."""
    return torch.rand(shape, device=device, generator=smp.make_generator(
        key, device)) < 1.0 - opts.dropout


def dropout_masks(opts: TrainOptions, step: int, num_layers: int,
                  shape: tuple, device: Union[str, torch.device]
                  ) -> List[torch.Tensor]:
    """The single-device step's keep-masks, one per layer: those
    ``ForwardEngine`` draws at block (0, 0) of DP group 0, a pure function
    of (seed, step, layer)."""
    return [_keep_mask(opts, _dropout_key(opts, step, li), shape, device)
            for li in range(num_layers)]


@dataclasses.dataclass(frozen=True)
class ForwardEngine:
    """The §III/§IV layer program on one rank of ``mesh``. ``cfg`` gives
    the architecture (the tail follows ``opts.fused_elementwise`` and
    ``opts.dropout``, as in the reference); ``csr_rows`` is the local row
    count of the CSR shards (backend ``"csr"`` only)."""

    cfg: GCNConfig
    opts: TrainOptions
    mesh: Any
    backend: str = "dense"
    csr_rows: int = 0

    def __post_init__(self):
        if self.backend not in BACKENDS:
            raise ValueError(f"backend={self.backend!r}: one of {BACKENDS}")
        if self.backend == "csr" and self.csr_rows <= 0:
            raise ValueError("backend 'csr' needs the local row count "
                             "(csr_rows)")

    @classmethod
    def from_options(cls, cfg: GCNConfig, opts: TrainOptions, mesh, *,
                     backend: Optional[str] = None,
                     csr_rows: int = 0) -> "ForwardEngine":
        """The aggregation backend follows the mini-batch block format
        (``opts.spmm_impl``) unless given (eval passes ``"csr"``)."""
        return cls(cfg=cfg, opts=opts, mesh=mesh,
                   backend=backend or opts.spmm_impl, csr_rows=csr_rows)

    @property
    def grid_side(self) -> int:
        return self.mesh.shape["x"]

    def aggregate_local(self, blk: Any, h: torch.Tensor) -> torch.Tensor:
        """The local A @ H partial product, before the row-axis
        all-reduce."""
        if self.backend == "ell":
            from repro_torch.kernels import ops as kops
            return kops.spmm_ell(blk[0], blk[1], h)
        if self.backend == "csr":
            rp, ci, val = blk
            return pmm3d.csr_spmm_local(rp, ci, val, h, self.csr_rows)
        return blk @ h

    def keep_mask(self, step: int, layer: int, st: pmm3d.PlaneState,
                  shape: tuple, device: torch.device) -> torch.Tensor:
        """Layer ``layer``'s keep-mask of this rank's block of plane
        (p, r)."""
        c = self.mesh.coords
        return _keep_mask(self.opts, _dropout_key(
            self.opts, step, layer, c[st.rep], c[st.row], c["d"]), shape,
            device)

    def tail(self, conv: torch.Tensor, residual: Optional[torch.Tensor],
             scale: torch.Tensor, st: pmm3d.PlaneState,
             mask: Optional[torch.Tensor], train: bool) -> torch.Tensor:
        """RMSNorm -> ReLU -> dropout -> residual (Eqs. 7-10) on the local
        block: ``conv`` on plane (p, r), RMSNorm reducing over r, the
        residual already resharded to (p, r)."""
        cfg, opts = self.cfg, self.opts
        residual = residual if cfg.use_residual else None
        mask = mask if train and opts.dropout > 0 else None
        if opts.fused_elementwise:
            from repro_torch.kernels import ops as kops
            whole = not cfg.use_rmsnorm or self.grid_side == 1
            h = conv if whole else pmm3d.parallel_rmsnorm(
                conv, scale, self.mesh.axis(st.row), cfg.d_hidden,
                cfg.rms_eps)
            return kops.fused_layer_tail(
                h, residual, scale, dropout_mask=mask,
                dropout_rate=opts.dropout, eps=cfg.rms_eps,
                use_rmsnorm=cfg.use_rmsnorm and whole,
                use_relu=cfg.use_relu)
        h = (pmm3d.parallel_rmsnorm(conv, scale, self.mesh.axis(st.row),
                                    cfg.d_hidden, cfg.rms_eps)
             if cfg.use_rmsnorm else conv)
        if cfg.use_relu:
            h = torch.relu(h)
        if mask is not None:
            h = torch.where(mask, h / (1.0 - opts.dropout),
                            torch.zeros_like(h))
        if residual is not None:
            h = h + residual
        return h

    def __call__(self, params, adj_blocks: Sequence[Any],
                 x_local: torch.Tensor, *, step: int, train: bool):
        """§III forward under 3D PMM: ``adj_blocks[l % len]`` is this
        rank's block for layer l's rotation plane, in the backend's
        format; ``x_local`` the local feature block on plane (x, z).
        Returns ``(logits, state)``: the local logits on plane (row, rep)
        of the final state."""
        cfg, opts, mesh = self.cfg, self.opts, self.mesh
        bf16 = opts.bf16_collectives
        st = pmm3d.initial_state()
        # input projection (Eq. 4): IN (x, z) @ W_in (z, y) -> sum z ->
        # F (x, y)
        h = pmm3d.pmm_matmul(x_local, params["w_in"], mesh.axis("z"),
                             bf16=bf16)
        for li, layer in enumerate(params["layers"]):
            blk = adj_blocks[li % len(adj_blocks)]
            res = None
            if cfg.use_residual:       # (r, c) -> (p, r), paper §IV-C4
                with phase("reshard"):
                    res = pmm3d.reshard(h, mesh, st, (st.rep, st.row),
                                        impl=opts.reshard_impl)
            with phase("spmm"):        # A (p, r) @ H (r, c) -> sum r
                part = psum_maybe_bf16(self.aggregate_local(blk, h),
                                       mesh.axis(st.row), bf16)
            with phase("gemm"):        # H (p, c) @ W (c, r) -> sum c
                conv = pmm3d.pmm_matmul(part, layer["w"], mesh.axis(st.col),
                                        bf16=bf16)
            mask = (self.keep_mask(step, li, st, tuple(conv.shape),
                                   conv.device)
                    if train and opts.dropout > 0 else None)
            with phase("tail"):
                h = self.tail(conv, res, layer["rms_scale"], st, mask, train)
            st = st.rotate()
        # output head (Eq. 11): X (r, c) @ W_out (c, p) -> sum c -> logits
        # (r, p)
        logits = pmm3d.pmm_matmul(h, params["w_out"], mesh.axis(st.col),
                                  bf16=bf16)
        return logits, st
