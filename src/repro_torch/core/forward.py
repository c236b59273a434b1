"""The ONE distributed layer-loop executor (ScaleGNN §III/§IV), its
training options and its dropout generators.

Counterpart of ``repro/core/forward.py``: ``TrainOptions`` (every field,
the same defaults except ``extract_impl``, which names the port's
backends), ``wire_format``, ``_dropout_key`` and ``ForwardEngine``. The
dropout masks are counter-based draws from a key derived from the step,
which may be a device counter (``kernels/counter_rng.py``); on the card
the fused tail draws them itself from that key, in its forward and its
backward kernel, so no mask is written (``ForwardEngine.tail_draws``).
The engine
runs the 3D-PMM layer program on this rank's shards of a
``fourd.Mesh`` — input projection, L layers of [residual reshard ->
aggregate -> GEMM -> tail -> rotate], output head — with one all-reduce
per product (``core/pmm3d.py``), under the paper's §V communication
options: a bf16 wire (``bf16_collectives``, ``compress="bf16"``), the
ring schedule (``overlap_impl="ring"``: the residual reshard issued
first, the SpMM partial reduced in chunks and each chunk GEMMed as it
lands) and quantized wires (``compress`` int8 or int4, per layer under
``compress_schedule``) whose error-feedback residuals the caller carries
(``ef``). The aggregation backend is
``"dense"`` (a dense block, ``blk @ h``), ``"ell"`` (a block-ELL ``(tiles,
colidx)`` pair through the SpMM kernel) or ``"csr"`` (a padded-CSR triple
over the whole local shard: full-graph eval). The tail is plain PyTorch or
the fused CUDA kernel (``TrainOptions.fused_elementwise``): fully fused
when the feature dim is whole on the rank (g = 1, or RMSNorm off), else
the distributed RMSNorm (an FP32 all-reduce) followed by the kernel
without its norm. At 1x1x1x1 every all-reduce is the identity and the
engine computes exactly ``core.gcn_model.forward`` (a bf16 wire keeps its
casts). With ``block_dtype="bf16"`` the adjacency blocks are bf16 (rounded
once, at the end of the extraction) and everything downstream stays
float32, as JAX's promotion has it in the reference: the dense product
upcasts the block, the ELL kernels take bf16 tiles with a float32 operand.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import torch

from repro_torch.core import pmm3d
from repro_torch.core import sampling as smp
from repro_torch.core.gcn_model import GCNConfig
from repro_torch.core.precision import WIRE_FORMATS, psum_maybe_bf16
from repro_torch.kernels import counter_rng as crng
from repro_torch.obs.tracer import phase

BACKENDS = ("dense", "ell", "csr")
OVERLAPS = ("none", "ring")
COMPRESS_SCHEDULES = ("uniform", "variable")
# the formats with a quantized wire: the ones that carry error feedback
QUANTIZED_FORMATS = ("int8", "int4")


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
    sample_kind: str = "stratified"    # "stratified" | "partition" | "walk"
    clusters: int = 0                  # partition: clusters per range
    walk_len: int = 4                  # walk: steps per root
    walk_k: int = 8                    # walk: neighbor-table width
    block_dtype: str = "f32"           # "f32" | "bf16" (the blocks)
    spmm_impl: str = "dense"           # "dense" | "ell" (block-ELL kernel)
    ell_tile: int = 128                # (bm = bn) tile side
    ell_slots: int = 16                # max nonzero col-tiles per row-block
    extract_impl: str = "torch"        # "torch" | "cuda" (fused kernel)
    overlap_impl: str = "none"         # "none" | "ring"
    compress: str = "none"             # "none" | "bf16" | "int8" | "int4"
    compress_schedule: str = "uniform"  # "uniform" | "variable"

    def __post_init__(self):
        for name, value, allowed in (
                ("reshard_impl", self.reshard_impl, ("gather", "permute")),
                ("overlap_impl", self.overlap_impl, OVERLAPS),
                ("compress", self.compress, WIRE_FORMATS),
                ("sample_kind", self.sample_kind,
                 ("stratified", "partition", "walk")),
                ("sample_mode", self.sample_mode, ("step", "epoch")),
                ("block_dtype", self.block_dtype, ("f32", "bf16")),
                ("spmm_impl", self.spmm_impl, ("dense", "ell")),
                ("extract_impl", self.extract_impl, ("torch", "cuda")),
                ("compress_schedule", self.compress_schedule,
                 COMPRESS_SCHEDULES)):
            if value not in allowed:
                raise ValueError(f"{name}={value!r}: one of {allowed}")
        if not 0.0 <= self.dropout < 1.0:
            raise ValueError(f"dropout={self.dropout}")


def wire_format(compress: str, schedule: str, layer: int,
                num_layers: int) -> str:
    """The wire format of layer ``layer`` (0-based): ``compress`` on every
    layer under ``"uniform"``; under ``"variable"`` the bf16 -> int8 ->
    int4 ladder ramped with depth, capped at ``compress``."""
    if compress in ("none", "bf16") or schedule == "uniform" \
            or num_layers <= 1:
        return compress
    ladder = ["bf16", "int8", "int4"]
    cap = ladder.index(compress)
    return ladder[int(layer * cap / (num_layers - 1) + 0.5)]


def _dropout_key(opts: TrainOptions, step: smp.Key, layer: int,
                 row: int = 0, col: int = 0, dp: int = 0) -> smp.Key:
    """Per-block dropout key: the layer, the coordinates of the block's
    rows and columns and its DP group folded into ``seed + 1``, then the
    step (last, so a device counter costs one fold on the device). The
    replicas of a block along the third axis get the same key, hence the
    same mask, or they would diverge."""
    k = smp.fold_in(opts.seed + 1, layer)
    for coord in (row, col, dp):
        k = smp.fold_in(k, coord)
    return smp.fold_in(k, step)


def dropout_keys(opts: TrainOptions, step: smp.Key, num_layers: int,
                 device: Union[str, torch.device]) -> List[torch.Tensor]:
    """The single-device step's dropout keys, one 0-d int64 tensor per
    layer on ``device``: those ``ForwardEngine`` draws from at block (0, 0)
    of DP group 0, a pure function of (seed, step, layer)."""
    return [smp.key_tensor(_dropout_key(opts, step, li), device)
            for li in range(num_layers)]


def dropout_masks(opts: TrainOptions, step: smp.Key, num_layers: int,
                  shape: tuple, device: Union[str, torch.device]
                  ) -> List[torch.Tensor]:
    """The (rows, cols) bool keep-masks of :func:`dropout_keys`
    (``kernels.counter_rng.keep_mask``: the kernel on the card, its plain
    version on the CPU): the bits the fused tail draws from those keys."""
    rows, cols = shape
    return [crng.keep_mask(k, rows, cols, opts.dropout)
            for k in dropout_keys(opts, step, num_layers, device)]


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
    draw_in_tail: Optional[bool] = None   # None: by the device (tail_draws)

    def __post_init__(self):
        if self.backend not in BACKENDS:
            raise ValueError(f"backend={self.backend!r}: one of {BACKENDS}")
        if self.backend == "csr" and self.csr_rows <= 0:
            raise ValueError("backend 'csr' needs the local row count "
                             "(csr_rows)")
        fmts, g = self.wire_formats, self.grid_side
        # int4 packs two nibbles per byte along the feature axis
        if "int4" in fmts and (self.cfg.d_hidden // g) % 2:
            raise ValueError(
                "int4 compression needs an even local feature width "
                f"(d_hidden={self.cfg.d_hidden} / g={g})")
        if fmts[-1] == "int4" and -(-self.cfg.num_classes // g) % 2:
            raise ValueError(
                "int4 head compression needs an even local class width "
                f"(padded classes / g = {-(-self.cfg.num_classes // g)}); "
                "use int8 or pad num_classes")

    @classmethod
    def from_options(cls, cfg: GCNConfig, opts: TrainOptions, mesh, *,
                     backend: Optional[str] = None, csr_rows: int = 0,
                     draw_in_tail: Optional[bool] = None) -> "ForwardEngine":
        """The aggregation backend follows the mini-batch block format
        (``opts.spmm_impl``) unless given (eval passes ``"csr"``)."""
        return cls(cfg=cfg, opts=opts, mesh=mesh,
                   backend=backend or opts.spmm_impl, csr_rows=csr_rows,
                   draw_in_tail=draw_in_tail)

    @property
    def grid_side(self) -> int:
        return self.mesh.shape["x"]

    # -- the compressible collectives ----------------------------------------

    @property
    def wire_formats(self) -> Tuple[str, ...]:
        """Each layer's wire format, covering its SpMM and GEMM all-reduces
        and its residual reshard; the input projection follows layer 0's,
        the head the last layer's."""
        L = self.cfg.num_layers
        return tuple(wire_format(self.opts.compress,
                                 self.opts.compress_schedule, li, L)
                     for li in range(L))

    @property
    def quantized(self) -> bool:
        """Whether any collective sends an int8 or int4 wire: exactly when
        the engine carries error feedback."""
        return bool(self.ef_sites())

    def ef_sites(self) -> Tuple[Tuple[str, str], ...]:
        """The (site, format) pairs that carry an error-feedback
        accumulator, in the order the forward consumes them: the one
        definition ``__call__`` and ``fourd.make_ef`` both follow."""
        fmts = self.wire_formats
        sites = []
        if fmts[0] in QUANTIZED_FORMATS:
            sites.append(("proj", fmts[0]))
        for li, f in enumerate(fmts):
            if f not in QUANTIZED_FORMATS:
                continue
            if self.cfg.use_residual:
                sites.append((f"l{li}_reshard", f))
            sites.append((f"l{li}_spmm", f))
            sites.append((f"l{li}_gemm", f))
        if fmts[-1] in QUANTIZED_FORMATS:
            sites.append(("head", fmts[-1]))
        return tuple(sites)

    def ef_site_shapes(self, batch_local: int) -> Dict[str, tuple]:
        """This rank's shape of each EF accumulator for a training batch of
        ``batch_local`` rows per vertex range."""
        dloc = self.cfg.d_hidden // self.grid_side
        ncl = -(-self.cfg.num_classes // self.grid_side)
        return {site: (batch_local, ncl if site == "head" else dloc)
                for site, _ in self.ef_sites()}

    def aggregate_local(self, blk: Any, h: torch.Tensor) -> torch.Tensor:
        """The local A @ H partial product, before the row-axis
        all-reduce. A bf16 block meets a float32 ``h`` as JAX promotes the
        pair: the ELL kernels take the tiles as they are (their
        bf16-tile / f32 route), the dense product upcasts the block."""
        if self.backend == "ell":
            from repro_torch.kernels import ops as kops
            return kops.spmm_ell(blk[0], blk[1], h)
        if self.backend == "csr":
            rp, ci, val = blk
            return pmm3d.csr_spmm_local(rp, ci, val, h, self.csr_rows)
        return blk.to(h.dtype) @ h

    def dropout_key(self, step: smp.Key, layer: int, st: pmm3d.PlaneState,
                    device: torch.device) -> torch.Tensor:
        """Layer ``layer``'s dropout key (0-d int64) of this rank's block
        of plane (p, r); ``step`` may be a device counter."""
        c = self.mesh.coords
        return smp.key_tensor(_dropout_key(
            self.opts, step, layer, c[st.rep], c[st.row], c["d"]), device)

    def keep_mask(self, step: smp.Key, layer: int, st: pmm3d.PlaneState,
                  shape: tuple, device: torch.device) -> torch.Tensor:
        """Layer ``layer``'s keep-mask of this rank's block of plane
        (p, r), drawn from :meth:`dropout_key` (``counter_rng.keep_mask``);
        ``step`` may be a device counter."""
        rows, cols = shape
        return crng.keep_mask(self.dropout_key(step, layer, st, device),
                              rows, cols, self.opts.dropout)

    def tail_draws(self, device: torch.device) -> bool:
        """Whether the tail draws the keep bits from the key itself (the
        fused kernels on the card, and on the meta device, which walks the
        card's step: no mask pass, no mask in memory) rather than being
        handed :meth:`keep_mask`'s mask (the unfused tail, and any tail on
        the CPU, where the tests inject masks). ``draw_in_tail`` sets the
        fused tail's route whatever the device (a CPU walk of the card's
        step)."""
        if not self.opts.fused_elementwise:
            return False
        if self.draw_in_tail is not None:
            return self.draw_in_tail
        return device.type != "cpu"

    def tail(self, conv: torch.Tensor, residual: Optional[torch.Tensor],
             scale: torch.Tensor, st: pmm3d.PlaneState,
             mask: Optional[torch.Tensor], train: bool,
             key: Optional[torch.Tensor] = None) -> torch.Tensor:
        """RMSNorm -> ReLU -> dropout -> residual (Eqs. 7-10) on the local
        block: ``conv`` on plane (p, r), RMSNorm reducing over r, the
        residual already resharded to (p, r). The keep bits are ``mask``
        or, for the fused tail, the dropout ``key``."""
        cfg, opts = self.cfg, self.opts
        residual = residual if cfg.use_residual else None
        dropping = train and opts.dropout > 0
        mask = mask if dropping else None
        if opts.fused_elementwise:
            from repro_torch.kernels import ops as kops
            whole = not cfg.use_rmsnorm or self.grid_side == 1
            h = conv if whole else pmm3d.parallel_rmsnorm(
                conv, scale, self.mesh.axis(st.row), cfg.d_hidden,
                cfg.rms_eps)
            return kops.fused_layer_tail(
                h, residual, scale, dropout_mask=mask,
                dropout_key=key if dropping else None,
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
                 x_local: torch.Tensor, *, step: smp.Key, train: bool,
                 ef: Optional[Dict[str, torch.Tensor]] = None):
        """§III forward under 3D PMM: ``adj_blocks[l % len]`` is this
        rank's block for layer l's rotation plane, in the backend's
        format; ``x_local`` the local feature block on plane (x, z).
        Returns ``(logits, state)``: the local logits on plane (row, rep)
        of the final state. With ``ef`` (the error-feedback accumulators
        of ``ef_sites``) each quantized send compresses ``x + ef[site]``
        and the call returns ``(logits, state, new_ef)``; without it the
        quantized wires run without feedback (eval, the stateless
        ``make_train_step``)."""
        cfg, opts, mesh = self.cfg, self.opts, self.mesh
        ring = opts.overlap_impl == "ring"
        fmts = self.wire_formats
        collect = {} if ef is not None else None

        def take_ef(site: str, like: torch.Tensor) -> torch.Tensor:
            if ef is None:
                return torch.zeros_like(like, dtype=torch.float32)
            if site not in ef:
                raise KeyError(f"no EF accumulator for site {site!r}")
            return ef[site]

        def put_ef(site: str, resid: torch.Tensor) -> None:
            if collect is not None:
                collect[site] = resid

        def ar(x, axis_name, fmt, site):
            """The PMM all-reduce: the quantized ring (with EF) for an int
            wire, else the ring or the monolithic sum, bf16 on the wire
            under either knob."""
            axis = mesh.axis(axis_name)
            if fmt in QUANTIZED_FORMATS:
                y, r = pmm3d.compressed_psum(x, axis, fmt, take_ef(site, x))
                put_ef(site, r)
                return y
            bf = fmt == "bf16" or opts.bf16_collectives
            if ring:
                return pmm3d.ring_psum(x, axis, bf16=bf)
            return psum_maybe_bf16(x, axis, bf)

        st = pmm3d.initial_state()
        # input projection (Eq. 4): IN (x, z) @ W_in (z, y) -> sum z ->
        # F (x, y)
        h = ar(x_local @ params["w_in"], "z", fmts[0], "proj")
        for li, layer in enumerate(params["layers"]):
            blk = adj_blocks[li % len(adj_blocks)]
            fmt = fmts[li]
            quant = fmt in QUANTIZED_FORMATS
            # the residual moves (r, c) -> (p, r) (paper §IV-C4); issued
            # first, it depends on h only
            res = None
            if cfg.use_residual:
                with phase("reshard"):
                    to = (st.rep, st.row)
                    if quant:
                        site = f"l{li}_reshard"
                        res, r = pmm3d.reshard_compressed(
                            h, mesh, st, to, fmt, take_ef(site, h),
                            impl=opts.reshard_impl)
                        put_ef(site, r)
                    elif fmt == "bf16":       # the reshard's wire too
                        res = pmm3d.reshard(
                            h.to(torch.bfloat16), mesh, st, to,
                            impl=opts.reshard_impl,
                            overlap=opts.overlap_impl).to(h.dtype)
                    else:
                        res = pmm3d.reshard(h, mesh, st, to,
                                            impl=opts.reshard_impl,
                                            overlap=opts.overlap_impl)
            with phase("spmm"):        # A (p, r) @ H (r, c) -> sum r
                part = self.aggregate_local(blk, h)
                if not ring and not quant:
                    part = ar(part, st.row, fmt, None)
            with phase("gemm"):        # H (p, c) @ W (c, r) -> sum c
                if quant:
                    # a quantized ring is chunked anyway: the SpMM's reduce
                    # feeds the GEMM chunk by chunk at either overlap
                    site = f"l{li}_spmm"
                    conv, r = pmm3d.compressed_psum_gemm(
                        part, layer["w"], mesh.axis(st.row), fmt,
                        take_ef(site, part))
                    put_ef(site, r)
                    conv = ar(conv, st.col, fmt, f"l{li}_gemm")
                elif ring:
                    bf = fmt == "bf16" or opts.bf16_collectives
                    conv = ar(pmm3d.ring_psum_gemm(
                        part, layer["w"], mesh.axis(st.row), bf16=bf),
                        st.col, fmt, None)
                else:
                    conv = ar(part @ layer["w"], st.col, fmt, None)
            mask = key = None
            if train and opts.dropout > 0:
                if self.tail_draws(conv.device):
                    key = self.dropout_key(step, li, st, conv.device)
                else:
                    mask = self.keep_mask(step, li, st, tuple(conv.shape),
                                          conv.device)
            with phase("tail"):
                h = self.tail(conv, res, layer["rms_scale"], st, mask, train,
                              key)
            with phase("rotate"):
                st = st.rotate()
        # output head (Eq. 11): X (r, c) @ W_out (c, p) -> sum c -> logits
        # (r, p)
        logits = ar(h @ params["w_out"], st.col, fmts[-1], "head")
        if ef is not None:
            return logits, st, collect
        return logits, st
