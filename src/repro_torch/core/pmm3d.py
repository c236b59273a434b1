"""3D parallel matrix multiplication with layer rotation (ScaleGNN §IV-C),
over ``torch.distributed``, with the paper's §V communication forms.

Counterpart of ``repro/core/pmm3d.py``. The reference runs inside
``shard_map`` over the mesh axes ``(x, y, z)``; here each rank runs the
same program on its own shards, and an :class:`Axis` names one mesh axis
as this rank sees it: its coordinate along the axis, the axis size, the
process group of the ranks that differ from it in that coordinate only
and their global ranks in coordinate order. A collective over an axis
without a group (the single-device step: no process group, every axis of
size 1) is the identity and makes no call; a bf16 wire keeps its cast
there, as in the reference (``precision.psum_maybe_bf16``).

Layout algebra (the reference's DESIGN.md §4). A matrix "lives on plane
(a, b)" when its rows are block-sharded over axis ``a``, its columns over
``b``, and it is replicated over the third. One PMM step is a local
product and one all-reduce; per GCN layer with input state on plane
(r, c) replicated over p, the SpMM sums over r into (p, c), the GEMM over
c into (p, r): the rotation ``(r, c, p) -> (p, r, c)`` of period 3. The
residual moves (r, c) -> (p, r) (paper §IV-C4) by :func:`reshard`.

Gradients follow the reference's ``check_vma=False`` convention: every
all-reduce transposes to an all-reduce over the same group
(``precision.AllReduce``), a tiled all-gather to the sum of its cotangents
over the group, sliced back (:class:`AllGather`), a permutation to its
inverse (:class:`Permute`). ``fourd.value_and_grad`` supplies the rest of
the convention (the loss cotangent and the reduction over replicated
axes).

The ring forms (``overlap_impl="ring"``) decompose an all-reduce into a
reduce-scatter and an all-gather of row chunks over point-to-point
exchanges with the axis neighbours (``(idx ± 1) % g``), and
:func:`ring_psum_chunked` hands each reduced chunk to a consumer as it
lands: the next hop's sends and receives are posted
(``dist.batch_isend_irecv``) before the chunk's GEMM and waited on after
it, which is what overlaps the transfer with compute in eager PyTorch (the
reference left it to XLA's scheduler). At g <= 2 every reduction is one
add, so a ring is bit for bit its monolithic all-reduce. The compressed
forms send each hop quantized (``precision.quantize``, int8 or packed
int4 with FP32 row scales) and return the quantization residual that the
error-feedback carry re-injects next step; their backwards have the
transpose structure of the uncompressed collective, every hop quantized
at the forward's width and without error feedback.

Every collective here reports itself to the collective ledger
(``obs.comm``: a no-op unless one is recording): an all-reduce and an
all-gather at their call, a point-to-point hop at :func:`_post` (its wait
at :func:`_wait`), under the rings' scopes ``ring_rs``, ``ring_ag``,
``ring_rs_q`` and ``ring_ag_q`` (the reference's ``named_scope`` names)
and, in a backward, under the scope its forward ran in.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.core.precision import (WIRE_BITS, dequantize,
                                        dequantize_add, psum_fp32, quantize)
from repro_torch.obs import comm


@dataclasses.dataclass(frozen=True)
class Axis:
    """One mesh axis from this rank: its coordinate ``index`` in ``[0,
    size)``, the group of the ``size`` ranks along it, or None without a
    process group (then ``size`` is 1), and their global ranks in
    coordinate order."""

    name: str
    index: int
    size: int
    group: Any = None
    ranks: Tuple[int, ...] = ()

    def neighbours(self) -> Tuple[int, int]:
        """The global ranks of the ring's next (``idx + 1``) and previous
        (``idx - 1``) rank along the axis."""
        return (self.ranks[(self.index + 1) % self.size],
                self.ranks[(self.index - 1) % self.size])


@dataclasses.dataclass(frozen=True)
class PlaneState:
    """Tracks the (row, col, rep) mesh-axis roles of the activation."""

    row: str
    col: str
    rep: str

    def rotate(self) -> "PlaneState":
        """Layer rotation: (r, c, p) -> (p, r, c)."""
        return PlaneState(row=self.rep, col=self.row, rep=self.col)

    @property
    def adj_plane(self) -> Tuple[str, str]:
        """The plane of the adjacency shard consumed at this state: (p, r)."""
        return (self.rep, self.row)

    @property
    def weight_plane(self) -> Tuple[str, str]:
        """The plane of the GEMM weight consumed at this state: (c, r)."""
        return (self.col, self.row)


def initial_state(axes: Sequence[str] = ("x", "y", "z")) -> PlaneState:
    """State of the projected features after the input projection: rows
    over x, cols over y, replicated over z."""
    return PlaneState(row=axes[0], col=axes[1], rep=axes[2])


def state_after_layers(num_layers: int,
                       axes: Sequence[str] = ("x", "y", "z")) -> PlaneState:
    st = initial_state(axes)
    for _ in range(num_layers):
        st = st.rotate()
    return st


# ---------------------------------------------------------------------------
# Collectives with their transposes
# ---------------------------------------------------------------------------

def pmax(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """All-reduce MAX over ``axis``, outside autograd (the reference cuts
    the tangent before ``pmax``, which has no differentiation rule)."""
    y = x.detach().clone(memory_format=torch.contiguous_format)
    if axis.group is not None:
        comm.record("all-reduce", y)
        dist.all_reduce(y, op=dist.ReduceOp.MAX, group=axis.group)
    return y


def _gather(x: torch.Tensor, axis: Axis, dim: int) -> torch.Tensor:
    parts = [torch.empty_like(x, memory_format=torch.contiguous_format)
             for _ in range(axis.size)]
    comm.record("all-gather", x, times=axis.size)
    dist.all_gather(parts, x.contiguous(), group=axis.group)
    return torch.cat(parts, dim)


class AllGather(torch.autograd.Function):
    """Tiled all-gather along ``dim``, in coordinate order; the backward
    sums the cotangent over the group and keeps this rank's slice (the
    reference's ``psum_scatter``)."""

    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim, ctx.n = axis, dim, x.shape[dim]
        ctx.scope = comm.current_scope()
        return _gather(x.detach(), axis, dim)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        with comm.restore(ctx.scope):
            comm.record("all-reduce", g)
        dist.all_reduce(g, group=ctx.axis.group)
        return g.narrow(ctx.dim, ctx.axis.index * ctx.n, ctx.n), None, None


def all_gather(x: torch.Tensor, axis: Axis, dim: int = 0) -> torch.Tensor:
    """``x`` of every rank along ``axis``, concatenated along ``dim``."""
    if axis.group is None:
        return x
    return AllGather.apply(x, axis, dim)


class Permute(torch.autograd.Function):
    """Send ``x`` to global rank ``dst`` and receive the same shape from
    ``src`` in one batched point-to-point exchange; the backward routes the
    cotangent the other way."""

    @staticmethod
    def forward(ctx, x, dst, src):
        ctx.dst, ctx.src, ctx.scope = dst, src, comm.current_scope()
        return _exchange(x.detach(), dst, src)

    @staticmethod
    def backward(ctx, g):
        with comm.restore(ctx.scope):
            return _exchange(g, ctx.src, ctx.dst), None, None


def _post(xs: Sequence[torch.Tensor], dst: int, src: int):
    """Post the sends of ``xs`` to global rank ``dst`` and the receives of
    the same shapes from ``src`` in one batch, without waiting; one tag
    per tensor. The ledger counts it as one hop (``obs.comm``)."""
    xs = [x.contiguous() for x in xs]
    outs = [torch.empty_like(x) for x in xs]
    ops = []
    for tag, (x, out) in enumerate(zip(xs, outs)):
        ops += [dist.P2POp(dist.isend, x, dst, tag=tag),
                dist.P2POp(dist.irecv, out, src, tag=tag)]
    hop = comm.record_hop(xs)
    return outs, dist.batch_isend_irecv(ops), hop


def _wait(pending) -> List[torch.Tensor]:
    """The received tensors of a :func:`_post`, once its requests are
    done."""
    outs, reqs, hop = pending
    for req in reqs:
        req.wait()
    comm.hop_done(hop)
    return outs


def _exchange(x: torch.Tensor, dst: int, src: int) -> torch.Tensor:
    return _wait(_post([x], dst, src))[0]


# ---------------------------------------------------------------------------
# PMM primitives
# ---------------------------------------------------------------------------

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


def parallel_rmsnorm(x: torch.Tensor, scale: torch.Tensor, col_axis: Axis,
                     d_model: int, eps: float = 1e-6) -> torch.Tensor:
    """Eq. 29 — RMSNorm with the feature dim sharded over ``col_axis``; the
    sum-of-squares all-reduce stays FP32 (paper §V-B)."""
    sq = torch.sum(torch.square(x), dim=-1, keepdim=True)
    ms = psum_fp32(sq, col_axis) / d_model
    return x * torch.rsqrt(ms + eps) * scale


def _class_ids(logits: torch.Tensor, class_axis: Axis) -> Tuple[int,
                                                                 torch.Tensor]:
    c_local = logits.shape[-1]
    c0 = class_axis.index * c_local
    return c0, c0 + torch.arange(c_local, device=logits.device)


def parallel_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                           class_axis: Axis, row_axis: Axis,
                           n_classes: int
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Distributed masked cross-entropy over (b_local, c_local) logits on
    plane (row, class): logsumexp over the class-sharded axis (FP32, paper
    §V-B), the target logit through a masked all-reduce, padded class
    columns masked out. Returns (sum of nll over all rows, count), both
    reduced over the rows and replicated within the (x, y, z) group."""
    c_local = logits.shape[-1]
    c0, col_ids = _class_ids(logits, class_axis)
    logits = torch.where(col_ids[None, :] < n_classes, logits,
                         torch.full_like(logits, -1e30))

    # target logit: each row's label lives on exactly one class shard
    rel = labels.long() - c0
    in_range = (rel >= 0) & (rel < c_local) & (labels >= 0)
    safe_rel = torch.clamp(rel, 0, c_local - 1)
    tgt_local = torch.gather(logits, -1, safe_rel[:, None])[:, 0]
    tgt = psum_fp32(torch.where(in_range, tgt_local,
                                torch.zeros_like(tgt_local)), class_axis)

    # distributed logsumexp; the max shift is gradient-neutral and cut
    m = pmax(torch.max(logits.detach(), dim=-1).values, class_axis)
    z = psum_fp32(torch.sum(torch.exp(logits - m[:, None]), dim=-1),
                  class_axis)
    logz = m + torch.log(z)

    w = (labels >= 0).to(logits.dtype)
    nll_sum = torch.sum((logz - tgt) * w)
    return psum_fp32(nll_sum, row_axis), psum_fp32(torch.sum(w), row_axis)


@torch.no_grad()
def parallel_argmax_correct(logits: torch.Tensor, labels: torch.Tensor,
                            class_axis: Axis, row_axis: Axis,
                            n_classes: int
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Distributed accuracy numerator and denominator (float32), the
    smallest class index attaining the max winning ties."""
    c0, col_ids = _class_ids(logits, class_axis)
    logits = torch.where(col_ids[None, :] < n_classes, logits,
                         torch.full_like(logits, float("-inf")))
    local_max, local_arg = torch.max(logits, dim=-1)
    gmax = pmax(local_max, class_axis)
    cand = torch.where(local_max >= gmax, c0 + local_arg,
                       torch.full_like(local_arg, n_classes + 1))
    garg = -pmax(-cand, class_axis)                  # pmin via pmax
    valid = labels >= 0
    correct = torch.sum((garg == labels.long()) & valid)
    return (psum_fp32(correct.float(), row_axis),
            psum_fp32(torch.sum(valid).float(), row_axis))


# ---------------------------------------------------------------------------
# Residual resharding (paper §IV-C4)
# ---------------------------------------------------------------------------

def reshard_gather(t: torch.Tensor, mesh, from_state: PlaneState,
                   to_plane: Tuple[str, str], *,
                   ring: bool = False) -> torch.Tensor:
    """Baseline reshard: all-gather the full matrix over the source plane,
    then slice this rank's destination block (g^2 x the bytes of
    :func:`reshard_permute`). With ``ring`` both all-gathers are rings
    (:func:`ring_all_gather`): the same bits, in 2(g - 1) hops."""
    gather = ring_all_gather if ring else all_gather
    full = gather(t, mesh.axis(from_state.row), dim=0)
    full = gather(full, mesh.axis(from_state.col), dim=1)
    br, bc = t.shape
    i, j = mesh.coords[to_plane[0]], mesh.coords[to_plane[1]]
    return full[i * br:(i + 1) * br, j * bc:(j + 1) * bc].contiguous()


def _permute_ranks(mesh, from_state: PlaneState) -> Tuple[int, int, bool]:
    """(dst, src, stays) of the rotation's block permutation on this rank
    (:func:`reshard_permute`)."""
    roles = (from_state.row, from_state.col, from_state.rep)
    i, j, k = (mesh.coords[a] for a in roles)
    dst = mesh.rank_at(dict(zip(roles, (j, k, i))))
    src = mesh.rank_at(dict(zip(roles, (k, i, j))))
    return dst, src, i == j == k


def reshard_permute(t: torch.Tensor, mesh, from_state: PlaneState,
                    to_plane: Tuple[str, str]) -> torch.Tensor:
    """The layer-rotation reshard as one permutation: each block moves
    once. The rank with role coordinates (row, col, rep) = (i, j, k) needs
    source block (k, i), which the rank (k, i, j) holds; so it sends its
    own block (i, j) to the rank (j, k, i)."""
    del to_plane                       # (rep, row): the rotation's plane
    dst, src, stays = _permute_ranks(mesh, from_state)
    return t if stays else Permute.apply(t, dst, src)


def reshard(t: torch.Tensor, mesh, from_state: PlaneState,
            to_plane: Tuple[str, str], impl: str = "gather",
            overlap: str = "none") -> torch.Tensor:
    """Move ``t`` from plane (row, col) of ``from_state`` to ``to_plane``:
    ``"gather"`` (its all-gathers as rings under ``overlap="ring"``) or
    ``"permute"`` (bit-identical data movement)."""
    if (from_state.row, from_state.col) == to_plane:
        return t
    if impl == "permute":
        return reshard_permute(t, mesh, from_state, to_plane)
    return reshard_gather(t, mesh, from_state, to_plane,
                          ring=overlap == "ring")


# ---------------------------------------------------------------------------
# Chunked ring collectives (comm-compute overlap, paper §V)
# ---------------------------------------------------------------------------

def _chunk_rows(x: torch.Tensor, g: int) -> Tuple[torch.Tensor, int]:
    """Pad dim 0 with zero rows to a multiple of g and view as (g, rows / g,
    ...) chunks (a copy: the rings update chunks in place)."""
    m = x.shape[0]
    pad = (-m) % g
    if pad:
        x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
    return x.reshape((g, (m + pad) // g) + tuple(x.shape[1:])).clone(), pad


def _ring_reduce_scatter(chunks: torch.Tensor, axis: Axis) -> torch.Tensor:
    """g - 1 hops along the ring, in place; afterwards this rank's chunk
    ``(idx + 1) % g`` of the (g, ...) stack holds the complete sum."""
    g, idx = axis.size, axis.index
    nxt, prv = axis.neighbours()
    with comm.scope("ring_rs"):
        for s in range(g - 1):
            recv = _exchange(chunks[(idx - s) % g], nxt, prv)
            k = (idx - 1 - s) % g
            chunks[k] = chunks[k] + recv
    return chunks


def _assemble(outs: List[Any], rows: int) -> Any:
    """The per-chunk results (a tensor or a tuple of tensors each, in chunk
    order) concatenated along dim 0, padding rows cut."""
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(parts)[:rows] for parts in zip(*outs))
    return torch.cat(outs)[:rows]


def _ring_all_gather_consume(first: torch.Tensor, first_ix: int,
                             axis: Axis, decode: Callable,
                             consume: Callable, payload: Sequence,
                             scope: str = "ring_ag") -> list:
    """The all-gather phase of a ring: ``payload`` (this rank's complete
    chunk as it travels) circulates g - 1 hops; each hop's sends and
    receives are posted before ``consume`` of the chunk in hand and waited
    on after it, so the transfer overlaps that compute. ``decode`` turns a
    received payload into the chunk. Returns the consumed chunks in chunk
    order; the hops record under ``scope``."""
    g, idx = axis.size, axis.index
    nxt, prv = axis.neighbours()
    outs: list = [None] * g
    cur, ix = first, first_ix
    for s in range(g - 1):
        with comm.scope(scope):
            pending = _post(payload, nxt, prv)
        outs[ix] = consume(cur)
        payload = _wait(pending)
        cur, ix = decode(payload), (idx - s) % g
    outs[ix] = consume(cur)
    return outs


def ring_psum_chunked(x: torch.Tensor, axis: Axis, on_chunk: Callable, *,
                      bf16: bool = False) -> Any:
    """The all-reduce of ``x`` over ``axis`` as a ring of row chunks, each
    fully reduced chunk handed to ``on_chunk`` as it lands; the per-chunk
    results concatenated along dim 0. ``on_chunk`` must be row-local and
    row-preserving (``lambda c: c @ w``, or a tuple of such), so the result
    is ``on_chunk(psum(x))``. With ``bf16`` the wire is bfloat16 (cast
    once, summed in bf16, cast back), the round trip included at g = 1.
    Outside autograd: the differentiable forms are :func:`ring_psum` and
    :func:`ring_psum_gemm`."""
    dtype = x.dtype
    wire = x.to(torch.bfloat16) if bf16 and dtype == torch.float32 else x
    if axis.size == 1 or axis.group is None:
        return on_chunk(wire.to(dtype))
    g = axis.size
    chunks, _ = _chunk_rows(wire, g)
    acc = _ring_reduce_scatter(chunks, axis)
    own_ix = (axis.index + 1) % g
    outs = _ring_all_gather_consume(
        acc[own_ix], own_ix, axis, lambda p: p[0],
        lambda c: on_chunk(c.to(dtype)), [acc[own_ix]])
    return _assemble(outs, x.shape[0])


class RingPsum(torch.autograd.Function):
    """:func:`ring_psum_chunked` with no consumer; the backward is the same
    ring over the cotangent (psum transposes to psum)."""

    @staticmethod
    def forward(ctx, x, axis, bf16):
        ctx.axis, ctx.bf16, ctx.scope = axis, bf16, comm.current_scope()
        return ring_psum_chunked(x.detach(), axis, lambda c: c, bf16=bf16)

    @staticmethod
    def backward(ctx, g):
        with comm.restore(ctx.scope):
            return (ring_psum_chunked(g, ctx.axis, lambda c: c,
                                      bf16=ctx.bf16), None, None)


def ring_psum(x: torch.Tensor, axis: Axis, *,
              bf16: bool = False) -> torch.Tensor:
    """All-reduce over ``axis`` as a reduce-scatter + all-gather ring;
    ``psum_maybe_bf16``'s semantics, bit for bit at g <= 2."""
    if axis.group is None and not (bf16 and x.dtype == torch.float32):
        return x
    return RingPsum.apply(x, axis, bf16)


class RingPsumGemm(torch.autograd.Function):
    """``psum(part) @ w`` with each reduced chunk GEMMed on arrival. The
    backward is the reference's full-width one: ``dagg = dconv @ w.T``,
    ``dw = agg.T @ dconv`` against the reassembled sum, and the psum
    transpose of ``dagg`` over the same ring, so loss and gradients stay
    bit for bit the monolithic path's at g <= 2."""

    @staticmethod
    def forward(ctx, part, w, axis, bf16):
        w = w.detach()
        ctx.axis, ctx.bf16, ctx.scope = axis, bf16, comm.current_scope()
        with comm.scope("ring_gemm"):
            agg, conv = ring_psum_chunked(part.detach(), axis,
                                          lambda c: (c, c @ w), bf16=bf16)
        ctx.save_for_backward(agg, w)
        return conv

    @staticmethod
    def backward(ctx, dconv):
        agg, w = ctx.saved_tensors
        dagg = dconv @ w.T
        dw = agg.T @ dconv
        with comm.restore(ctx.scope):
            dpart = ring_psum_chunked(dagg, ctx.axis, lambda c: c,
                                      bf16=ctx.bf16)
        return dpart, dw, None, None


def ring_psum_gemm(part: torch.Tensor, w: torch.Tensor, axis: Axis, *,
                   bf16: bool = False) -> torch.Tensor:
    """The pipelined SpMM reduce + GEMM: ``psum(part, axis) @ w`` with the
    all-reduce as the chunked ring and each reduced chunk GEMMed on
    arrival (:func:`ring_psum_chunked`)."""
    return RingPsumGemm.apply(part, w, axis, bf16)


def _ring_gather(x: torch.Tensor, axis: Axis, dim: int) -> torch.Tensor:
    """Tiled all-gather along ``dim`` in g - 1 ring hops, outside
    autograd."""
    g, idx = axis.size, axis.index
    if g == 1 or axis.group is None:
        return x
    nxt, prv = axis.neighbours()
    out: list = [None] * g
    out[idx] = cur = x.contiguous()
    with comm.scope("ring_ag"):
        for s in range(g - 1):
            cur = _exchange(cur, nxt, prv)
            out[(idx - 1 - s) % g] = cur
    return torch.cat(out, dim)


class RingAllGather(torch.autograd.Function):
    """:func:`_ring_gather`; the backward sums the cotangent over the ring
    and keeps this rank's slice."""

    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim, ctx.n = axis, dim, x.shape[dim]
        ctx.scope = comm.current_scope()
        return _ring_gather(x.detach(), axis, dim)

    @staticmethod
    def backward(ctx, g):
        with comm.restore(ctx.scope):
            full = ring_psum_chunked(g.contiguous(), ctx.axis, lambda c: c)
        return (full.narrow(ctx.dim, ctx.axis.index * ctx.n, ctx.n), None,
                None)


def ring_all_gather(x: torch.Tensor, axis: Axis,
                    dim: int = 0) -> torch.Tensor:
    """Tiled all-gather over ``axis`` in g - 1 ring hops (bit for bit
    :func:`all_gather`)."""
    if axis.group is None:
        return x
    return RingAllGather.apply(x, axis, dim)


# ---------------------------------------------------------------------------
# Compressed ring collectives (quantized wire + error feedback)
# ---------------------------------------------------------------------------

def ring_psum_q(x: torch.Tensor, axis: Axis, bits: int, ef: torch.Tensor,
                on_chunk: Optional[Callable] = None
                ) -> Tuple[Any, torch.Tensor]:
    """Quantized ring all-reduce of ``x + ef``: every reduce-scatter and
    all-gather hop is sent as (int8 or packed int4 q, FP32 row scales).
    Returns ``(result, residual)``: ``on_chunk`` (default identity) consumes
    each reconstructed chunk as it lands, as in :func:`ring_psum_chunked`;
    ``residual`` is the quantization error this rank injected (its
    reduce-scatter sends plus its owned chunk's broadcast), the next step's
    ``ef``. In the all-gather phase every rank, the chunk's owner included,
    rebuilds a chunk from the same (q, scale) pair, so the replicas stay
    identical. At g = 1 there is no wire: the result is exact and the
    residual zero. Outside autograd."""
    consume = on_chunk if on_chunk is not None else (lambda c: c)
    tc = (x + ef).to(torch.float32)
    g, idx = axis.size, axis.index
    if g == 1 or axis.group is None:
        return consume(tc), torch.zeros_like(tc)
    nxt, prv = axis.neighbours()
    acc, _ = _chunk_rows(tc, g)
    resid = torch.zeros_like(acc)
    for s in range(g - 1):
        k = (idx - s) % g
        v = acc[k]
        q, sc = quantize(v, bits)
        resid[k] = resid[k] + dequantize_add(v, q, sc, bits, -1)
        with comm.scope("ring_rs_q"):
            qr, scr = _wait(_post([q, sc], nxt, prv))
        k = (idx - 1 - s) % g
        acc[k] = dequantize_add(acc[k], qr, scr, bits)
    own_ix = (idx + 1) % g
    own = acc[own_ix]
    q, sc = quantize(own, bits)
    own_rec = dequantize(q, sc, bits)
    resid[own_ix] = resid[own_ix] + dequantize_add(own, q, sc, bits, -1)
    outs = _ring_all_gather_consume(
        own_rec, own_ix, axis, lambda p: dequantize(p[0], p[1], bits),
        consume, [q, sc], scope="ring_ag_q")
    rows = x.shape[0]
    return (_assemble(outs, rows),
            resid.reshape((-1,) + tuple(resid.shape[2:]))[:rows])


def _scatter_chunks(v: torch.Tensor, g: int, dim: int) -> torch.Tensor:
    """``v`` split along ``dim`` (0 or 1, evenly) into g chunks stacked on a
    new leading dim (a copy), the feature (last) dim kept whole so that
    the row scales stay per row."""
    if dim == 0:
        return v.reshape((g, v.shape[0] // g) + tuple(v.shape[1:])).clone()
    if dim != 1 or v.dim() != 2:
        raise ValueError(f"dim={dim} of a {v.dim()}-d tensor")
    return v.reshape(v.shape[0], g, v.shape[1] // g).movedim(1, 0).clone(
        memory_format=torch.contiguous_format)


def ring_reduce_scatter_q(v: torch.Tensor, axis: Axis, bits: int, *,
                          dim: int = 0) -> torch.Tensor:
    """Quantized tiled reduce-scatter: ``psum(v)`` over ``axis`` with rank
    ``idx`` keeping slice ``idx`` along ``dim`` (the transpose of a tiled
    all-gather), in g - 1 quantized hops, without error feedback (it runs
    on cotangents). ``v.shape[dim]`` must divide by g."""
    g, idx = axis.size, axis.index
    if g == 1 or axis.group is None:
        return v
    if v.shape[dim] % g:
        raise ValueError(f"{tuple(v.shape)} does not split {g} ways along "
                         f"dim {dim}")
    nxt, prv = axis.neighbours()
    acc = _scatter_chunks(v.to(torch.float32), g, dim)
    # the ring shifted by one, so that rank idx ends with chunk idx
    for s in range(g - 1):
        q, sc = quantize(acc[(idx - s - 1) % g], bits)
        with comm.scope("ring_rs_q"):
            qr, scr = _wait(_post([q, sc], nxt, prv))
        k = (idx - s - 2) % g
        acc[k] = dequantize_add(acc[k], qr, scr, bits)
    return acc[idx]


class CompressedPsum(torch.autograd.Function):
    """``psum(x + ef)`` over the quantized ring, returning ``(y,
    residual)``; straight-through backward: the cotangent's psum over the
    same quantized ring, without error feedback."""

    @staticmethod
    def forward(ctx, x, ef, axis, bits):
        ctx.axis, ctx.bits, ctx.scope = axis, bits, comm.current_scope()
        y, r = ring_psum_q(x.detach(), axis, bits, ef)
        ctx.mark_non_differentiable(r)
        return y, r

    @staticmethod
    def backward(ctx, dy, _dr):
        with comm.restore(ctx.scope):
            dx, _ = ring_psum_q(dy, ctx.axis, ctx.bits,
                                torch.zeros_like(dy))
        return dx, None, None, None


def compressed_psum(x: torch.Tensor, axis: Axis, fmt: str,
                    ef: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``psum(x + ef)`` over ``axis`` with an int8 or int4 wire: ``(reduced,
    residual)``."""
    return CompressedPsum.apply(x, ef, axis, WIRE_BITS[fmt])


class CompressedPsumGemm(torch.autograd.Function):
    """``psum_q(part + ef) @ w`` with each reconstructed chunk GEMMed on
    arrival, returning ``(conv, residual)``. The backward differentiates
    the compressed forward with respect to ``w`` (full width, against the
    reconstructed sum) and straight through with respect to ``part``: the
    psum of ``dconv @ w.T`` over the quantized ring, without error
    feedback."""

    @staticmethod
    def forward(ctx, part, w, ef, axis, bits):
        w = w.detach()
        ctx.axis, ctx.bits, ctx.scope = axis, bits, comm.current_scope()
        with comm.scope("ring_gemm"):
            (agg, conv), r = ring_psum_q(part.detach(), axis, bits, ef,
                                         on_chunk=lambda c: (c, c @ w))
        ctx.save_for_backward(agg, w)
        ctx.mark_non_differentiable(r)
        return conv, r

    @staticmethod
    def backward(ctx, dconv, _dr):
        agg, w = ctx.saved_tensors
        dagg = dconv @ w.T
        dw = agg.T @ dconv
        with comm.restore(ctx.scope):
            dpart, _ = ring_psum_q(dagg, ctx.axis, ctx.bits,
                                   torch.zeros_like(dagg))
        return dpart, dw, None, None, None


def compressed_psum_gemm(part: torch.Tensor, w: torch.Tensor, axis: Axis,
                         fmt: str, ef: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The quantized counterpart of :func:`ring_psum_gemm`: ``(conv,
    residual)``."""
    return CompressedPsumGemm.apply(part, w, ef, axis, WIRE_BITS[fmt])


class ReshardCompressed(torch.autograd.Function):
    """The residual reshard with a quantized wire: ``t + ef`` quantized
    once, the (q, scales) pair moved by the block permutation (``"permute"``)
    or the two ring all-gathers (``"gather"``), every rank dequantizing the
    block it consumes; the residual is the local reconstruction error.
    Straight-through backward with the transpose structure of the
    uncompressed reshard (the inverse permutation, or a zero pad and two
    tiled reduce-scatters), every hop quantized at the same width."""

    @staticmethod
    def forward(ctx, t, ef, mesh, from_state, to_plane, bits, impl):
        ctx.meta = (mesh, from_state, to_plane, bits, impl, tuple(t.shape))
        ctx.scope = comm.current_scope()
        tc = (t.detach() + ef).to(torch.float32)
        q, sc = quantize(tc, bits)
        resid = dequantize_add(tc, q, sc, bits, -1)
        ctx.mark_non_differentiable(resid)
        if impl == "permute":
            dst, src, stays = _permute_ranks(mesh, from_state)
            if not stays:
                q, sc = _wait(_post([q, sc], dst, src))
            return dequantize(q, sc, bits), resid
        g = mesh.shape[from_state.row]
        br, bc = t.shape
        row, col = mesh.axis(from_state.row), mesh.axis(from_state.col)
        qf = _ring_gather(_ring_gather(q, row, 0), col, 1)
        sf = _ring_gather(_ring_gather(sc, row, 0), col, 1)   # (g br, g)
        vals = dequantize(qf.reshape(g * br, g, -1), sf[:, :, None], bits)
        full = vals.reshape(g * br, g * bc)
        i, j = mesh.coords[to_plane[0]], mesh.coords[to_plane[1]]
        return full[i * br:(i + 1) * br, j * bc:(j + 1) * bc].contiguous(), \
            resid

    @staticmethod
    def backward(ctx, dout, _dr):
        with comm.restore(ctx.scope):
            return ReshardCompressed._backward(ctx, dout)

    @staticmethod
    def _backward(ctx, dout):
        mesh, from_state, to_plane, bits, impl, (br, bc) = ctx.meta
        if impl == "permute":
            dst, src, stays = _permute_ranks(mesh, from_state)
            dq, ds = quantize(dout.to(torch.float32), bits)
            if not stays:
                dq, ds = _wait(_post([dq, ds], src, dst))
            dt = dequantize(dq, ds, bits)
        else:
            g = mesh.shape[from_state.row]
            i, j = mesh.coords[to_plane[0]], mesh.coords[to_plane[1]]
            d_full = dout.new_zeros((g * br, g * bc), dtype=torch.float32)
            d_full[i * br:(i + 1) * br, j * bc:(j + 1) * bc] = dout
            d1 = ring_reduce_scatter_q(d_full, mesh.axis(from_state.col),
                                       bits, dim=1)
            dt = ring_reduce_scatter_q(d1, mesh.axis(from_state.row), bits,
                                       dim=0)
        return dt.to(dout.dtype), None, None, None, None, None, None


def reshard_compressed(t: torch.Tensor, mesh, from_state: PlaneState,
                       to_plane: Tuple[str, str], fmt: str,
                       ef: torch.Tensor, impl: str = "gather"
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The residual reshard (§IV-C4) with an int8 or int4 wire: ``(block,
    residual)``. Where nothing moves (the same plane, or g = 1) the block
    is ``t`` itself and the residual zero: quantizing there would make
    error from nothing."""
    bits = WIRE_BITS[fmt]
    if (from_state.row, from_state.col) == to_plane \
            or mesh.shape[from_state.row] == 1:
        return t, torch.zeros_like(t)
    if bits == 4 and t.shape[-1] % 2:
        raise ValueError(f"an int4 reshard needs an even local column "
                         f"count, got {tuple(t.shape)}")
    return ReshardCompressed.apply(t, ef, mesh, from_state, to_plane, bits,
                                   impl)


