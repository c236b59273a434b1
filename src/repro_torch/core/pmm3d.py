"""3D parallel matrix multiplication with layer rotation (ScaleGNN §IV-C),
over ``torch.distributed``.

Counterpart of ``repro/core/pmm3d.py`` (its ``"none"`` overlap path). The
reference runs inside ``shard_map`` over the mesh axes ``(x, y, z)``; here
each rank runs the same program on its own shards, and an :class:`Axis`
names one mesh axis as this rank sees it: its coordinate along the axis,
the axis size and the process group of the ranks that differ from it in
that coordinate only. A collective over an axis without a group (the
single-device step: no process group, every axis of size 1) is the
identity and makes no call.

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
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.core.precision import psum_fp32, psum_maybe_bf16


@dataclasses.dataclass(frozen=True)
class Axis:
    """One mesh axis from this rank: its coordinate ``index`` in ``[0,
    size)`` and the group of the ``size`` ranks along it (in coordinate
    order), or None without a process group (then ``size`` is 1)."""

    name: str
    index: int
    size: int
    group: Any = None


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
        dist.all_reduce(y, op=dist.ReduceOp.MAX, group=axis.group)
    return y


def _gather(x: torch.Tensor, axis: Axis, dim: int) -> torch.Tensor:
    parts = [torch.empty_like(x, memory_format=torch.contiguous_format)
             for _ in range(axis.size)]
    dist.all_gather(parts, x.contiguous(), group=axis.group)
    return torch.cat(parts, dim)


class AllGather(torch.autograd.Function):
    """Tiled all-gather along ``dim``, in coordinate order; the backward
    sums the cotangent over the group and keeps this rank's slice (the
    reference's ``psum_scatter``)."""

    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim, ctx.n = axis, dim, x.shape[dim]
        return _gather(x.detach(), axis, dim)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
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
        ctx.dst, ctx.src = dst, src
        return _exchange(x.detach(), dst, src)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.src, ctx.dst), None, None


def _exchange(x: torch.Tensor, dst: int, src: int) -> torch.Tensor:
    x = x.contiguous()
    out = torch.empty_like(x)
    reqs = dist.batch_isend_irecv([dist.P2POp(dist.isend, x, dst),
                                   dist.P2POp(dist.irecv, out, src)])
    for req in reqs:
        req.wait()
    return out


# ---------------------------------------------------------------------------
# PMM primitives
# ---------------------------------------------------------------------------

def pmm_matmul(lhs: torch.Tensor, rhs: torch.Tensor, reduce_axis: Axis,
               *, bf16: bool = False) -> torch.Tensor:
    """One 3D-PMM step: local matmul + all-reduce over ``reduce_axis``
    (the SpMM aggregation, Eq. 27, and the GEMM update, Eq. 28)."""
    return psum_maybe_bf16(lhs @ rhs, reduce_axis, bf16)


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
                   to_plane: Tuple[str, str]) -> torch.Tensor:
    """Baseline reshard: all-gather the full matrix over the source plane,
    then slice this rank's destination block (g^2 x the bytes of
    :func:`reshard_permute`)."""
    full = all_gather(t, mesh.axis(from_state.row), dim=0)
    full = all_gather(full, mesh.axis(from_state.col), dim=1)
    br, bc = t.shape
    i, j = mesh.coords[to_plane[0]], mesh.coords[to_plane[1]]
    return full[i * br:(i + 1) * br, j * bc:(j + 1) * bc].contiguous()


def reshard_permute(t: torch.Tensor, mesh, from_state: PlaneState,
                    to_plane: Tuple[str, str]) -> torch.Tensor:
    """The layer-rotation reshard as one permutation: each block moves
    once. The rank with role coordinates (row, col, rep) = (i, j, k) needs
    source block (k, i), which the rank (k, i, j) holds; so it sends its
    own block (i, j) to the rank (j, k, i)."""
    del to_plane                       # (rep, row): the rotation's plane
    roles = (from_state.row, from_state.col, from_state.rep)
    i, j, k = (mesh.coords[a] for a in roles)
    if i == j == k:
        return t
    dst = mesh.rank_at(dict(zip(roles, (j, k, i))))
    src = mesh.rank_at(dict(zip(roles, (k, i, j))))
    return Permute.apply(t, dst, src)


def reshard(t: torch.Tensor, mesh, from_state: PlaneState,
            to_plane: Tuple[str, str], impl: str = "gather") -> torch.Tensor:
    """Move ``t`` from plane (row, col) of ``from_state`` to ``to_plane``:
    ``"gather"`` or ``"permute"`` (bit-identical data movement)."""
    if (from_state.row, from_state.col) == to_plane:
        return t
    if impl == "permute":
        return reshard_permute(t, mesh, from_state, to_plane)
    return reshard_gather(t, mesh, from_state, to_plane)


