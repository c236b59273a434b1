"""Sharding rules for the assigned architectures on the LLM production
mesh, the mesh itself, and the collectives of the sharded step.

Counterpart of ``repro/models/sharding.py``. The mesh is ``("data",
"model")`` on one pod or ``("pod", "data", "model")`` across two: the DP
axes (pod x data) replicate the step over independent batch rows, as the
paper's G_d does, and ``model`` is the tensor axis. The parameter rules
(Megatron-style, every sharded dim divisible by |model| = 16 at all ten
configs, the tests check the reference's specs leaf for leaf):

  embed (Vp, D)            -> P(model, fsdp)       Vp padded to 128x
  lm_head (D, Vp)          -> P(fsdp, model)
  attn wq/wk/wv (D, H*hd)  -> P(fsdp, model)       flattened head dim
  attn wo (H*hd, D)        -> P(model, fsdp)
  mlp in (D, F)            -> P(fsdp, model); out (F, D) -> P(model, fsdp)
  MoE experts (E, D, F)    -> P(model, fsdp, None) when E % |model| == 0,
                              else P(None, fsdp, model)
  mamba in_proj            -> P(fsdp, model); out_proj -> P(model, fsdp)
  norms / gates / scalars  -> replicated

with ``fsdp`` the DP axes when the step shards the other large dim over
them too (ZeRO-3, the configs above 3e9 parameters) and the dim divides,
else None. A spec is a :class:`P`: a tuple with one entry a dim, each
None, an axis name or a tuple of names (a 1-tuple is its name, as JAX's
``PartitionSpec`` normalises it). The rules walk the port's
``transformer.param_tree``, whose stacked groups (``blocks``,
``cross_blocks``, ``enc_blocks``) hold each leaf as the list of its layers'
tensors: such a leaf is one stacked array with a leading layer dim, and
gets one spec whose first entry is None. Any object with an ordered
``.shape`` (name -> size) and ``.axis_names`` is a mesh here, the
reference's ``AbstractMesh`` included.

Where the reference hands ``named`` specs to GSPMD, the port places the
blocks itself: :func:`shard` cuts each leaf to this rank's block,
:func:`unshard` gathers it back. :class:`LLMMesh` is the mesh as one rank
sees it, with one process group per axis line, per DP-axes set and for
the whole mesh (``dist.new_group``, as ``core/fourd.py`` builds the 4D
mesh's), and :func:`gather_weight` the just-in-time gather of a block
whose backward sums the gradient onto the block: a reduce-scatter over
each gathered axis, then an all-reduce over the axes the spec replicates
the leaf on. The sharded step itself is ``models/sharded.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import fourd, pmm3d
from repro_torch.models.config import ModelConfig
from repro_torch.obs import comm

STACKED = ("blocks", "cross_blocks", "enc_blocks")


class P(tuple):
    """A partition spec: one entry a dim, each None, an axis name or a
    tuple of names (a 1-tuple becomes its name)."""

    def __new__(cls, *entries):
        return super().__new__(cls, tuple(
            e[0] if isinstance(e, tuple) and len(e) == 1 else e
            for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


def _names(entry) -> Tuple[str, ...]:
    """The axis names of a spec entry, in order (none for None)."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def dp_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def model_axis_size(mesh) -> int:
    return dict(mesh.shape).get("model", 1)


def _axes_size(mesh, names: Sequence[str]) -> int:
    shape = dict(mesh.shape)
    return int(np.prod([shape[a] for a in names])) if names else 1


# ---------------------------------------------------------------------------
# The rules
# ---------------------------------------------------------------------------

def _rule_for_path(path: str, shape: Tuple[int, ...], cfg: ModelConfig,
                   tp: int, fsdp: Optional[Tuple[str, ...]] = None,
                   fsdp_size: int = 1) -> P:
    """The spec of the parameter at ``path`` (its keys joined by ``::``)
    of ``shape`` (stacked leaves with their leading layer dim)."""
    ndim = len(shape)
    stacked = path.split("::", 1)[0] in STACKED
    lead = (None,) if stacked else ()
    base_ndim = ndim - len(lead)

    def spec(*axes):
        assert len(axes) == base_ndim, (path, shape, axes)
        return P(*(lead + axes))

    def div(i: int) -> bool:
        return shape[len(lead) + i] % tp == 0

    def fdiv(i: int):
        """The FSDP axes if that dim divides, else None."""
        if fsdp and shape[len(lead) + i] % fsdp_size == 0:
            return fsdp
        return None

    last = path.rsplit("::", 1)[-1]
    if path == "embed":
        row = "model" if shape[0] % tp == 0 else None
        return P(row, fdiv(1) if row else None)
    if path == "lm_head":
        col = "model" if shape[1] % tp == 0 else None
        return P(fdiv(0) if col else None, col)
    if last in ("wq", "wk", "wv", "wg", "wu", "w1", "in_proj"):
        if base_ndim == 3:                       # MoE experts (E, D, F)
            if shape[len(lead)] % tp == 0:
                return spec("model", fdiv(1), None)
            return spec(None, fdiv(1), "model") if div(2) else \
                spec(None, None, None)
        if div(1):
            return spec(fdiv(0), "model")
        return spec(None, None)
    if last in ("wo", "wd", "w2", "out_proj"):
        if base_ndim == 3:                       # MoE experts (E, F, D)
            if shape[len(lead)] % tp == 0:
                return spec("model", None, fdiv(2))
            return spec(None, "model", fdiv(2)) if div(1) else \
                spec(None, None, None)
        if div(0):
            return spec("model", fdiv(1))
        return spec(None, None)
    if last in ("bq", "bk", "bv", "b1"):
        return spec("model") if div(0) else spec(None)
    if last == "conv_w":
        return spec("model", None) if div(0) else spec(None, None)
    if last == "router":
        return spec(None, None)
    # norms, biases on d_model, gates, a_log, d_skip, dt_bias, scalars
    return spec(*([None] * base_ndim))


def _tree_like(tree: Any, fn) -> Any:
    """``tree`` with each stacked leaf replaced by ``fn(path, leaf,
    shape)``."""
    def walk(node, prefix):
        if isinstance(node, dict):
            return {k: walk(v, prefix + (str(k),)) for k, v in node.items()}
        shape = ((len(node),) + tuple(node[0].shape)
                 if isinstance(node, (list, tuple)) else tuple(node.shape))
        return fn(prefix, node, shape)
    return walk(tree, ())


def param_pspecs(cfg: ModelConfig, mesh, params_tree: Any,
                 fsdp: bool = False) -> Any:
    """The spec tree of ``params_tree`` (``transformer.param_tree``, real
    or on the meta device): its dicts, with one :class:`P` a leaf (a
    stacked leaf's list gets one)."""
    tp = model_axis_size(mesh)
    fa = dp_axes(mesh) if fsdp else None
    fsz = _axes_size(mesh, fa or ())
    return _tree_like(params_tree, lambda path, _, shape: _rule_for_path(
        "::".join(path), shape, cfg, tp, fa, fsz))


def _dp_entry(mesh, batch: int):
    axes = dp_axes(mesh)
    if axes and batch % _axes_size(mesh, axes) == 0:
        return axes if len(axes) > 1 else axes[0]
    return None


def batch_pspec(mesh, batch: int, extra_dims: int = 1) -> P:
    """Spec for a (batch, ...) array: batch over the DP axes when it
    divides, else replicated."""
    dp = _dp_entry(mesh, batch)
    if dp is not None:
        return P(dp, *([None] * extra_dims))
    return P(*([None] * (1 + extra_dims)))


def cache_pspecs(cfg: ModelConfig, mesh, cache_tree: Any, batch: int) -> Any:
    """Specs of the decode cache (``transformer.init_cache``): the batch
    dim (index 1 of the stacked (L, B, ...) arrays) over DP; the KV heads,
    or else the head dim, over ``model`` when it divides; the SSM state's
    heads and the conv channels over ``model`` when they divide."""
    tp = model_axis_size(mesh)
    dp = _dp_entry(mesh, batch)

    def rule(path, leaf):
        shape = tuple(leaf.shape)
        nd = len(shape)
        if nd == 0:
            return P()
        key = "::".join(path)
        last = path[-1]
        if last in ("k", "v"):                           # (L, B, T, KV, hd)
            if shape[3] % tp == 0:
                return P(None, dp, None, "model", None)
            if shape[4] % tp == 0:
                return P(None, dp, None, None, "model")
            return P(None, dp, None, None, None)
        if key.startswith("ssm"):                        # (L, B, nh, hd, N)
            return P(None, dp, "model" if shape[2] % tp == 0 else None,
                     None, None)
        if key.startswith("conv"):                       # (L, B, K-1, C)
            return P(None, dp, None, "model" if shape[3] % tp == 0 else None)
        return P(*([None] * nd))

    def walk(node, prefix):
        if isinstance(node, dict):
            return {k: walk(v, prefix + (str(k),)) for k, v in node.items()}
        return rule(prefix, node)
    return walk(cache_tree, ())


# ---------------------------------------------------------------------------
# The mesh as one rank sees it
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LLMMesh:
    """The LLM mesh from this rank: its ordered ``shape`` (axis name ->
    size), its coordinates, its device and rank, and one
    ``pmm3d.Axis`` for each set of axes a collective runs over (each axis,
    the DP axes together, all of them), keyed by the sorted names; an
    axis set of one rank has no group."""

    shape: Dict[str, int]
    coords: Dict[str, int]
    device: torch.device
    rank: int = 0
    axes: Dict[Tuple[str, ...], pmm3d.Axis] = dataclasses.field(
        default_factory=dict)

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(self.shape)

    @property
    def size(self) -> int:
        return int(np.prod(list(self.shape.values())))

    def axis(self, names) -> pmm3d.Axis:
        """The axis of a spec entry (a name, a tuple of names), or of any
        set of the mesh's axes."""
        key = tuple(sorted(_names(names) if not isinstance(names, set)
                           else names))
        return self.axes[key]

    def index(self, entry) -> Tuple[int, int]:
        """(this rank's block index, the number of blocks) of a dim whose
        spec entry is ``entry``: the row-major coordinate over its axes,
        in the entry's order."""
        names = _names(entry)
        idx, n = 0, 1
        for a in names:
            idx, n = idx * self.shape[a] + self.coords[a], n * self.shape[a]
        return idx, n


def _axis_sets(axis_names: Sequence[str]) -> List[Tuple[str, ...]]:
    """The axis sets the step's collectives run over, in mesh order: each
    axis, the DP axes together (when there are two), all of them."""
    sets = [(a,) for a in axis_names]
    dp = tuple(a for a in axis_names if a in ("pod", "data"))
    if len(dp) > 1:
        sets.append(dp)
    if len(axis_names) > 1:
        sets.append(tuple(axis_names))
    return sets


def make_llm_mesh(shape: Sequence[int], axis_names: Sequence[str],
                  device=None) -> LLMMesh:
    """The mesh of ``shape`` over the initialised process group (its world
    size must be the product), or the single device of an all-ones shape
    without one. Every rank creates the same groups in the same order:
    NCCL on the cards, gloo on the CPU, the fake backend on the meta
    device (``core/fourd.py``'s rules)."""
    shape = dict(zip(axis_names, (int(s) for s in shape)))
    n = int(np.prod(list(shape.values())))
    dev = fourd._mesh_device(device)
    names = tuple(shape)

    def axis(key, index, size, group=None, ranks=()):
        return pmm3d.Axis("+".join(key), index, size, group, ranks)

    if not dist.is_initialized():
        if n != 1:
            raise ValueError(
                f"a {tuple(shape.values())} mesh needs torch.distributed "
                f"initialised with {n} ranks (torchrun --nproc_per_node {n})")
        return LLMMesh(shape=shape, coords=dict.fromkeys(names, 0),
                       device=dev, axes={tuple(sorted(s)): axis(s, 0, 1)
                                         for s in _axis_sets(names)})
    if dist.get_world_size() != n:
        raise ValueError(f"a {tuple(shape.values())} mesh needs {n} ranks, "
                         f"the process group has {dist.get_world_size()}")
    backend = fourd._BACKENDS[dev.type]
    if dist.get_backend() != backend:
        raise ValueError(f"a mesh on {dev} runs over {backend}, the process "
                         f"group uses {dist.get_backend()}")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    rank = dist.get_rank()
    dims = list(shape.values())
    coords = dict(zip(names, map(int, np.unravel_index(rank, dims))))
    ids = np.arange(n).reshape(dims)
    axes = {}
    for s in _axis_sets(names):
        pos = [names.index(a) for a in s]
        size = int(np.prod([shape[a] for a in s]))
        index = int(np.ravel_multi_index([coords[a] for a in s],
                                         [shape[a] for a in s]))
        lines = np.moveaxis(ids, pos, list(range(len(dims) - len(s),
                                                 len(dims)))
                            ).reshape(-1, size)
        mine = None
        for line in lines:                       # every rank, same order
            ranks = tuple(int(r) for r in line)
            grp = dist.new_group(ranks=list(ranks)) if size > 1 else None
            if rank in ranks:
                mine = axis(s, index, size, grp, ranks)
        axes[tuple(sorted(s))] = mine
    return LLMMesh(shape=shape, coords=coords, device=dev, rank=rank,
                   axes=axes)


# ---------------------------------------------------------------------------
# Blocks: shard, unshard and the just-in-time gather
# ---------------------------------------------------------------------------

def block(x: torch.Tensor, spec: Sequence, mesh: LLMMesh) -> torch.Tensor:
    """This rank's block of ``x`` under ``spec`` (a new tensor)."""
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        idx, n = mesh.index(entry)
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not divide "
                             f"over {entry!r} ({n} blocks)")
        size = x.shape[dim] // n
        x = x.narrow(dim, idx * size, size)
    return x.clone()


def _layer_spec(spec: P) -> P:
    """A stacked leaf's spec without its layer dim."""
    if spec[0] is not None:
        raise ValueError(f"a stacked leaf's layer dim is not sharded: {spec}")
    return P(*spec[1:])


def shard(tree: Any, specs: Any, mesh: LLMMesh) -> Any:
    """``tree`` (a parameter tree, stacked leaves as lists of layers, or a
    cache tree) with each leaf cut to this rank's block under ``specs``."""
    def walk(node, sp):
        if isinstance(node, dict):
            return {k: walk(v, sp[k]) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [block(x, _layer_spec(sp), mesh) for x in node]
        return block(node, sp, mesh)
    return walk(tree, specs)


def _all_gather(x: torch.Tensor, axis: pmm3d.Axis, dim: int
                ) -> torch.Tensor:
    """``x`` of every rank along ``axis``, concatenated along ``dim``, in
    coordinate order: one all-gather into one buffer (a list of
    ``axis.size`` parts and their concatenation would be a call each, 256
    at the production mesh's FSDP axes), then one copy where ``dim`` is
    not the leading dim."""
    if axis.group is None:
        return x
    x = x.contiguous()
    out = torch.empty((axis.size * x.shape[0], *x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    comm.record("all-gather", x, times=axis.size)
    dist.all_gather_into_tensor(out, x, group=axis.group)
    if dim == 0:
        return out
    return out.unflatten(0, (axis.size, x.shape[0])).movedim(0, dim) \
        .flatten(dim, dim + 1)


def _reduce_scatter(g: torch.Tensor, axis: pmm3d.Axis, dim: int
                    ) -> torch.Tensor:
    """The sum over ``axis`` of ``g``, this rank's block along ``dim``."""
    if axis.group is None:
        return g
    chunks = [c.contiguous() for c in g.chunk(axis.size, dim)]
    out = torch.empty_like(chunks[0])
    comm.record("reduce-scatter", out)
    dist.reduce_scatter(out, chunks, group=axis.group)
    return out


def _all_reduce(g: torch.Tensor, axis: pmm3d.Axis) -> torch.Tensor:
    if axis.group is None:
        return g
    g = g.contiguous()
    comm.record("all-reduce", g)
    dist.all_reduce(g, group=axis.group)
    return g


def gather_full(x: torch.Tensor, spec: Sequence, mesh: LLMMesh
                ) -> torch.Tensor:
    """The whole of a leaf from this rank's block (no autograd)."""
    for dim, entry in enumerate(spec):
        if entry is not None:
            x = _all_gather(x, mesh.axis(entry), dim)
    return x


def unshard(tree: Any, specs: Any, mesh: LLMMesh) -> Any:
    """The inverse of :func:`shard`: every leaf whole, on every rank."""
    def walk(node, sp):
        if isinstance(node, dict):
            return {k: walk(v, sp[k]) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            ls = _layer_spec(sp)
            return [gather_full(x.detach(), ls, mesh) for x in node]
        return gather_full(node.detach(), sp, mesh)
    with torch.no_grad():
        return walk(tree, specs)


def _replicated(spec: Sequence, mesh: LLMMesh) -> Tuple[str, ...]:
    used = {a for e in spec for a in _names(e)}
    return tuple(a for a in mesh.axis_names if a not in used)


class GatherWeight(torch.autograd.Function):
    """A block gathered whole over the axes of its spec (scope
    ``"weights"``, one all-gather a sharded dim); the backward sums the
    gradient over those axes onto the block (a reduce-scatter a dim, in
    reverse order) and all-reduces it over the axes the spec replicates
    the leaf on (scope ``"grads"``): every rank's contribution, once."""

    @staticmethod
    def forward(ctx, x, spec, mesh):
        ctx.spec, ctx.mesh = spec, mesh
        with comm.scope("weights"):
            return gather_full(x.detach(), spec, mesh)

    @staticmethod
    def backward(ctx, g):
        spec, mesh = ctx.spec, ctx.mesh
        with comm.scope("grads"):
            for dim in reversed(range(len(spec))):
                if spec[dim] is not None:
                    g = _reduce_scatter(g, mesh.axis(spec[dim]), dim)
            rest = _replicated(spec, mesh)
            if rest:
                g = _all_reduce(g, mesh.axis(set(rest)))
        return g, None, None


def gather_weight(x: torch.Tensor, spec: Sequence, mesh: LLMMesh
                  ) -> torch.Tensor:
    """The whole leaf for the step, from this rank's block (see
    :class:`GatherWeight`); the identity, and no call, on a mesh of one
    rank."""
    if mesh.size == 1:
        return x
    return GatherWeight.apply(x, P(*spec), mesh)


def all_reduce_sum(x: torch.Tensor, mesh: LLMMesh, scope: str
                   ) -> torch.Tensor:
    """The sum of ``x`` over every rank of the mesh, outside autograd."""
    with comm.scope(scope):
        return _all_reduce(x.detach().clone(), mesh.axis(set(mesh.axis_names)))
