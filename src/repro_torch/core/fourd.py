"""4D parallel mini-batch GNN training (ScaleGNN §IV) over
``torch.distributed``.

Counterpart of ``repro/core/fourd.py`` and ``repro/launch/mesh.py``. The
device grid is ``(d, x, y, z)``: G_d data-parallel groups times a g x g x g
3D-PMM cube. Rank r sits at the row-major coordinates of ``(d, x, y, z)``,
the reference's device order, so it holds exactly the shards of the
reference's device r. One training step on a rank:

  1. communication-free sampling and the rank's block of each rotation
     plane (``MinibatchBuilder.build_local``);
  2. the 3D-PMM forward (``ForwardEngine``): one all-reduce per product;
  3. the distributed cross-entropy (FP32 reductions);
  4. the backward through ``torch.autograd``, in the reference's
     convention (:func:`value_and_grad`): every all-reduce transposes to an
     all-reduce, the loss each (x, y, z) rank of a group holds gets the
     cotangent ``1 / (G_d g^3)`` that ``shard_map`` gives an output
     replicated over those axes, and each parameter shard's gradient is
     summed over the axes that replicate it, ``d`` included (the paper's
     data-parallel all-reduce, §IV-A).

At 1x1x1x1 with no process group every collective is the identity and
makes no call: the step is the single-device step. A mesh of more than one
rank needs ``torch.distributed`` initialised first: NCCL for a mesh on the
cards (``device=None`` is ``cuda:LOCAL_RANK``), gloo for one on the CPU.

With compressed collectives (``TrainOptions.compress`` int8 or int4) each
quantized site carries an error-feedback accumulator (:func:`make_ef`):
the loss and :func:`value_and_grad` take it in and hand the new one out.
A checkpoint holds each as the reference's global ``(G_d, g, g, g) +
local`` array, and the §V-A prefetch carry (a ``Minibatch``) as the
reference's global arrays with a leading ``d`` dim.

The reference's training path takes dropout from ``TrainOptions.dropout``
and the fused tail from ``TrainOptions.fused_elementwise``, not from the
``GCNConfig`` fields; :func:`model_config` makes that mapping explicit.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import gcn_model as M
from repro_torch.core import pmm3d
from repro_torch.core import sampling as smp
from repro_torch.core.forward import ForwardEngine, TrainOptions
from repro_torch.core.minibatch import Minibatch, MinibatchBuilder
from repro_torch.device import resolve_device
from repro_torch.graphs.partition import PartitionedGraph, build_walk_tables
from repro_torch.obs import comm
from repro_torch.tree import (Path, flatten_with_paths, leaves, map_with_path,
                               unflatten)

AXES_4D = ("d", "x", "y", "z")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The (d, x, y, z) grid as this rank sees it: the shape, the rank's
    coordinates, its device and one process group per axis (the line of
    ranks through this rank along that axis), None without a process
    group."""

    shape: Dict[str, int]
    coords: Dict[str, int]
    device: torch.device
    rank: int = 0
    groups: Optional[Dict[str, Any]] = None

    @property
    def size(self) -> int:
        return int(np.prod([self.shape[a] for a in AXES_4D]))

    def axis(self, name: str) -> pmm3d.Axis:
        ranks = tuple(self.rank_at({name: k})
                      for k in range(self.shape[name]))
        return pmm3d.Axis(name, self.coords[name], self.shape[name],
                          None if self.groups is None else self.groups[name],
                          ranks)

    def rank_at(self, coords: Dict[str, int]) -> int:
        """The rank at this rank's coordinates with ``coords`` replaced."""
        c = dict(self.coords, **coords)
        return int(np.ravel_multi_index([c[a] for a in AXES_4D],
                                        [self.shape[a] for a in AXES_4D]))

    def barrier(self) -> None:
        """Wait for every rank (a no-op without a process group)."""
        if self.groups is not None:
            dist.all_reduce(torch.zeros(1, device=self.device))


# the backend a mesh on each device type runs over: the meta device is the
# dry run's (``launch/dryrun.py``), one rank of a fake process group
_BACKENDS = {"cuda": "nccl", "cpu": "gloo", "meta": "cpu:fake,meta:fake"}


def _mesh_device(device) -> torch.device:
    """``None`` means this process's card, ``cuda:LOCAL_RANK``; ``"meta"``
    is the dry run's device (shapes only)."""
    if device is not None and torch.device(device).type == "meta":
        return torch.device("meta")
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    return dev


def make_mesh_4d(g_d: int, g: int,
                 device: Union[str, torch.device, None] = None) -> Mesh:
    """The paper's 4D grid G_d x g x g x g on the initialised process group
    (its world size must be G_d g^3), or the single device 1x1x1x1 without
    one. Every rank creates the same groups in the same order. NCCL runs a
    mesh on the cards, gloo one on the CPU, and the fake backend
    (``"cpu:fake,meta:fake"``) one on the meta device."""
    shape = dict(zip(AXES_4D, (g_d, g, g, g)))
    n = g_d * g ** 3
    dev = _mesh_device(device)
    if not dist.is_initialized():
        if n != 1:
            raise ValueError(
                f"a {g_d}x{g}x{g}x{g} mesh needs torch.distributed "
                f"initialised with {n} ranks (torchrun --nproc_per_node {n})")
        return Mesh(shape=shape, coords=dict.fromkeys(AXES_4D, 0),
                    device=dev)
    if dist.get_world_size() != n:
        raise ValueError(f"a {g_d}x{g}x{g}x{g} mesh needs {n} ranks, the "
                         f"process group has {dist.get_world_size()}")
    backend = _BACKENDS[dev.type]
    if dist.get_backend() != backend:
        raise ValueError(f"a mesh on {dev} runs over {backend}, the process "
                         f"group uses {dist.get_backend()}")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    rank = dist.get_rank()
    dims = [shape[a] for a in AXES_4D]
    coords = dict(zip(AXES_4D, map(int, np.unravel_index(rank, dims))))
    ids = np.arange(n).reshape(dims)
    groups = {}
    for k, a in enumerate(AXES_4D):
        lines = np.moveaxis(ids, k, -1).reshape(-1, shape[a])
        for line in lines:                   # every rank, the same order
            grp = dist.new_group(ranks=[int(r) for r in line])
            if rank in line:
                groups[a] = grp
    return Mesh(shape=shape, coords=coords, device=dev, rank=rank,
                groups=groups)


# ---------------------------------------------------------------------------
# Parameter and data layouts
# ---------------------------------------------------------------------------

def param_specs(num_layers: int) -> Dict[str, Any]:
    """The mesh axis each parameter dim is sharded over, in the structure
    of ``gcn_model.init_params``: w_in on (z, y); layer l's weight on
    (c_l, r_l) and its RMSNorm scale over r_l; w_out on (c_L, p_L). The
    axes a leaf's spec leaves out replicate it."""
    st = pmm3d.initial_state()
    layers = []
    for _ in range(num_layers):
        layers.append({"w": st.weight_plane, "rms_scale": (st.row,)})
        st = st.rotate()
    return {"w_in": ("z", "y"), "w_out": (st.col, st.rep), "layers": layers}


def padded_class_count(num_classes: int, g: int) -> int:
    """Class count ceil-padded to the grid side — how the output head pads
    so that it shards evenly."""
    return -(-num_classes // g) * g


def pad_output_head(params, num_classes: int, g: int):
    """Zero-pad ``w_out``'s class columns to a multiple of the grid side
    (logits of padded classes are masked out of the loss and the argmax,
    so padding is arithmetic-neutral). Returns (params', padded count)."""
    n_pad = padded_class_count(num_classes, g)
    w = params["w_out"]
    if w.shape[1] == n_pad:
        return params, n_pad
    out = dict(params)
    out["w_out"] = torch.cat([w, w.new_zeros((w.shape[0],
                                              n_pad - w.shape[1]))], dim=1)
    return out, n_pad


def model_config(cfg: M.GCNConfig, opts: TrainOptions) -> M.GCNConfig:
    """The model the training step runs: dropout from ``opts.dropout``,
    the fused tail kernel iff ``opts.fused_elementwise``, the aggregation
    from ``opts.spmm_impl``."""
    return dataclasses.replace(
        cfg, dropout=opts.dropout, spmm_impl=opts.spmm_impl,
        elementwise_impl="cuda" if opts.fused_elementwise else "torch")


@dataclasses.dataclass
class FourDPlan:
    """Everything one training run needs: mesh, configs, the builder."""

    mesh: Mesh
    cfg: M.GCNConfig
    scfg: smp.SampleConfig
    opts: TrainOptions
    builder: MinibatchBuilder
    num_classes_padded: int
    # the fused tail's dropout route (``ForwardEngine.draw_in_tail``)
    draw_in_tail: Optional[bool] = None

    @property
    def grid_side(self) -> int:
        return self.scfg.g

    @property
    def device(self) -> torch.device:
        return self.mesh.device

    def engine(self, *, backend: Optional[str] = None,
               csr_rows: int = 0) -> ForwardEngine:
        """The layer-loop executor of this plan (``core/forward.py``)."""
        return ForwardEngine.from_options(
            model_config(self.cfg, self.opts), self.opts, self.mesh,
            backend=backend, csr_rows=csr_rows,
            draw_in_tail=self.draw_in_tail)

    # -- shards of parameter-shaped trees -------------------------------------

    def spec_of(self, path: Path) -> Tuple[Optional[str], ...]:
        """The sharding of the leaf at ``path`` in a tree that holds params
        (params, grads, optimizer moments, a ``TrainState``): the mesh axis
        of each dim of its global array (None: whole), () for a replicated
        leaf (a step counter). A parameter's is the spec of the parameter
        its path ends in; the carries of a ``TrainState`` add leading dims
        (:meth:`lead_dims`): an EF accumulator is (d, x, y, z) + its local
        shape, a prefetched ``Minibatch`` leaf ``d`` + its plane (the
        reference's layouts)."""
        if path and path[0] == ".comm_ef":
            return AXES_4D + (None, None)
        if path and path[0] == ".minibatch":
            if path[1] == ".feats":
                return ("d", "x", "z")
            if path[1] == ".labels":
                return ("d", pmm3d.state_after_layers(
                    self.cfg.num_layers).row)
            st = pmm3d.initial_state()
            for _ in range(int(path[2])):
                st = st.rotate()
            return ("d",) + st.adj_plane + (None, None)
        specs = param_specs(self.cfg.num_layers)
        if path and path[-1] in ("w_in", "w_out"):
            return specs[path[-1]]
        if len(path) >= 3 and path[-3] == "layers":
            return specs["layers"][int(path[-2])][path[-1]]
        return ()

    @staticmethod
    def lead_dims(path: Path) -> int:
        """How many leading dims the global array of the leaf at ``path``
        has that a rank's shard has not: 4 for an EF accumulator, 1 for the
        prefetch carry, else 0."""
        return {".comm_ef": 4, ".minibatch": 1}.get(path[0] if path else "",
                                                    0)

    def shard(self, tree):
        """This rank's shards of a tree of global (unsharded) leaves, on
        the plan's device; ``w_out``-shaped leaves are zero-padded to the
        padded class count first. A replicated leaf (a step counter) is
        returned as it is, and at g = 1 so is a parameter already on the
        device."""
        def one(path, t):
            if not self.spec_of(path):
                return t
            t = t.to(self.device)
            if path and path[-1] == "w_out":
                t = pad_output_head({"w_out": t}, self.cfg.num_classes,
                                    self.grid_side)[0]["w_out"]
            for dim, a in enumerate(self.spec_of(path)):
                if a is not None and self.mesh.shape[a] > 1:
                    n = t.shape[dim] // self.mesh.shape[a]
                    t = t.narrow(dim, self.mesh.coords[a] * n, n)
            lead = self.lead_dims(path)
            if lead:
                t = t.reshape(t.shape[lead:])
            return t.contiguous()
        return map_with_path(one, tree)

    @torch.no_grad()
    def unshard(self, tree):
        """The global leaves of a tree of shards (every rank takes part in
        the gathers and gets the whole tree), the head's class padding cut
        off: the inverse of :meth:`shard`."""
        def one(path, t):
            lead = self.lead_dims(path)
            if lead:
                t = t.reshape((1,) * lead + tuple(t.shape))
            for dim, a in enumerate(self.spec_of(path)):
                if a is not None:
                    t = pmm3d.all_gather(t, self.mesh.axis(a), dim)
            if path and path[-1] == "w_out":
                t = t[:, :self.cfg.num_classes]
            return t
        return map_with_path(one, tree)

    def shard_params(self, params):
        """This rank's shards of the global params (``init_params``)."""
        return self.shard(params)

    def reduce_grads(self, grads):
        """Sum each gradient shard over the axes that replicate its
        parameter (``d`` included): one all-reduce per axis over the leaves
        it replicates, flattened together."""
        paths = [p for p, _ in flatten_with_paths(grads)]
        flat = leaves(grads)
        for a in AXES_4D:
            axis = self.mesh.axis(a)
            idx = [k for k, p in enumerate(paths)
                   if a not in self.spec_of(p)]
            if axis.group is None or not idx:
                continue
            buf = torch.cat([flat[k].reshape(-1) for k in idx])
            comm.record("all-reduce", buf)
            dist.all_reduce(buf, group=axis.group)
            for k, part in zip(idx, buf.split([flat[k].numel()
                                               for k in idx])):
                flat[k] = part.view_as(flat[k])
        return unflatten(grads, flat)

    def global_sumsq(self, grads) -> torch.Tensor:
        """The squared global norm of a gradient tree of shards: each
        leaf's local sum of squares, summed over the axes that shard it
        (each distinct shard counts once), then over the leaves in order."""
        paths = [p for p, _ in flatten_with_paths(grads)]
        sq = [torch.sum(torch.square(g)) for g in leaves(grads)]
        for a in AXES_4D:
            axis = self.mesh.axis(a)
            idx = [k for k, p in enumerate(paths) if a in self.spec_of(p)]
            if axis.group is None or not idx:
                continue
            buf = torch.stack([sq[k] for k in idx])
            comm.record("all-reduce", buf)
            dist.all_reduce(buf, group=axis.group)
            for k, v in zip(idx, buf.unbind()):
                sq[k] = v
        return sum(sq)

    def plane_blocks(self) -> Tuple[Tuple[int, int], ...]:
        """The (i, j) CSR block of each rotation plane on this rank: blocks
        (z, x), (y, z), (x, y) of the layer program's planes."""
        c, st, out = self.mesh.coords, pmm3d.initial_state(), []
        for _ in range(3):
            out.append(tuple(c[a] for a in st.adj_plane))
            st = st.rotate()
        return tuple(out)

    def shard_graph(self, pg: PartitionedGraph) -> Dict[str, Any]:
        """This rank's graph arrays on the plan's device: ``adj``, the CSR
        block of each rotation plane (block (z, x), (y, z), (x, y): one
        tensor triple per distinct block), the feature rows of range x and
        columns of slice z, and the labels of the final row axis's range.
        Walk mode adds its replicated tables under ``"walk"``: the in-range
        neighbor table ``nbr`` and the inclusion estimate ``p = min(1,
        b_local * p_tilde)`` of the SAINT rescale."""
        c, g, n_loc = self.mesh.coords, self.grid_side, pg.n_local
        # a read-only mmap shard is copied (np.require "W"), not aliased
        t = lambda a: torch.from_numpy(np.require(a, requirements="CW")).to(
            self.device)
        planes = self.plane_blocks()
        blocks = {(i, j): (t(pg.block_rp[i, j]), t(pg.block_ci[i, j]),
                           t(pg.block_val[i, j])) for i, j in set(planes)}
        adj = [blocks[ij] for ij in planes]
        d_loc = pg.feature_dim // g
        r_f = c[pmm3d.state_after_layers(self.cfg.num_layers).row]
        out = {"adj": tuple(adj),
               "features": t(pg.features[c["x"] * n_loc:(c["x"] + 1) * n_loc,
                                         c["z"] * d_loc:(c["z"] + 1)
                                         * d_loc]),
               "labels": t(pg.labels[r_f * n_loc:(r_f + 1) * n_loc])}
        if self.builder.mode == "walk":
            nbr, p_tilde = build_walk_tables(pg, k=self.scfg.walk_k)
            p = torch.clamp(self.scfg.b_local * t(p_tilde), max=1.0)
            out["walk"] = {"nbr": t(nbr), "p": p}
        return out


def build_plan(pg: PartitionedGraph, cfg: M.GCNConfig, mesh: Mesh,
               batch: int, opts: TrainOptions = TrainOptions(),
               e_cap: Optional[int] = None) -> FourDPlan:
    """The plan of a training run on ``mesh``: the sample configuration
    (``e_cap`` defaults to the per-range batch times the largest row of
    any block, which truncates nothing), the builder, the padded class
    count. ``opts.sample_kind`` "partition" takes its clusters from the
    options or the graph, tightens ``e_cap`` to q whole clusters' worth of
    block nnz and, under the epoch schedule, slices one cluster
    permutation across the mesh's DP groups; "walk" takes the walk's
    length and table width from the options."""
    g = mesh.shape["x"]
    if mesh.shape["y"] != g or mesh.shape["z"] != g:
        raise ValueError("the ScaleGNN path needs a cube 3D grid")
    if pg.g != g:
        raise ValueError("graph partitioned for a different grid side")
    if batch % g:
        raise ValueError("batch must divide evenly across vertex ranges")
    if cfg.d_hidden % g or cfg.d_in % g:
        raise ValueError("d_in and d_hidden must be divisible by the grid "
                         "side")
    b = batch // g
    clusters = walk_len = walk_k = 0
    dp_groups = 1
    if opts.sample_kind == "partition":
        clusters = opts.clusters or pg.clusters
        if clusters <= 0:
            raise ValueError(
                "sample_kind='partition' needs a clustered graph: "
                "build_partitioned_graph(..., clusters=C) or set "
                "TrainOptions.clusters")
        cs = pg.n_local // clusters
        if e_cap is None and cs > 0 and b % cs == 0 \
                and pg.max_cluster_block_nnz > 0:
            # q whole clusters per range bound a block's nnz far tighter
            # than b * max_block_row_nnz
            e_cap = max((b // cs) * pg.max_cluster_block_nnz, 1)
        if opts.sample_mode == "epoch":
            dp_groups = mesh.shape["d"]
    elif opts.sample_kind == "walk":
        walk_len, walk_k = opts.walk_len, opts.walk_k
    e_cap = e_cap or b * max(pg.max_block_row_nnz, 1)
    scfg = smp.SampleConfig(n_pad=pg.n_pad, g=g, batch=batch, e_cap=e_cap,
                            clusters=clusters, dp_groups=dp_groups,
                            walk_len=walk_len, walk_k=walk_k).validate()
    builder = MinibatchBuilder.from_options(
        scfg, opts, max_row_nnz=max(pg.max_block_row_nnz, 1))
    plan = FourDPlan(mesh=mesh, cfg=cfg, scfg=scfg, opts=opts,
                     builder=builder,
                     num_classes_padded=padded_class_count(cfg.num_classes,
                                                           g))
    plan.engine()                  # the engine's own checks (int4 widths)
    return plan


# ---------------------------------------------------------------------------
# Error-feedback accumulators (compressed collectives)
# ---------------------------------------------------------------------------

def ef_local_shapes(plan: FourDPlan) -> Dict[str, tuple]:
    """site -> this rank's EF shape for the plan's training batch."""
    return plan.engine().ef_site_shapes(plan.scfg.batch // plan.grid_side)


def make_ef(plan: FourDPlan) -> Optional[Dict[str, torch.Tensor]]:
    """Zero float32 EF accumulators, one per quantized site, this rank's
    own, on the plan's device; None when no wire is quantized."""
    shapes = ef_local_shapes(plan)
    if not shapes:
        return None
    return {site: torch.zeros(shp, dtype=torch.float32, device=plan.device)
            for site, shp in shapes.items()}


class LossFn:
    """The loss of a plan's step. ``local(...)`` is this rank's group loss
    (replicated over x, y and z), differentiable; calling the object gives
    the (G_d,) per-group losses, gathered over ``d``. ``ids`` injects this
    rank's DP group's (g, b) sample in place of drawing it from ``(seed,
    epoch, step, d)``; ``mb`` gives the batch itself (the §V-A carry), and
    ``ef`` the error-feedback accumulators, in which case the loss comes
    with the new ones: ``(loss, new_ef)``. ``step`` and ``epoch`` are
    Python ints or the device counters of a ``TrainState``, which no call
    here reads on the host (a CUDA graph captures the step whole)."""

    def __init__(self, plan: FourDPlan, train: bool):
        self.plan, self.train = plan, train
        self.engine = plan.engine()

    def sample(self, graph, step, epoch=None, *, ids=None) -> Minibatch:
        """This rank's batch of ``step`` (Alg. 2, no communication)."""
        plan = self.plan
        return plan.builder.build_local(
            graph["adj"], graph["features"], graph["labels"], step,
            plan.cfg.num_layers, plan.mesh.coords, epoch=epoch, ids=ids,
            aux=graph.get("walk"))

    def local(self, params, graph, step, epoch=None, *, ids=None,
              mb: Optional[Minibatch] = None, ef=None):
        mesh = self.plan.mesh
        if mb is None:
            mb = self.sample(graph, step, epoch, ids=ids)
        out = self.engine(params, mb.adj, mb.feats, step=step,
                          train=self.train, ef=ef)
        logits, st = out[:2]
        nll_sum, cnt = pmm3d.parallel_cross_entropy(
            logits, mb.labels, class_axis=mesh.axis(st.rep),
            row_axis=mesh.axis(st.row), n_classes=self.plan.cfg.num_classes)
        loss = nll_sum / torch.clamp(cnt, min=1.0)
        return loss if ef is None else (loss, out[2])

    @torch.no_grad()
    def __call__(self, params, graph, step, epoch=None, *, ids=None,
                 mb: Optional[Minibatch] = None, ef=None):
        out = self.local(params, graph, step, epoch, ids=ids, mb=mb, ef=ef)
        loss = out if ef is None else out[0]
        losses = pmm3d.all_gather(loss[None], self.plan.mesh.axis("d"))
        return losses if ef is None else (losses, out[1])


def make_loss_fn(plan: FourDPlan, *, train: bool = True) -> LossFn:
    """The plan's loss: per-group losses, and the differentiable local
    loss that :func:`value_and_grad` takes."""
    return LossFn(plan, train)


def value_and_grad(loss_fn: LossFn, params, graph, step, epoch=None, *,
                   ids=None, mb: Optional[Minibatch] = None, ef=None):
    """The mean over ``d`` of the per-group losses and its gradient, as
    shards in the structure of ``params`` (whose leaves are set to require
    grad), in the reference's convention: this rank's loss gets the
    cotangent ``1 / (G_d g^3)``, the all-reduces transpose to all-reduces,
    and each shard's gradient is summed over the axes that replicate it.
    With ``ef`` it returns ``(loss, grads, new_ef)``."""
    plan = loss_fn.plan
    flat = leaves(params)
    for p in flat:
        p.requires_grad_(True)
    with torch.enable_grad():
        out = loss_fn.local(params, graph, step, epoch, ids=ids, mb=mb,
                            ef=ef)
        loss = out if ef is None else out[0]
        scaled = loss if plan.mesh.size == 1 else loss / plan.mesh.size
        grads = torch.autograd.grad(scaled, flat)
    grads = plan.reduce_grads(unflatten(params, list(grads)))
    losses = pmm3d.all_gather(loss.detach()[None], plan.mesh.axis("d"))
    if ef is None:
        return losses.mean(), grads
    return losses.mean(), grads, {k: v.detach() for k, v in out[1].items()}


def make_train_step(plan: FourDPlan, optimizer):
    """``(params, opt_state, graph, step, *, ids=None) -> (params,
    opt_state, loss)`` on this rank's shards; ``step`` is an int or a
    device counter. The optimizer updates
    ``params`` in place (clipping by the global norm over the shards) and
    returns the same tensors. Under a quantized ``compress`` this step runs
    without error feedback (zero accumulators every step); the carry lives
    in ``train.Trainer``."""
    loss_fn = make_loss_fn(plan, train=True)

    def train_step(params, opt_state, graph, step, *, ids=None):
        loss, grads = value_and_grad(loss_fn, params, graph, step, ids=ids)
        params, opt_state = optimizer.update(params, grads, opt_state,
                                             sumsq=plan.global_sumsq)
        return params, opt_state, loss
    return train_step


def make_eval_step(plan: FourDPlan):
    """Full-graph evaluation (paper Table II): one 3D-PMM forward over the
    whole graph — no sampling — with the CSR aggregation over each rank's
    blocks, returning the accuracy over every vertex with a label (ghosts
    excluded)."""
    engine = plan.engine(backend="csr", csr_rows=plan.scfg.n_local)
    mesh, n_cls = plan.mesh, plan.cfg.num_classes

    @torch.no_grad()
    def eval_step(params, graph):
        planes = graph["adj"][:min(3, plan.cfg.num_layers)]
        logits, st = engine(params, planes, graph["features"], step=0,
                            train=False)
        correct, total = pmm3d.parallel_argmax_correct(
            logits, graph["labels"], class_axis=mesh.axis(st.rep),
            row_axis=mesh.axis(st.row), n_classes=n_cls)
        return correct / torch.clamp(total, min=1.0)
    return eval_step
