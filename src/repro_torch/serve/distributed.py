"""GNN serving over the 4D mesh: one process per rank, rank 0 the front.

Counterpart of ``repro/serve/distributed.py``, with its names
(:func:`make_serve_mesh`, :func:`partition_for_serving`,
:class:`DistributedServePlan`, :func:`build_serve_plan`). The single-device
engine assembles one ``(total, total)`` block and runs the GCN; over the
mesh the same work is split as the 4D training step splits it:

* the request batch is planned on the host into ``total / g`` vertices per
  contiguous vertex range (``assembler.plan_batch_ranges``), so every
  rank's block has a fixed shape;
* each rank extracts its ``(b_loc, b_loc)`` block of each rotation plane
  with ``MinibatchBuilder.extract_plane_blocks``, the 4D step's own
  extraction, with the planner's per-column rescale (the fused CUDA kernel
  with ``extract_impl="cuda"``), and slices its feature rows
  (``local_rows``): the assembly, with no collective at all;
* then ``ForwardEngine(..., backend="dense", train=False)`` runs the 3D-PMM
  GCN forward, one all-reduce per product;
* the ``d`` axis serves ``dp`` independent stacked micro-batches per
  device call.

The one design change. The reference has one controller: ``jax.device_put``
carries the plan to every device and the logits come back as one global
array. The port has one process per rank, so:

* rank 0 is the front. It admits, batches and plans, then sends each
  device call's stacked ``(dp, g, b_loc)`` ids and per-column scales to
  every rank in ONE broadcast over the mesh's world group (recorded in the
  collective ledger as ``"broadcast"`` under the scope ``serve_plan``),
  runs its own share of the step, and gathers every rank's logits block
  (``"gather"``, scope ``serve_gather``) into the reference's flat,
  range-major row order, dropping the padded classes;
* every other rank runs :func:`serve_worker`: it takes each broadcast
  plan, joins the step and sends its logits to rank 0, until rank 0 sends
  a stop (:meth:`DistributedServePlan.stop`, which ``InferenceEngine.close``
  calls). New params go out the same way: a broadcast of the global
  params, which each rank shards for itself.

Only rank 0's engine, driven by one thread at a time (``ServingDriver``
holds one lock around it), issues these collectives, so every rank sees
them in one order. The support pools are pure functions of ``(seed,
range)``, so the plan is the reference's bit for bit. A ``(1, 1, 1)`` mesh
with ``force_distributed=True`` runs this whole path on one rank (with a
process group of one, or none: then no collective is called).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import fourd, pmm3d
from repro_torch.core import sampling as smp
from repro_torch.core.forward import ForwardEngine, TrainOptions
from repro_torch.core.gcn_model import GCNConfig, Params
from repro_torch.core.minibatch import MinibatchBuilder
from repro_torch.graphs.csr import CSRMatrix
from repro_torch.graphs.partition import PartitionedGraph, partition_csr_2d
from repro_torch.obs import comm
from repro_torch.obs.tracer import phase
from repro_torch.serve import assembler as asm
from repro_torch.tree import leaves, unflatten

# the first word of each broadcast: what the worker ranks do next
_STEP, _PARAMS, _STOP = 1, 2, 0


def make_serve_mesh(g: int, dp: int = 1,
                    device: Union[str, torch.device, None] = None
                    ) -> fourd.Mesh:
    """The serving mesh: ``dp`` data-parallel groups x a cube ``g^3`` PMM
    grid, the training step's ``(d, x, y, z)`` axes (``fourd.make_mesh_4d``:
    more than one rank needs ``torch.distributed`` initialised, e.g. under
    ``torchrun``)."""
    return fourd.make_mesh_4d(dp, g, device)


def partition_for_serving(A: CSRMatrix, features: np.ndarray,
                          g: int) -> PartitionedGraph:
    """g x g padded-CSR block partition of the serving graph (no labels:
    inference only; ghosts carry zero features and no edges)."""
    n = A.n_rows
    n_local = -(-n // g)
    n_pad = n_local * g
    block_rp, block_ci, block_val, e_pad, max_row_nnz = partition_csr_2d(
        A, g, n_pad)
    feats = np.zeros((n_pad, features.shape[1]), np.float32)
    feats[:n] = features
    return PartitionedGraph(
        n=n, n_pad=n_pad, g=g, n_local=n_local, e_pad=e_pad,
        block_rp=block_rp, block_ci=block_ci, block_val=block_val,
        max_block_row_nnz=max_row_nnz, features=feats,
        labels=np.full((n_pad,), -1, np.int32),
        train_mask=np.zeros((n_pad,), bool), num_classes=0)


@dataclasses.dataclass
class DistributedServePlan:
    """Everything one rank needs to serve over the mesh: the partitioned
    graph, the per-range support pools, the 4D step's plan (its mesh,
    builder and sharding rules) and the forward engine. :meth:`step` is one
    device call of ``dp`` stacked micro-batches on rank 0;
    :meth:`worker_loop` is every other rank's side of it."""

    fplan: fourd.FourDPlan
    spec: asm.AssemblySpec
    pg: PartitionedGraph
    pools: List[np.ndarray]
    engine: ForwardEngine
    # the global params' shapes, in leaf order: an update's broadcast
    param_shapes: Tuple[Tuple[int, ...], ...]
    stopped: bool = False

    @property
    def mesh(self) -> fourd.Mesh:
        return self.fplan.mesh

    @property
    def cfg(self) -> GCNConfig:
        return self.fplan.cfg

    @property
    def builder(self) -> MinibatchBuilder:
        return self.fplan.builder

    @property
    def g(self) -> int:
        return self.mesh.shape["x"]

    @property
    def dp(self) -> int:
        return self.mesh.shape["d"]

    @property
    def b_local(self) -> int:
        return self.spec.total // self.g

    @property
    def num_classes_padded(self) -> int:
        return self.fplan.num_classes_padded

    @property
    def _grouped(self) -> bool:
        """Whether the mesh has a process group (one rank may have none:
        then no collective is called)."""
        return self.mesh.groups is not None

    def shard_params(self, params: Params) -> Params:
        """This rank's shards of the global params, the output head padded
        to the grid side first (the training plane layout)."""
        return self.fplan.shard_params(params)

    def shard_graph(self) -> Dict[str, Any]:
        """This rank's CSR block of each rotation plane and its feature
        rows (range x, columns of slice z)."""
        return self.fplan.shard_graph(self.pg)

    # -- the per-rank body ---------------------------------------------------

    def assemble(self, graph: Dict[str, Any], ids2d: torch.Tensor,
                 scale2d: torch.Tensor) -> Tuple[Tuple[Any, ...],
                                                 torch.Tensor]:
        """This rank's blocks and feature rows of one micro-batch: the
        (g, b_loc) ids and per-column scales of its DP group, the 4D step's
        rotation-plane extraction with the planner's rescale of column
        range j, and its rows of range x. No collective."""
        coords = self.mesh.coords
        with phase("extract"):
            blocks = self.builder.extract_plane_blocks(
                graph["adj"], ids2d, self.cfg.num_layers, coords,
                col_scale_fn=lambda i, j: scale2d[j])
            x_local = self.builder.local_rows(graph["features"], ids2d,
                                              coords["x"])
        return blocks, x_local

    @torch.inference_mode()
    def local_step(self, params: Params, graph: Dict[str, Any],
                   ids3d: torch.Tensor, scale3d: torch.Tensor
                   ) -> torch.Tensor:
        """This rank's logits block of its DP group's micro-batch:
        (b_loc, padded classes / g), rows on the final state's row axis,
        classes on its replica axis."""
        d = self.mesh.coords["d"]
        blocks, x_local = self.assemble(graph, ids3d[d], scale3d[d])
        logits, _ = self.engine(params, blocks, x_local, step=0,
                                train=False)
        return logits

    # -- rank 0: the front ---------------------------------------------------

    def _broadcast(self, buf: torch.Tensor, scope: str) -> None:
        if not self._grouped:
            return
        with comm.scope(scope):
            comm.record("broadcast", buf)
            dist.broadcast(buf, src=0)

    def _signal(self, op: int) -> None:
        """Rank 0: a plan broadcast that carries only its first word."""
        buf = torch.zeros((1 + self._plan_words(),), dtype=torch.int32,
                          device=self.mesh.device)
        buf[0] = op
        self._broadcast(buf, "serve_plan")

    def step(self, params: Params, graph: Dict[str, Any],
             ids3d: np.ndarray, scale3d: np.ndarray) -> np.ndarray:
        """One device call on rank 0: (dp, g, b_loc) ids and scales ->
        (dp, total, padded classes) logits on the host, rows in flat
        (range-major, globally sorted) batch order."""
        if self.mesh.rank != 0:
            raise RuntimeError("only rank 0 plans; the other ranks run "
                               "serve_worker")
        if self.stopped:
            raise RuntimeError("the serving mesh was stopped")
        shape = (self.dp, self.g, self.b_local)
        if ids3d.shape != shape or scale3d.shape != shape:
            raise ValueError(f"a device call takes {shape} ids and scales, "
                             f"got {ids3d.shape} and {scale3d.shape}")
        plan = np.concatenate([
            np.array([_STEP], np.int32),
            np.ascontiguousarray(ids3d, np.int32).reshape(-1),
            np.ascontiguousarray(scale3d, np.float32).view(np.int32)
            .reshape(-1)])
        buf = torch.from_numpy(plan).to(self.mesh.device)
        self._broadcast(buf, "serve_plan")
        return self._gather(self.local_step(params, graph,
                                            *self._unpack(buf)))

    def send_params(self, params: Params) -> None:
        """Rank 0: hand new global params to every rank (they reshard
        them); the caller reshards its own."""
        if not self._grouped or self.stopped:
            return
        self._signal(_PARAMS)
        flat = torch.cat([t.detach().reshape(-1).float().to(self.mesh.device)
                          for t in leaves(params)])
        self._broadcast(flat, "serve_params")

    def stop(self) -> None:
        """Rank 0: release the worker ranks (:func:`serve_worker`
        returns); idempotent."""
        if self.stopped:
            return
        self.stopped = True
        if self.mesh.rank == 0:
            self._signal(_STOP)

    def _plan_words(self) -> int:
        return 2 * self.dp * self.g * self.b_local

    def _unpack(self, buf: torch.Tensor) -> Tuple[torch.Tensor,
                                                   torch.Tensor]:
        n = self._plan_words() // 2
        shape = (self.dp, self.g, self.b_local)
        return (buf[1:1 + n].reshape(shape),
                buf[1 + n:1 + 2 * n].view(torch.float32).reshape(shape))

    def _gather(self, local: torch.Tensor) -> Optional[np.ndarray]:
        """Every rank's logits block to rank 0, placed at its (d, row
        range, class slice); the replicas along the third axis are the same
        bits, and the last one written stays. None on the other ranks."""
        mesh, local = self.mesh, local.contiguous()
        world = dist.get_world_size() if self._grouped else 1
        parts = [local]
        if self._grouped:
            with comm.scope("serve_gather"):
                comm.record("gather", local,
                            times=world if mesh.rank == 0 else 1)
                parts = ([torch.empty_like(local) for _ in range(world)]
                         if mesh.rank == 0 else None)
                dist.gather(local, parts, dst=0)
        if mesh.rank != 0:
            return None
        st = pmm3d.state_after_layers(self.cfg.num_layers)
        b, ncl = local.shape
        out = np.zeros((self.dp, self.spec.total, ncl * self.g), np.float32)
        dims = [mesh.shape[a] for a in fourd.AXES_4D]
        for r, part in enumerate(parts):
            c = dict(zip(fourd.AXES_4D, np.unravel_index(r, dims)))
            out[c["d"], c[st.row] * b:(c[st.row] + 1) * b,
                c[st.rep] * ncl:(c[st.rep] + 1) * ncl] = part.cpu().numpy()
        return out

    # -- the other ranks -----------------------------------------------------

    def worker_loop(self, params: Params, graph: Dict[str, Any]) -> int:
        """Every rank but 0: take each broadcast plan and join its step,
        take new params and reshard them, until rank 0 stops the mesh.
        Returns the number of steps served."""
        if self.mesh.rank == 0:
            raise RuntimeError("rank 0 is the front: it plans, it does not "
                               "run serve_worker")
        served = 0
        buf = torch.empty((1 + self._plan_words(),), dtype=torch.int32,
                          device=self.mesh.device)
        while True:
            dist.broadcast(buf, src=0)
            op = int(buf[0])
            if op == _STOP:
                self.stopped = True
                return served
            if op == _PARAMS:
                n = sum(int(np.prod(s)) for s in self.param_shapes)
                flat = torch.empty((n,), dtype=torch.float32,
                                   device=self.mesh.device)
                dist.broadcast(flat, src=0)
                parts = flat.split([int(np.prod(s))
                                    for s in self.param_shapes])
                params = self.shard_params(unflatten(
                    params, [p.reshape(s) for p, s in
                             zip(parts, self.param_shapes)]))
                continue
            self._gather(self.local_step(params, graph, *self._unpack(buf)))
            served += 1


def build_serve_plan(A: CSRMatrix, features: np.ndarray, cfg: GCNConfig,
                     mesh: fourd.Mesh, spec: asm.AssemblySpec, *,
                     extract_impl: str = "torch", support_seed: int = 0,
                     opts: Optional[TrainOptions] = None,
                     param_shapes: Tuple[Tuple[int, ...], ...] = ()
                     ) -> DistributedServePlan:
    """The serving plan of this rank of ``mesh``, with the reference's
    checks: a cube grid, ``total % g == 0``, ``slots <= total // g`` and
    widths divisible by g. The forward's tail is the fused kernel iff
    ``cfg.elementwise_impl == "cuda"`` (``opts`` overrides), as on one
    device. ``param_shapes`` (the global params' leaf shapes) lets the
    other ranks take new params from rank 0."""
    g = mesh.shape["x"]
    if mesh.shape["y"] != g or mesh.shape["z"] != g:
        raise ValueError("serving uses the paper's cube 3D grid")
    if spec.total % g:
        raise ValueError(f"total={spec.total} does not divide across g={g} "
                         "vertex ranges")
    if spec.slots > spec.total // g:
        raise ValueError(
            f"slots={spec.slots} can overflow one vertex range (capacity "
            f"{spec.total // g}); raise support so total/g >= slots")
    if cfg.d_in % g or cfg.d_hidden % g:
        raise ValueError("d_in / d_hidden must divide by the grid side")
    opts = opts or TrainOptions(
        fused_elementwise=cfg.elementwise_impl == "cuda",
        extract_impl=extract_impl)
    pg = partition_for_serving(A, np.asarray(features, np.float32), g)
    b_loc = spec.total // g
    max_rn = max(pg.max_block_row_nnz, 1)
    builder = MinibatchBuilder(
        scfg=smp.SampleConfig(n_pad=pg.n_pad, g=g, batch=spec.total,
                              e_cap=b_loc * max_rn),
        mode="exact", impl=extract_impl, max_row_nnz=max_rn)
    pools = asm.make_support_pools(pg.n, pg.n_pad, g, support_seed,
                                   min_size=b_loc)
    fplan = fourd.FourDPlan(
        mesh=mesh, cfg=cfg, scfg=builder.scfg, opts=opts, builder=builder,
        num_classes_padded=fourd.padded_class_count(cfg.num_classes, g))
    # serving blocks are extracted dense, whatever opts.spmm_impl says
    return DistributedServePlan(fplan=fplan, spec=spec, pg=pg, pools=pools,
                                engine=fplan.engine(backend="dense"),
                                param_shapes=param_shapes)


def serve_worker(engine) -> int:
    """The loop every rank but 0 runs instead of serving: it joins each
    device call rank 0's ``engine`` makes, until rank 0 closes its engine.
    Returns the device calls served."""
    return engine.backend.serve_worker()
