"""The training and full-graph eval steps of the paper's GCN (ScaleGNN §IV),
restricted to one device.

Counterpart of ``repro/core/fourd.py`` at g = g_d = 1: ``make_mesh_4d``,
``FourDPlan``, ``build_plan``, ``make_loss_fn``, ``make_train_step`` and
``make_eval_step`` keep the reference's names. A step samples and extracts
its batch (``MinibatchBuilder.build``), runs ``core.gcn_model.forward``
and the masked cross-entropy, and differentiates with ``torch.autograd``
through the kernels' autograd rules. At g = 1 this is exactly what the
reference's ``ForwardEngine`` computes inside its ``shard_map``. Any larger
mesh raises ``NotImplementedError`` (ROADMAP queue 1, item 3).

The reference's training path takes dropout from ``TrainOptions.dropout``
and the fused tail from ``TrainOptions.fused_elementwise``, not from the
``GCNConfig`` fields; :func:`model_config` makes that mapping explicit.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from repro_torch.core import gcn_model as M
from repro_torch.core import sampling as smp
from repro_torch.core.forward import TrainOptions, dropout_masks
from repro_torch.core.minibatch import MinibatchBuilder
from repro_torch.device import resolve_device
from repro_torch.graphs.partition import PartitionedGraph
from repro_torch.tree import leaves, unflatten

AXES_4D = ("d", "x", "y", "z")
_MESH = "ROADMAP queue 1, item 3 (4D distributed step)"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The (d, x, y, z) device grid; one device until the 4D step lands."""

    shape: Dict[str, int]
    device: torch.device


def make_mesh_4d(g_d: int, g: int,
                 device: Union[str, torch.device, None] = None) -> Mesh:
    """The paper's 4D virtual grid G_d x g x g x g — here only 1x1x1x1,
    on ``device`` (the card by default)."""
    if g_d != 1 or g != 1:
        raise NotImplementedError(f"a {g_d}x{g}x{g}x{g} mesh is {_MESH}")
    return Mesh(shape=dict.fromkeys(AXES_4D, 1),
                device=resolve_device(device))


def padded_class_count(num_classes: int, g: int) -> int:
    """Class count ceil-padded to the grid side (the output head's
    padding; a no-op at g = 1)."""
    return -(-num_classes // g) * g


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

    @property
    def grid_side(self) -> int:
        return self.scfg.g

    @property
    def device(self) -> torch.device:
        return self.mesh.device

    def shard_params(self, params):
        """The params on the plan's device (one shard at g = 1)."""
        return M.params_to(params, self.device)

    def shard_graph(self, pg: PartitionedGraph) -> Dict[str, Any]:
        """The partitioned graph's arrays on the plan's device: the one
        (0, 0) CSR block at g = 1, features and labels."""
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(
            self.device)
        return {"rp": t(pg.block_rp[0, 0]), "ci": t(pg.block_ci[0, 0]),
                "val": t(pg.block_val[0, 0]), "features": t(pg.features),
                "labels": t(pg.labels)}


def build_plan(pg: PartitionedGraph, cfg: M.GCNConfig, mesh: Mesh,
               batch: int, opts: TrainOptions = TrainOptions(),
               e_cap: Optional[int] = None) -> FourDPlan:
    g = mesh.shape["x"]
    if any(mesh.shape[a] != 1 for a in AXES_4D):
        raise NotImplementedError(f"mesh {mesh.shape} is {_MESH}")
    if pg.g != g:
        raise ValueError("graph partitioned for a different grid side")
    if batch % g:
        raise ValueError("batch must divide evenly across vertex ranges")
    b = batch // g
    e_cap = e_cap or b * max(pg.max_block_row_nnz, 1)
    scfg = smp.SampleConfig(n_pad=pg.n_pad, g=g, batch=batch,
                            e_cap=e_cap).validate()
    builder = MinibatchBuilder.from_options(
        scfg, opts, max_row_nnz=max(pg.max_block_row_nnz, 1))
    return FourDPlan(mesh=mesh, cfg=cfg, scfg=scfg, opts=opts,
                     builder=builder,
                     num_classes_padded=padded_class_count(cfg.num_classes,
                                                           g))


def make_loss_fn(plan: FourDPlan, *, train: bool = True):
    """Returns ``loss(params, graph, step, epoch=None, *, ids=None)``, the
    (G_d,) = (1,) per-group losses of step ``step``. ``ids`` injects the
    (1, b) sample in place of drawing it from ``(seed, epoch, step)``."""
    cfg = model_config(plan.cfg, plan.opts)
    builder, opts = plan.builder, plan.opts

    def loss_fn(params, graph, step, epoch=None, *, ids=None):
        step = int(step)
        mb = builder.build(graph["rp"], graph["ci"], graph["val"],
                           graph["features"], graph["labels"], step,
                           epoch=None if epoch is None else int(epoch),
                           ids=ids)
        masks = None
        if train and opts.dropout > 0:
            masks = dropout_masks(opts, step, cfg.num_layers,
                                  (mb.feats.shape[0], cfg.d_hidden),
                                  mb.feats.device)
        logits = M.forward(params, mb.adj[0], mb.feats, cfg, train=train,
                           keep_masks=masks)
        return M.cross_entropy_loss(logits, mb.labels)[None]
    return loss_fn


def make_train_step(plan: FourDPlan, optimizer):
    """``(params, opt_state, graph, step, *, ids=None) -> (params,
    opt_state, loss)``. The optimizer updates ``params`` in place and
    returns the same tensors."""
    loss_fn = make_loss_fn(plan, train=True)

    def train_step(params, opt_state, graph, step, *, ids=None):
        loss, grads = value_and_grad(loss_fn, params, graph, step, ids=ids)
        params, opt_state = optimizer.update(params, grads, opt_state)
        return params, opt_state, loss
    return train_step


def make_eval_step(plan: FourDPlan):
    """Full-graph evaluation (paper Table II): one forward over the whole
    graph — no sampling — with the CSR aggregation, returning the accuracy
    over every vertex with a label (ghosts excluded)."""
    cfg = dataclasses.replace(model_config(plan.cfg, plan.opts),
                              spmm_impl="csr")

    @torch.no_grad()
    def eval_step(params, graph):
        logits = M.forward(params, (graph["rp"], graph["ci"], graph["val"]),
                           graph["features"], cfg, train=False)
        return M.accuracy(logits, graph["labels"])
    return eval_step


def value_and_grad(loss_fn, params, graph, step, epoch=None, *, ids=None):
    """The mean loss of ``loss_fn`` and its gradient, in the structure of
    ``params`` (whose leaves are set to require grad)."""
    flat = leaves(params)
    for p in flat:
        p.requires_grad_(True)
    with torch.enable_grad():
        loss = loss_fn(params, graph, step, epoch, ids=ids).mean()
        grads = torch.autograd.grad(loss, flat)
    return loss.detach(), unflatten(params, list(grads))
