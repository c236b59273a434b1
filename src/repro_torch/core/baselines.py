"""Baseline samplers the paper compares against (Table I, Fig. 6).

Counterpart of ``repro/core/baselines.py``:

* GraphSAINT's node sampler (Zeng et al. 2019): degree-proportional
  vertex sampling with the independent-inclusion normalization of the
  aggregator and of the loss (:func:`saint_node_sample`);
* GraphSAGE's neighbor sampler (Hamilton et al. 2017): node-wise fan-out
  sampling with mean aggregation, the sampler of DistDGL, MassiveGNN and
  SALIENT++ (:func:`sage_sample`, :func:`sage_aggregate`; the model is
  ``gcn_model.sage_forward``);
* the full-batch GCN: one forward and backward over every vertex per
  optimizer step (:func:`make_fullbatch_gcn_loss`,
  :func:`make_fullbatch_gcn_step`).

Each runs over the same padded-CSR graph, model, optimizer and kernels as
the paper's sampler, so a comparison isolates the sampling algorithm. The
draws are the port's counter draws from a 64-bit key (``core/sampling.py``),
on the key's device, and cannot reproduce ``jax.random``'s bits. So each
sampler is split at its draw: what follows the draw is a function of the
sampled ids (:func:`saint_batch`, :func:`sage_batch`), which the tests hold
to the reference with the reference's ids injected. SAINT's induced
subgraph goes through ``MinibatchBuilder.extract_block``, so a builder with
``impl="cuda"`` launches the extraction kernel; the full-batch step's CSR
product is ``pmm3d.csr_spmm_local`` (a library sparse product, as the
reference's is plain jnp outside any kernel).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.core import fourd, pmm3d
from repro_torch.core import sampling as smp
from repro_torch.core.minibatch import BlockFormat, MinibatchBuilder
from repro_torch.kernels import counter_rng as crng


# ---------------------------------------------------------------------------
# GraphSAINT node sampler
# ---------------------------------------------------------------------------

class SaintBatch(NamedTuple):
    adj: torch.Tensor           # (B, B) dense normalized induced adjacency
    feats: torch.Tensor         # (B, d_in)
    labels: torch.Tensor        # (B,)
    loss_weights: torch.Tensor  # (B,) 1/(B p_v) loss normalization
    vertex_ids: torch.Tensor    # (B,) sorted int32


def _uniform(key: torch.Tensor, n: int) -> torch.Tensor:
    """(n,) float64 uniforms in (0, 1) from the top 53 bits of the counter
    hashes ``fold_in(key, i)``."""
    bits = crng._shr(crng.hash_keys(key, n), 11)
    return (bits.double() + 0.5) * 2.0 ** -53


def saint_draw(key: smp.Key, degrees: torch.Tensor, batch: int
               ) -> torch.Tensor:
    """GraphSAINT-node's draw: ``batch`` distinct vertices with p_v ∝
    deg(v), without replacement by Gumbel top-k (in float64, so that the
    keys do not tie), sorted int32 ids on ``degrees``' device."""
    key = smp.key_tensor(key, degrees.device)
    n = degrees.shape[0]
    u = torch.clamp(_uniform(key, n), min=1e-9)
    score = torch.log(torch.clamp(degrees.double(), min=1e-9)) \
        - torch.log(-torch.log(u))
    top = torch.topk(score, batch).indices
    return torch.sort(top).values.to(torch.int32)


def saint_batch(s: torch.Tensor, rp: torch.Tensor, ci: torch.Tensor,
                val: torch.Tensor, features: torch.Tensor,
                labels: torch.Tensor, degrees: torch.Tensor, e_cap: int,
                builder: MinibatchBuilder) -> SaintBatch:
    """The SAINT batch of the sorted sample ``s``: the induced subgraph,
    unrescaled, through ``builder.extract_block`` (``col_scale`` 1,
    diagonal), then SAINT's normalization:

      aggregator: a_uv / q_uv, q_uv = 1 - (1 - p̃_u)(1 - p̃_v), p̃_v =
                  min(1, B p_v) (the independent-inclusion estimate),
                  self-loops kept;
      loss:       weight 1/(B p_v) per sampled vertex, scaled to mean 1.
    """
    batch = s.shape[0]
    p_v = degrees / torch.clamp(degrees.sum(), min=1e-9)
    p_incl = torch.clamp(batch * p_v, max=1.0)
    adj = builder.extract_block(rp, ci, val, s, s, col_scale=1.0,
                                diag=True, e_cap=e_cap,
                                fmt=BlockFormat.DENSE)
    sl = s.long()
    pu = p_incl[sl]
    q = torch.clamp(pu[:, None] + pu[None, :] - pu[:, None] * pu[None, :],
                    1e-9, 1.0)
    eye = torch.eye(batch, dtype=adj.dtype, device=adj.device)
    adj = adj * ((1.0 - eye) / q + eye)
    w = 1.0 / torch.clamp(batch * p_v[sl], min=1e-9)
    w = w / torch.clamp(w.sum(), min=1e-9) * batch
    return SaintBatch(adj=adj, feats=features[sl], labels=labels[sl],
                      loss_weights=w, vertex_ids=s)


def saint_node_sample(key: smp.Key, rp: torch.Tensor, ci: torch.Tensor,
                      val: torch.Tensor, features: torch.Tensor,
                      labels: torch.Tensor, degrees: torch.Tensor, n: int,
                      batch: int, e_cap: int,
                      builder: Optional[MinibatchBuilder] = None
                      ) -> SaintBatch:
    """GraphSAINT-node: :func:`saint_draw` from ``key``, then
    :func:`saint_batch`. ``degrees`` is the (n,) float32 sampling weight;
    ``builder`` picks the extraction backend (the exact-mode plain one by
    default; ``impl="cuda"`` for the kernel)."""
    if builder is None:
        builder = MinibatchBuilder(
            scfg=smp.SampleConfig(n_pad=n, g=1, batch=batch, e_cap=e_cap),
            mode="exact")
    s = saint_draw(key, degrees, batch)
    return saint_batch(s, rp, ci, val, features, labels, degrees, e_cap,
                       builder)


# ---------------------------------------------------------------------------
# GraphSAGE neighbor sampler
# ---------------------------------------------------------------------------

class SageBatch(NamedTuple):
    """Layered neighbor-sampled batch of an L-layer SAGE network.

    ``frontiers[l]`` are the global ids needed at layer input l
    (``frontiers[0]`` is the target batch). Each frontier holds its inner
    frontier as a prefix (the self vertices): ``frontiers[l+1] =
    concat(frontiers[l], sampled_neighbors_of(frontiers[l]))``.
    ``neighbors[l]`` maps each frontier-l vertex to its ``fanout_l``
    sampled neighbors' positions within frontier l+1 (past the prefix).
    """

    frontiers: Tuple[torch.Tensor, ...]   # sizes B, B (1 + k1), ...
    neighbors: Tuple[torch.Tensor, ...]   # (B, k1), (B (1 + k1), k2), ...
    feats: torch.Tensor                   # features of the outermost one
    labels: torch.Tensor                  # labels of the target batch


def sage_batch(targets: torch.Tensor, sampled: Sequence[torch.Tensor],
               features: torch.Tensor, labels: torch.Tensor) -> SageBatch:
    """The SAGE batch of ``targets`` and ``sampled[l]``, the (|F_l|, k_l)
    global ids of the neighbors drawn for frontier l (duplicates are fine
    for the mean)."""
    frontiers, maps, cur = [targets.long()], [], targets.long()
    for nbrs in sampled:
        offset = cur.shape[0]
        maps.append(offset + torch.arange(nbrs.numel(), device=cur.device)
                    .reshape(nbrs.shape))
        cur = torch.cat([cur, nbrs.reshape(-1).long()])
        frontiers.append(cur)
    return SageBatch(frontiers=tuple(frontiers), neighbors=tuple(maps),
                     feats=features[frontiers[-1]],
                     labels=labels[frontiers[0]])


def sage_sample(key: smp.Key, rp: torch.Tensor, ci: torch.Tensor,
                features: torch.Tensor, labels: torch.Tensor, n: int,
                batch: int, fanouts: Sequence[int]) -> SageBatch:
    """Node-wise neighbor sampling with fan-outs ``fanouts`` (innermost
    first), the paper's 'neighborhood explosion': the outermost frontier
    has B prod(1 + k_l) vertices. The targets are the head of the counter
    permutation of ``fold_in(key, 0)``, sorted; layer l draws each row's
    neighbors with replacement from ``fold_in(key, 1 + l)`` (a hash mod the
    row's degree; an isolated row samples itself). Then
    :func:`sage_batch`."""
    key = smp.key_tensor(key, rp.device)
    targets = smp.sample_uniform_exact(smp.fold_in(key, 0), n, batch).long()
    rp = rp.long()
    cur, sampled = targets, []
    for li, k in enumerate(fanouts):
        h = crng.hash_keys(smp.fold_in(key, 1 + li), cur.shape[0] * k)
        deg = rp[cur + 1] - rp[cur]
        pick = torch.remainder(h.view(-1, k), torch.clamp(deg, min=1)[:, None])
        has = (deg > 0)[:, None]
        nbrs = ci[rp[cur][:, None] + torch.where(has, pick,
                                                 torch.zeros_like(pick))]
        nbrs = torch.where(has, nbrs.long(), cur[:, None])
        sampled.append(nbrs)
        cur = torch.cat([cur, nbrs.reshape(-1)])
    return sage_batch(targets, sampled, features, labels)


def sage_aggregate(h_next: torch.Tensor,
                   neighbor_map: torch.Tensor) -> torch.Tensor:
    """GCN-style mean over {self} ∪ sampled neighbors, (|F_{l+1}|, d) ->
    (|F_l|, d); the self embeddings are the prefix of ``h_next``."""
    n_inner, k = neighbor_map.shape
    nbr_mean = h_next[neighbor_map].mean(dim=1)
    return (h_next[:n_inner] + k * nbr_mean) / (k + 1.0)


# ---------------------------------------------------------------------------
# Full-batch GCN (the no-sampling baseline)
# ---------------------------------------------------------------------------
#
# One forward and backward over ALL vertices per optimizer step, through
# the same ForwardEngine as the paper's path: the "csr" backend over the
# rank's resident adjacency blocks, the program of full-graph evaluation,
# so a comparison isolates mini-batching itself.

class FullBatchLoss(fourd.LossFn):
    """The plan's full-graph loss: ``local(params, graph, step)`` is this
    rank's group loss, differentiable (``fourd.value_and_grad`` takes it);
    calling the object gives the (G_d,) per-group losses. No sampling, no
    extraction."""

    def __init__(self, plan: fourd.FourDPlan, train: bool):
        self.plan, self.train = plan, train
        self.engine = plan.engine(backend="csr", csr_rows=plan.scfg.n_local)

    def sample(self, graph, step, epoch=None, *, ids=None):
        raise ValueError("the full-batch GCN samples no batch")

    def local(self, params, graph, step, epoch=None, *, ids=None, mb=None,
              ef=None):
        if ids is not None or mb is not None or ef is not None:
            raise ValueError("the full-batch GCN takes no ids, batch or "
                             "error feedback")
        plan, mesh = self.plan, self.plan.mesh
        planes = graph["adj"][:min(3, plan.cfg.num_layers)]
        logits, st = self.engine(params, planes, graph["features"],
                                 step=step, train=self.train)
        nll_sum, cnt = pmm3d.parallel_cross_entropy(
            logits, graph["labels"], class_axis=mesh.axis(st.rep),
            row_axis=mesh.axis(st.row), n_classes=plan.cfg.num_classes)
        return nll_sum / torch.clamp(cnt, min=1.0)


def make_fullbatch_gcn_loss(plan: fourd.FourDPlan, *,
                            train: bool = True) -> FullBatchLoss:
    """``loss(params, graph, step) -> (G_d,)`` per-group losses of one
    full-graph GCN step on the plan's mesh; ``fourd.value_and_grad(loss,
    params, graph, step)`` gives its gradient."""
    return FullBatchLoss(plan, train)


def make_fullbatch_gcn_step(plan: fourd.FourDPlan, optimizer):
    """``(params, opt_state, graph, step) -> (params, opt_state, loss)``:
    the full-batch training step (``fourd.make_train_step`` with the
    full-graph loss); the optimizer updates ``params`` in place."""
    loss_fn = make_fullbatch_gcn_loss(plan, train=True)

    def train_step(params, opt_state, graph, step):
        loss, grads = fourd.value_and_grad(loss_fn, params, graph, step)
        params, opt_state = optimizer.update(params, grads, opt_state,
                                             sumsq=plan.global_sumsq)
        return params, opt_state, loss
    return train_step
