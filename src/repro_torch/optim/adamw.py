"""AdamW and SGD written out in the reference's order of operations.

Counterpart of ``repro/optim/adamw.py`` (not ``torch.optim``, so the port
rounds where the reference rounds). The same API: ``opt.init(params) ->
state``; ``opt.update(params, grads, state) -> (params, state)``. The port
updates in place, under ``torch.no_grad()``: ``update`` writes the new
values into the param tensors and the moment tensors of ``state`` and
returns those same objects, ``state["step"]`` included. That step is an
int32 scalar on the params' device, and the learning rate and the bias
corrections are computed from it there, so the update reads nothing on
the host and a CUDA graph of the training step sees each replay's own
step; the state checkpoints in the reference's format.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Tuple

import torch

from repro_torch.tree import leaves, tree_map

Schedule = Callable[[torch.Tensor], torch.Tensor]

# AdamW updates a leaf of more elements than this a slice at a time: the
# same elementwise arithmetic, so the same bits, with the update's
# temporaries bounded by the slice (a leaf of 1.75 GiB held five of its
# own size at once)
UPDATE_SLICE = 1 << 26


def _to_schedule(lr) -> Schedule:
    if callable(lr):
        return lr
    return lambda step: torch.full((), lr, dtype=torch.float32,
                                   device=step.device)


def _step_counter(params) -> torch.Tensor:
    """A zero int32 step on the params' device."""
    flat = leaves(params)
    return torch.zeros((), dtype=torch.int32,
                       device=flat[0].device if flat else None)


def _slices(*ts: torch.Tensor):
    """``ts`` (tensors of one shape) whole, or, above UPDATE_SLICE
    elements and contiguous, as matching slices of their flat views."""
    n = ts[0].numel()
    if n <= UPDATE_SLICE or not all(t.is_contiguous() for t in ts):
        yield ts
        return
    flat = [t.view(-1) for t in ts]
    for s in range(0, n, UPDATE_SLICE):
        yield tuple(f[s:s + UPDATE_SLICE] for f in flat)


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float, sumsq=None):
    """``(grads * min(1, max_norm / (|grads| + 1e-9)), |grads|)``; the
    scaled grads are new tensors. ``sumsq(grads)`` gives the squared global
    norm of a tree of shards (``FourDPlan.global_sumsq``: each distinct
    shard counted once, as the reference takes the norm of its global
    arrays); by default the leaves are whole."""
    if sumsq is None:
        sumsq = lambda t: sum(torch.sum(torch.square(g)) for g in leaves(t))
    gnorm = torch.sqrt(sumsq(grads))
    scale = torch.clamp(max_norm / (gnorm + 1e-9), max=1.0)
    return tree_map(lambda g: g * scale, grads), gnorm


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: Any = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip: float = 0.0

    def init(self, params):
        return {"step": _step_counter(params),
                "mu": tree_map(torch.zeros_like, params),
                "nu": tree_map(torch.zeros_like, params)}

    @torch.no_grad()
    def update(self, params, grads, state, *, sumsq=None) -> Tuple[Any, Any]:
        """One step in place; ``sumsq`` as in :func:`clip_by_global_norm`
        (for the shards of a mesh)."""
        sched = _to_schedule(self.lr)
        step = state["step"].add_(1)
        if self.grad_clip > 0:
            grads, _ = clip_by_global_norm(grads, self.grad_clip, sumsq)
        lr = sched(step)
        b1, b2 = self.b1, self.b2
        bc1 = 1 - b1 ** step.to(torch.float32)
        bc2 = 1 - b2 ** step.to(torch.float32)
        for leaf in zip(leaves(params), leaves(grads), leaves(state["mu"]),
                        leaves(state["nu"])):
            for p, g, m, v in _slices(*leaf):
                m.copy_(b1 * m + (1 - b1) * g)
                v.copy_(b2 * v + (1 - b2) * torch.square(g))
                mhat = m / bc1
                vhat = v / bc2
                p.copy_(p - lr * (mhat / (torch.sqrt(vhat) + self.eps)
                                  + self.weight_decay * p))
        return params, state


@dataclasses.dataclass(frozen=True)
class Sgd:
    lr: Any = 1e-2
    momentum: float = 0.0

    def init(self, params):
        if self.momentum == 0.0:
            return {"step": _step_counter(params)}
        return {"step": _step_counter(params),
                "vel": tree_map(torch.zeros_like, params)}

    @torch.no_grad()
    def update(self, params, grads, state, *, sumsq=None):
        """One step in place (no clipping, so ``sumsq`` is not read)."""
        del sumsq
        sched = _to_schedule(self.lr)
        lr = sched(state["step"].add_(1))
        if self.momentum == 0.0:
            for p, g in zip(leaves(params), leaves(grads)):
                p.copy_(p - lr * g)
            return params, state
        for p, g, v in zip(leaves(params), leaves(grads),
                           leaves(state["vel"])):
            v.copy_(self.momentum * v + g)
            p.copy_(p - lr * v)
        return params, state
