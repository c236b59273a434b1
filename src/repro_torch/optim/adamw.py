"""AdamW and SGD written out in the reference's order of operations.

Counterpart of ``repro/optim/adamw.py`` (not ``torch.optim``, so the port
rounds where the reference rounds). The same API: ``opt.init(params) ->
state``; ``opt.update(params, grads, state) -> (params, state)``. The port
updates in place, under ``torch.no_grad()``: ``update`` writes the new
values into the param tensors and the moment tensors of ``state`` and
returns those same objects. ``state["step"]`` is an int32 scalar on the
CPU, so the schedule costs the card nothing and the state checkpoints in
the reference's format.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Tuple

import torch

from repro_torch.tree import leaves, tree_map

Schedule = Callable[[torch.Tensor], torch.Tensor]


def _to_schedule(lr) -> Schedule:
    if callable(lr):
        return lr
    return lambda step: torch.tensor(lr, dtype=torch.float32)


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
        return {"step": torch.zeros((), dtype=torch.int32),
                "mu": tree_map(torch.zeros_like, params),
                "nu": tree_map(torch.zeros_like, params)}

    @torch.no_grad()
    def update(self, params, grads, state, *, sumsq=None) -> Tuple[Any, Any]:
        """One step in place; ``sumsq`` as in :func:`clip_by_global_norm`
        (for the shards of a mesh)."""
        sched = _to_schedule(self.lr)
        state["step"] = state["step"] + 1
        step = state["step"]
        if self.grad_clip > 0:
            grads, _ = clip_by_global_norm(grads, self.grad_clip, sumsq)
        lr = sched(step)
        b1, b2 = self.b1, self.b2
        bc1 = 1 - b1 ** step.to(torch.float32)
        bc2 = 1 - b2 ** step.to(torch.float32)
        for p, g, m, v in zip(leaves(params), leaves(grads),
                              leaves(state["mu"]), leaves(state["nu"])):
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
            return {"step": torch.zeros((), dtype=torch.int32)}
        return {"step": torch.zeros((), dtype=torch.int32),
                "vel": tree_map(torch.zeros_like, params)}

    @torch.no_grad()
    def update(self, params, grads, state, *, sumsq=None):
        """One step in place (no clipping, so ``sumsq`` is not read)."""
        del sumsq
        sched = _to_schedule(self.lr)
        state["step"] = state["step"] + 1
        lr = sched(state["step"])
        if self.momentum == 0.0:
            for p, g in zip(leaves(params), leaves(grads)):
                p.copy_(p - lr * g)
            return params, state
        for p, g, v in zip(leaves(params), leaves(grads),
                           leaves(state["vel"])):
            v.copy_(self.momentum * v + g)
            p.copy_(p - lr * v)
        return params, state
