"""The training-loop state.

Counterpart of ``repro/train/state.py``. ``TrainState`` holds the params,
the optimizer state, the ``step`` and ``epoch`` counters that seed the
communication-free sampling and dropout (int32 scalars on the plan's
device: the step derives its draws from them there and advances them in
place, so a captured step replays with no read on the host; the runner
keeps a Python mirror of the step for its boundaries), and two carries
that are ``None`` when their feature is off: ``minibatch``, the §V-A
prefetch carry (batch ``step``, already built), and ``comm_ef``, the
error-feedback accumulators of the compressed collectives
(``fourd.make_ef``). The fields are in the reference's order, so its
leaves' paths are the reference's checkpoint keys (``.params::w_in``,
``.opt_state::mu::...``, ``.step``, ``.minibatch::.adj::0``, ``.epoch``,
``.comm_ef::l0_spmm``) and a state checkpoint loads in either package. On a mesh the state holds this
rank's shards; a checkpoint holds the global leaves (``Trainer.save``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from repro_torch.core.minibatch import Minibatch
from repro_torch.tree import leaves


@dataclasses.dataclass
class TrainState:
    """Everything one training step consumes and produces. ``step`` is the
    index of the NEXT step to run, ``epoch`` the epoch it falls in."""

    params: Any
    opt_state: Any
    step: torch.Tensor
    minibatch: Optional[Minibatch] = None
    epoch: Optional[torch.Tensor] = None
    comm_ef: Optional[Dict[str, torch.Tensor]] = None


def init_train_state(params, opt_state,
                     minibatch: Optional[Minibatch] = None,
                     comm_ef: Optional[Dict[str, torch.Tensor]] = None
                     ) -> TrainState:
    """A fresh state at step 0, epoch 0 (EF accumulators start at zero),
    the counters on the params' device."""
    device = leaves(params)[0].device
    zero = lambda: torch.zeros((), dtype=torch.int32, device=device)
    return TrainState(params=params, opt_state=opt_state, step=zero(),
                      minibatch=minibatch, epoch=zero(), comm_ef=comm_ef)
