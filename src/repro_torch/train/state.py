"""The training-loop state.

Counterpart of ``repro/train/state.py``. ``TrainState`` holds the params,
the optimizer state, and the ``step`` and ``epoch`` counters that seed the
communication-free sampling and dropout (int32 scalars on the CPU, so the
runner reads them without waiting on the card). Its leaves' paths are the
reference's checkpoint keys (``.params::w_in``, ``.opt_state::mu::...``,
``.step``, ``.epoch``), so a state checkpoint loads in either package.
The §V-A prefetch carry and the compressed-collective error feedback of
the reference's state come with their features (ROADMAP queue 1, items 5
and 6).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch


@dataclasses.dataclass
class TrainState:
    """Everything one training step consumes and produces. ``step`` is the
    index of the NEXT step to run, ``epoch`` the epoch it falls in."""

    params: Any
    opt_state: Any
    step: torch.Tensor
    epoch: torch.Tensor


def init_train_state(params, opt_state) -> TrainState:
    """A fresh state at step 0, epoch 0."""
    return TrainState(params=params, opt_state=opt_state,
                      step=torch.zeros((), dtype=torch.int32),
                      epoch=torch.zeros((), dtype=torch.int32))
