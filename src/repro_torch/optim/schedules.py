"""Learning-rate schedules (counterpart of ``repro/optim/schedules.py``):
pure functions of the step (an int32 scalar tensor) returning a float32
scalar tensor on the step's device, computed with the reference's
operations in float32.

Step-based forms and epoch-based forms of the same shapes; the epoch forms
delegate, so both give the same values when ``total_steps == epochs *
steps_per_epoch``."""
from __future__ import annotations

import math

import torch

_F32 = torch.float32


def epochs_to_steps(epochs: int, steps_per_epoch: int) -> int:
    """Total optimizer steps of an epoch-parameterized schedule."""
    if epochs < 1 or steps_per_epoch < 1:
        raise ValueError(f"epochs={epochs}, steps_per_epoch="
                         f"{steps_per_epoch}")
    return epochs * steps_per_epoch


def constant_schedule(lr: float):
    return lambda step: torch.full((), lr, dtype=_F32, device=step.device)


def cosine_schedule(peak_lr: float, total_steps: int, final_frac: float = 0.0):
    def sched(step):
        t = torch.clamp(step.to(_F32) / total_steps, 0.0, 1.0)
        cos = 0.5 * (1.0 + torch.cos(math.pi * t))
        return peak_lr * (final_frac + (1 - final_frac) * cos)
    return sched


def linear_warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int,
                         final_frac: float = 0.1):
    def sched(step):
        s = step.to(_F32)
        warm = peak_lr * s / max(warmup_steps, 1)
        t = torch.clamp((s - warmup_steps) / max(total_steps - warmup_steps,
                                                 1), 0.0, 1.0)
        cos = peak_lr * (final_frac + (1 - final_frac)
                         * 0.5 * (1.0 + torch.cos(math.pi * t)))
        return torch.where(s < warmup_steps, warm, cos)
    return sched


def cosine_schedule_epochs(peak_lr: float, epochs: int, steps_per_epoch: int,
                           final_frac: float = 0.0):
    """``cosine_schedule`` spanning exactly ``epochs`` whole epochs."""
    return cosine_schedule(peak_lr, epochs_to_steps(epochs, steps_per_epoch),
                           final_frac)


def linear_warmup_cosine_epochs(peak_lr: float, warmup_epochs: float,
                                epochs: int, steps_per_epoch: int,
                                final_frac: float = 0.1):
    """``linear_warmup_cosine`` with the warmup given in (fractional)
    epochs and the decay horizon in whole epochs."""
    warmup_steps = int(round(warmup_epochs * steps_per_epoch))
    return linear_warmup_cosine(
        peak_lr, warmup_steps, epochs_to_steps(epochs, steps_per_epoch),
        final_frac)
