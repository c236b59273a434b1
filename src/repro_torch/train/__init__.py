"""repro_torch.train — the training runtime (counterpart of
``repro/train``): ``TrainState`` (params, optimizer state, step and epoch
counters) and ``Trainer`` (chunked steps, eval and checkpoint cadence,
full-state checkpoint/resume with async saves)."""
from repro_torch.train.runner import (
    CKPT_NAME, RunLog, Trainer, TrainLoopConfig,
)
from repro_torch.train.state import TrainState, init_train_state

__all__ = [
    "CKPT_NAME", "RunLog", "Trainer", "TrainLoopConfig",
    "TrainState", "init_train_state",
]
