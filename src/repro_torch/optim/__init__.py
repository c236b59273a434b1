"""Optimizers and learning-rate schedules (counterpart of ``repro/optim``)."""
from repro_torch.optim.adamw import AdamW, Sgd, clip_by_global_norm
from repro_torch.optim.schedules import (constant_schedule, cosine_schedule,
                                         cosine_schedule_epochs,
                                         epochs_to_steps,
                                         linear_warmup_cosine,
                                         linear_warmup_cosine_epochs)

__all__ = ["AdamW", "Sgd", "clip_by_global_norm", "constant_schedule",
           "cosine_schedule", "cosine_schedule_epochs", "epochs_to_steps",
           "linear_warmup_cosine", "linear_warmup_cosine_epochs"]
