"""Tree checkpoints in the reference's ``.npz`` + JSON format."""
from repro_torch.checkpoint.ckpt import (checkpoint_keys, checkpoint_path,
                                         latest_step, load_checkpoint,
                                         save_checkpoint)

__all__ = ["checkpoint_keys", "checkpoint_path", "latest_step",
           "load_checkpoint", "save_checkpoint"]
