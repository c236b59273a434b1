"""Device selection for the port's entry points.

The port is written for an NVIDIA GPU: an entry point runs on the card
unless its caller asks for the CPU. There is no fallback — with no card,
``resolve_device(None)`` raises instead of quietly running on the CPU.
"""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` means ``"cuda"``; a CUDA device needs a card, and
    ``"cpu"`` is used only when asked for by name."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on an NVIDIA GPU and torch.cuda.is_available() "
            "is false; pass device='cpu' to run the plain versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def use_full_f32_matmul() -> None:
    """Keep float32 GEMMs and convolutions in full float32, as the JAX
    reference computes them: TF32 keeps about three decimal digits. A bf16
    GEMM sums in float32 too (PyTorch's default lets it reduce in bf16;
    XLA accumulates in float32). Called by every entry point of the
    port."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
