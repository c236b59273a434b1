"""Public wrappers of the port's kernels (counterpart of
``repro/kernels/ops.py``).

Forward only in this slice: the autograd rules of the JAX module
(``_fused_bwd``, ``_spmm_bwd``) come with the training slice.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import fused_layer as _fused


def fused_layer_tail(
    x: torch.Tensor,
    residual: Optional[torch.Tensor],
    scale: torch.Tensor,
    *,
    dropout_mask: Optional[torch.Tensor] = None,
    dropout_rate: float = 0.0,
    eps: float = 1e-6,
    use_rmsnorm: bool = True,
    use_relu: bool = True,
) -> torch.Tensor:
    """Fused RMSNorm+ReLU+dropout+residual (paper §V-C): the CUDA kernel
    for CUDA tensors, its plain version for CPU tensors."""
    return _fused.fused_layer(
        x, scale, dropout_mask, residual,
        dropout_rate=dropout_rate if dropout_mask is not None else 0.0,
        eps=eps, use_rmsnorm=use_rmsnorm, use_relu=use_relu)
