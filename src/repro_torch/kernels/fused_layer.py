"""Fused element-wise layer tail — the paper's §V-C kernel fusion in CUDA.

Counterpart of ``repro/kernels/fused_layer.py``. One pass over each row
applies

    RMSNorm (Eq. 7) -> ReLU (Eq. 8) -> dropout via a keep-mask (Eq. 9)
    -> residual add (Eq. 10)

in float32 and writes the row once (``csrc/fused_layer.cu``).
:func:`fused_layer` launches the kernel for CUDA tensors and runs
:func:`fused_layer_plain`, the same function in plain PyTorch, for CPU
tensors. Forward only: the backward comes with the training slice.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build

# kernel launches so far (a run zeroes it to show that a path used the kernel)
LAUNCHES = 0


def fused_layer_plain(x: torch.Tensor, scale: torch.Tensor,
                      dropout_mask: Optional[torch.Tensor],
                      residual: Optional[torch.Tensor], *,
                      dropout_rate: float = 0.0, eps: float = 1e-6,
                      use_rmsnorm: bool = True,
                      use_relu: bool = True) -> torch.Tensor:
    """The kernel's function in plain PyTorch, in the Pallas kernel's
    order of operations."""
    h = x.float()
    if use_rmsnorm:
        ms = torch.mean(torch.square(h), dim=-1, keepdim=True)
        h = h * torch.rsqrt(ms + eps) * scale.float()
    if use_relu:
        h = torch.relu(h)
    if dropout_mask is not None:
        h = torch.where(dropout_mask, h / (1.0 - dropout_rate),
                        torch.zeros_like(h))
    if residual is not None:
        h = h + residual.float()
    return h.to(x.dtype)


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple,
           device: torch.device) -> None:
    if t.device != device or t.dtype != dtype or tuple(t.shape) != shape \
            or not t.is_contiguous():
        raise ValueError(
            f"fused_layer: {name} must be a contiguous {dtype} tensor of "
            f"shape {shape} on {device}, got {tuple(t.shape)} {t.dtype} on "
            f"{t.device}")


def fused_layer(x: torch.Tensor, scale: torch.Tensor,
                dropout_mask: Optional[torch.Tensor],
                residual: Optional[torch.Tensor], *,
                dropout_rate: float = 0.0, eps: float = 1e-6,
                use_rmsnorm: bool = True,
                use_relu: bool = True) -> torch.Tensor:
    """RMSNorm+ReLU+dropout+residual of ``x`` (B, d) float32 with the
    ``(d,)`` RMSNorm scale; ``dropout_mask`` is a (B, d) bool keep-mask
    and ``residual`` a (B, d) float32 tensor, each optional."""
    if x.device.type == "cpu":
        return fused_layer_plain(x, scale, dropout_mask, residual,
                                 dropout_rate=dropout_rate, eps=eps,
                                 use_rmsnorm=use_rmsnorm, use_relu=use_relu)
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"fused_layer: unsupported device {dev}")
    if x.dim() != 2:
        raise ValueError(f"fused_layer: x must be 2-D, got {tuple(x.shape)}")
    b, d = x.shape
    _check(x, "x", torch.float32, (b, d), dev)
    _check(scale, "scale", torch.float32, (d,), dev)
    if dropout_mask is not None:
        _check(dropout_mask, "dropout_mask", torch.bool, (b, d), dev)
        if not 0.0 <= dropout_rate < 1.0:
            raise ValueError(f"fused_layer: dropout_rate={dropout_rate}")
    if residual is not None:
        _check(residual, "residual", torch.float32, (b, d), dev)
    out = torch.empty_like(x)
    if b == 0 or d == 0:
        return out
    lib = _build.load()
    rc = lib.repro_fused_layer(
        x.data_ptr(), scale.data_ptr(),
        None if dropout_mask is None else dropout_mask.data_ptr(),
        None if residual is None else residual.data_ptr(),
        out.data_ptr(), b, d, float(eps), float(1.0 - dropout_rate),
        int(use_rmsnorm), int(use_relu),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "fused_layer")
    global LAUNCHES
    LAUNCHES += 1
    return out
