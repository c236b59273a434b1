"""Fused element-wise layer tail — the paper's §V-C kernel fusion in CUDA.

Counterpart of ``repro/kernels/fused_layer.py``. One pass over each row
applies

    RMSNorm (Eq. 7) -> ReLU (Eq. 8) -> dropout via a keep-mask (Eq. 9)
    -> residual add (Eq. 10)

in float32 and writes the row once (``csrc/fused_layer.cu``): on the vector
route (:func:`vector_chunks`) each input is read once with 16-byte loads and
the row stays in registers; the scalar route takes any width and
alignment. Both divide a kept element by ``keep_prob`` correctly rounded,
as the reference does.
:func:`fused_layer` launches the kernel for CUDA tensors and runs
:func:`fused_layer_plain`, the same function in plain PyTorch, for CPU
tensors. Its autograd rule is ``kernels.ops.fused_layer_tail``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build

# kernel launches so far (a run zeroes it to show that a path used the
# kernel), in total and by route
LAUNCHES = 0
ROUTE_LAUNCHES = {"vector": 0, "scalar": 0}

ROWS_PER_CTA = 8             # one warp a row
MAX_CHUNKS = 8               # float4 a lane holds on the vector route


def vector_chunks(d: int, float_ptrs, mask_ptr: Optional[int]) -> int:
    """The float4 a lane holds on the vector route, ``ceil(d / 128)``, or 0
    for the scalar route. The vector route needs ``d % 4 == 0``, ``d <=
    1024``, every float tensor 16-byte aligned (x, scale, residual, out)
    and the mask 4-byte aligned; then every row is aligned too."""
    if d % 4 or d > 128 * MAX_CHUNKS:
        return 0
    if any(p % 16 for p in float_ptrs) or (mask_ptr or 0) % 4:
        return 0
    return -(-d // 128)


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
    mask_ptr = None if dropout_mask is None else dropout_mask.data_ptr()
    res_ptr = None if residual is None else residual.data_ptr()
    chunks = vector_chunks(d, [p for p in (x.data_ptr(), scale.data_ptr(),
                                           res_ptr, out.data_ptr())
                               if p is not None], mask_ptr)
    lib = _build.load()
    rc = lib.repro_fused_layer(
        x.data_ptr(), scale.data_ptr(), mask_ptr, res_ptr, out.data_ptr(), b,
        d, float(eps), float(1.0 - dropout_rate), int(use_rmsnorm),
        int(use_relu), chunks, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "fused_layer")
    global LAUNCHES
    LAUNCHES += 1
    ROUTE_LAUNCHES["vector" if chunks else "scalar"] += 1
    return out
