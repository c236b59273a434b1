"""The all-reduces of the 4D step, and row-quantized storage for the
serving embedding cache.

Counterpart of ``repro/core/precision.py``. :class:`AllReduce` is the PMM
all-reduce over one mesh axis as a ``torch.autograd.Function``: an
all-reduce SUM over the axis's process group forward and the same
all-reduce backward, which is what the reference's ``shard_map(...,
check_vma=False)`` transposes ``psum`` to (paper Eqs. 15-17).
:func:`psum_fp32` is the always-FP32 reduction of the numerically
sensitive sums (RMSNorm, the loss) and :func:`psum_maybe_bf16` the PMM
all-reduce under ``TrainOptions.bf16_collectives``, whose bf16 wire is not
ported (ROADMAP queue 1, "Ring overlap and compressed collectives"). Over
an axis without a process group (one rank: the single-device step) each
is the identity and makes no call.

The int8 row quantizers are a copy of the reference's: cached per-vertex
embeddings are stored at 1 byte/element + one FP32 scale per row,
quartering cache memory vs FP32. Host-side numpy by design — cache
lookups happen outside the device forward. The compressed-collective
quantizers of the JAX module come with compressed collectives.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.distributed as dist

BF16_WIRE = ("bf16_collectives=True: the bf16 wire of the PMM all-reduces "
             'is ROADMAP queue 1, "Ring overlap and compressed '
             'collectives"')


class AllReduce(torch.autograd.Function):
    """Sum over ``axis``'s process group; the backward sums the cotangent
    over the same group (``psum`` transposed to ``psum``)."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        y = x.detach().clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, group=axis.group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.axis.group)
        return g, None


def psum(x: torch.Tensor, axis) -> torch.Tensor:
    """All-reduce SUM over ``axis`` (a ``pmm3d.Axis``), differentiable;
    ``x`` itself where the axis has no process group."""
    if axis.group is None:
        return x
    return AllReduce.apply(x, axis)


def psum_maybe_bf16(x: torch.Tensor, axis, bf16: bool) -> torch.Tensor:
    """All-reduce a partial sum; FP32 on the wire (the bf16 wire raises)."""
    if bf16:
        raise NotImplementedError(BF16_WIRE)
    return psum(x, axis)


def psum_fp32(x: torch.Tensor, axis) -> torch.Tensor:
    """Always-FP32 all-reduce for numerically sensitive reductions (RMSNorm
    sum-of-squares, logsumexp terms)."""
    return psum(x.float(), axis)


def quantize_int8(x: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Symmetric absmax int8 quantization over the last axis.

    Returns ``(q, scale)`` with ``q`` int8 of ``x.shape`` and ``scale``
    float32 of ``x.shape[:-1] + (1,)`` such that ``q * scale ~= x``.
    All-zero rows get scale 1.0 (and quantize to zeros).
    """
    x = np.asarray(x, np.float32)
    amax = np.max(np.abs(x), axis=-1, keepdims=True)
    scale = np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)
    q = np.clip(np.rint(x / scale), -127, 127).astype(np.int8)
    return q, scale


def dequantize_int8(q: np.ndarray, scale: np.ndarray) -> np.ndarray:
    """Inverse of :func:`quantize_int8` (up to rounding error)."""
    return (q.astype(np.float32) * np.asarray(scale, np.float32))
