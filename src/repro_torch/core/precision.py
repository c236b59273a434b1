"""The all-reduces of the 4D step, the wire formats of its compressed
collectives, and row-quantized storage for the serving embedding cache.

Counterpart of ``repro/core/precision.py``. :class:`AllReduce` is the PMM
all-reduce over one mesh axis as a ``torch.autograd.Function``: an
all-reduce SUM over the axis's process group forward and the same
all-reduce backward, which is what the reference's ``shard_map(...,
check_vma=False)`` transposes ``psum`` to (paper Eqs. 15-17).
:func:`psum_fp32` is the always-FP32 reduction of the numerically
sensitive sums (RMSNorm, the loss) and :func:`psum_maybe_bf16` the PMM
all-reduce under ``TrainOptions.bf16_collectives`` (paper §V-B): cast to
bf16, sum, cast back. Over an axis without a process group (one rank: the
single-device step) the sum is the identity and makes no call, but the
bf16 round trip stays, as in the reference, so one program gives one
answer at every mesh size.

The wire formats (``WIRE_FORMATS``) and the absmax quantizers
(:func:`quantize` / :func:`dequantize`, int8 or nibble-packed int4 with one
FP32 scale per row) are the reference's jnp ops, outside any kernel, as
plain tensor functions with the arithmetic the reference's compiled rings
perform: ``torch.round`` rounds half to even like ``jnp.rint``; the scale
is the absmax times the float32 reciprocal of qmax (XLA folds the
division by the constant into that product under ``jit``); ``x / scale``
is a division, as there; and a dequantized value added to or subtracted
from a float (:func:`dequantize_add`: the rings' accumulations and
residuals) is rounded once, as the fused multiply-add XLA's CPU backend
contracts it to in its vectorised loops.
``pmm3d`` builds the quantized ring collectives on them.

The int8 row quantizers at the bottom are a copy of the reference's
host-side ones: cached per-vertex embeddings are stored at 1 byte/element
+ one FP32 scale per row, quartering cache memory vs FP32.
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.obs import comm

# wire formats of the compressible collectives, weakest to strongest;
# "none" is the FP32 wire (subject to bf16_collectives)
WIRE_FORMATS = ("none", "bf16", "int8", "int4")
# quantized formats -> bits per element on the wire
WIRE_BITS = {"int8": 8, "int4": 4}
_QMAX = {8: 127, 4: 7}
# float32(1 / qmax), exactly representable as a Python float
_RCP = {bits: float(np.float32(1.0 / q)) for bits, q in _QMAX.items()}


class AllReduce(torch.autograd.Function):
    """Sum over ``axis``'s process group; the backward sums the cotangent
    over the same group (``psum`` transposed to ``psum``)."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis, ctx.scope = axis, comm.current_scope()
        y = x.detach().clone(memory_format=torch.contiguous_format)
        comm.record("all-reduce", y)
        dist.all_reduce(y, group=axis.group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        with comm.restore(ctx.scope):
            comm.record("all-reduce", g)
        dist.all_reduce(g, group=ctx.axis.group)
        return g, None


def psum(x: torch.Tensor, axis) -> torch.Tensor:
    """All-reduce SUM over ``axis`` (a ``pmm3d.Axis``), differentiable;
    ``x`` itself where the axis has no process group."""
    if axis.group is None:
        return x
    return AllReduce.apply(x, axis)


def psum_maybe_bf16(x: torch.Tensor, axis, bf16: bool) -> torch.Tensor:
    """All-reduce a partial sum, in bfloat16 on the wire when ``bf16``:
    FP32 master values, the cast only around the sum (paper §V-B), its
    round trip kept where nothing travels."""
    if bf16 and x.dtype == torch.float32:
        return psum(x.to(torch.bfloat16), axis).to(torch.float32)
    return psum(x, axis)


def psum_fp32(x: torch.Tensor, axis) -> torch.Tensor:
    """Always-FP32 all-reduce for numerically sensitive reductions (RMSNorm
    sum-of-squares, logsumexp terms)."""
    return psum(x.float(), axis)


# ---------------------------------------------------------------------------
# Absmax quantizers (the compressed-collective wire format)
# ---------------------------------------------------------------------------

def absmax_scale(x: torch.Tensor, bits: int) -> torch.Tensor:
    """Per-row (last axis) symmetric absmax scale; 1.0 for all-zero rows."""
    amax = torch.amax(torch.abs(x), dim=-1, keepdim=True)
    return torch.where(amax > 0, amax * _RCP[bits],
                       torch.ones_like(amax)).to(torch.float32)


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """Pack int4 values (int8 storage, range [-7, 7]) two per byte along the
    last axis (must be even): element 2k in the low nibble, 2k+1 high."""
    if q.shape[-1] % 2:
        raise ValueError(f"int4 packing needs an even last axis, got "
                         f"{tuple(q.shape)}")
    u = q.contiguous().view(torch.uint8) & 0xF
    return (u[..., ::2] | (u[..., 1::2] << 4)).view(torch.int8)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_int4`: (..., n/2) int8 -> (..., n) int8."""
    u = packed.contiguous().view(torch.uint8)
    nib = torch.stack([u & 0xF, u >> 4], dim=-1).reshape(
        packed.shape[:-1] + (2 * packed.shape[-1],))
    v = nib.to(torch.int8)
    return torch.where(v >= 8, v - 16, v)


def quantize(x: torch.Tensor, bits: int) -> Tuple[torch.Tensor,
                                                  torch.Tensor]:
    """Symmetric absmax quantization over the last axis. Returns ``(q,
    scale)``: ``q`` int8 of ``x.shape`` at 8 bits, nibble-packed to half
    width at 4 bits, and ``scale`` float32 of ``x.shape[:-1] + (1,)``, so
    that ``dequantize(q, scale, bits)`` is within ``scale / 2`` of a finite
    ``x``."""
    x = x.to(torch.float32)
    scale = absmax_scale(x, bits)
    q = torch.clamp(torch.round(x / scale), -_QMAX[bits],
                    _QMAX[bits]).to(torch.int8)
    if bits == 4:
        q = pack_int4(q)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor,
               bits: int) -> torch.Tensor:
    """Inverse of :func:`quantize` (up to the absmax rounding error)."""
    if bits == 4:
        q = unpack_int4(q)
    return q.to(torch.float32) * scale


def dequantize_add(acc: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                   bits: int, sign: int = 1) -> torch.Tensor:
    """``acc + sign * dequantize(q, scale, bits)`` in float32, rounded once
    (a fused multiply-add). ``q * scale`` is exact in float64; the sum is
    rounded to odd there (its error found by TwoSum, then the odd one of
    the two neighbours taken), and that rounds to float32 as the exact sum
    would."""
    if bits == 4:
        q = unpack_int4(q)
    a = acc.to(torch.float64)
    p = sign * q.to(torch.float64) * scale.to(torch.float64)
    s = a + p
    bb = s - a
    err = (a - (s - bb)) + (p - bb)             # a + p == s + err exactly
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.full_like(s, math.inf),
                         torch.full_like(s, -math.inf))
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.to(torch.float32)


# ---------------------------------------------------------------------------
# Row-quantized storage (serving embedding cache)
# ---------------------------------------------------------------------------

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
