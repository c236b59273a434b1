"""Row-quantized storage for the serving embedding cache.

A copy of the int8 row quantizers of ``repro/core/precision.py``: cached
per-vertex embeddings are stored at 1 byte/element + one FP32 scale per
row, quartering cache memory vs FP32. Host-side numpy by design — cache
lookups happen outside the device forward. The compressed-collective
quantizers of the JAX module come with the distributed step.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


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
