"""Counter-based random draws — the sampler's permutation keys and the
dropout keep-mask — as CUDA kernels that read their key from the device.

Not the port of a TPU kernel: the reference draws with XLA's threefry.
The port's draws are pure functions of a 64-bit key through splitmix64,
``fold_in(k, i) = mix(mix(k) ^ i)`` (``core.sampling.fold_in``), computed
here on int64 tensors that hold the uint64 bits. The key is a 0-d int64
tensor on the device, derived there from the step counter, so a CUDA
graph that replays the training step draws the current step's numbers:

* :func:`hash_keys` — ``fold_in(key, i)`` for ``i < n``, int64; the
  samplers argsort them into a permutation (``fold_in(key, .)`` is a
  bijection, so there are no ties);
* :func:`keep_mask` — the dropout keep-mask, lane ``i = row * cols + col``
  kept when ``(fold_in(key, i) >> 40) * 2^-24 < float32(1 - rate)``.

Each launches ``csrc/counter_rng.cu`` for a CUDA key, runs its plain
version (``hash_keys_plain``, ``keep_mask_plain``: the same bits in int64
tensor ops, about a dozen launches each) for a CPU one and returns an
output of the right shape on the meta device. ``hash_keys_cost`` and
``keep_mask_cost`` count their bytes (the key read, the output written;
their 64-bit integer work has no rate in the card's table).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.kernels import _build, _observe

# kernel launches so far (a run zeroes them to show that a path used the
# kernels)
HASH_LAUNCHES = 0
MASK_LAUNCHES = 0

MASK64 = (1 << 64) - 1


def signed64(u: int) -> int:
    """The int64 holding the bits of the uint64 ``u`` (mod 2^64)."""
    u &= MASK64
    return u - (1 << 64) if u >> 63 else u


_GOLDEN = signed64(0x9E3779B97F4A7C15)
_MUL1 = signed64(0xBF58476D1CE4E5B9)
_MUL2 = signed64(0x94D049BB133111EB)


def _shr(x: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of int64 bits (``>>`` on int64 is arithmetic)."""
    return (x >> k) & ((1 << (64 - k)) - 1)


def splitmix64(x: torch.Tensor) -> torch.Tensor:
    """splitmix64 on int64 tensors holding uint64 bits (adds and products
    wrap mod 2^64)."""
    x = x + _GOLDEN
    x = (x ^ _shr(x, 30)) * _MUL1
    x = (x ^ _shr(x, 27)) * _MUL2
    return x ^ _shr(x, 31)


def keep_threshold(rate: float) -> int:
    """The integer form of the keep test: ``u * 2^-24 < float32(1 - rate)``
    holds for a 24-bit ``u`` exactly when ``u < ceil(float32(1 - rate) *
    2^24)``."""
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"keep_mask: rate={rate}")
    return math.ceil(float(np.float32(1.0 - rate)) * 2 ** 24)


def _check_key(key: torch.Tensor, name: str) -> None:
    if key.dim() != 0 or key.dtype != torch.int64:
        raise ValueError(f"{name}: the key must be a 0-d int64 tensor, got "
                         f"{tuple(key.shape)} {key.dtype}")


def hash_keys_plain(key: torch.Tensor, n: int) -> torch.Tensor:
    """``fold_in(key, i)`` for ``i < n`` in int64 tensor ops."""
    i = torch.arange(n, dtype=torch.int64, device=key.device)
    return splitmix64(i ^ splitmix64(key))


def keep_mask_plain(key: torch.Tensor, rows: int, cols: int,
                    rate: float) -> torch.Tensor:
    """The (rows, cols) bool keep-mask in int64 tensor ops."""
    u = _shr(hash_keys_plain(key, rows * cols), 40)
    return (u < keep_threshold(rate)).reshape(rows, cols)


def hash_keys_cost(key: torch.Tensor, n: int, *, out=None) -> tuple:
    """(operations, bytes) of :func:`hash_keys`: the key read, n int64
    written (integer work, counted as no floating-point operation)."""
    return 0, 8 * n + 8


def keep_mask_cost(key: torch.Tensor, rows: int, cols: int, rate: float, *,
                   out=None) -> tuple:
    """(operations, bytes) of :func:`keep_mask`: the key read, the bool
    mask written."""
    return 0, rows * cols + 8


@_observe.counted(hash_keys_cost)
def hash_keys(key: torch.Tensor, n: int) -> torch.Tensor:
    """(n,) int64 ``fold_in(key, i)``: the kernel for a CUDA key, the plain
    version for a CPU one."""
    _check_key(key, "hash_keys")
    if key.device.type == "cpu":
        return hash_keys_plain(key, n)
    if key.device.type not in ("cuda", "meta"):
        raise ValueError(f"hash_keys: unsupported device {key.device}")
    out = torch.empty((n,), dtype=torch.int64, device=key.device)
    if n == 0 or key.device.type == "meta":
        return out
    rc = _build.load().repro_hash_keys(
        key.data_ptr(), n, out.data_ptr(),
        torch.cuda.current_stream(key.device).cuda_stream)
    _build.check(rc, "hash_keys")
    global HASH_LAUNCHES
    HASH_LAUNCHES += 1
    return out


@_observe.counted(keep_mask_cost)
def keep_mask(key: torch.Tensor, rows: int, cols: int,
              rate: float) -> torch.Tensor:
    """(rows, cols) bool keep-mask of dropout ``rate``: the kernel for a
    CUDA key, the plain version for a CPU one."""
    _check_key(key, "keep_mask")
    threshold = keep_threshold(rate)
    if key.device.type == "cpu":
        return keep_mask_plain(key, rows, cols, rate)
    if key.device.type not in ("cuda", "meta"):
        raise ValueError(f"keep_mask: unsupported device {key.device}")
    out = torch.empty((rows, cols), dtype=torch.bool, device=key.device)
    if rows * cols == 0 or key.device.type == "meta":
        return out
    rc = _build.load().repro_keep_mask(
        key.data_ptr(), rows * cols, threshold, out.data_ptr(),
        torch.cuda.current_stream(key.device).cuda_stream)
    _build.check(rc, "keep_mask")
    global MASK_LAUNCHES
    MASK_LAUNCHES += 1
    return out
