"""Fused mini-batch extraction — Alg. 2 phases 2-4 in one CUDA kernel.

Counterpart of ``repro/kernels/extract_gather.py``. For each sampled row the
kernel (``csrc/extract_gather.cu``) reads the row's CSR extent, walks up to
``max_deg`` of its edges, keeps those whose column is one of the sorted
distinct sampled columns, rescales per column (self-loops exempt when
``diag``, Eq. 24) and writes the dense ``(b_r, b_c)`` row once; no COO
triples round-trip through device memory.

:func:`extract_dense_fused` launches the kernel for CUDA tensors and runs
:func:`extract_dense_plain`, the same function in plain PyTorch, for CPU
tensors. On graphs without duplicate edges both equal
``core.sampling.extract_dense_block`` bit for bit.
"""
from __future__ import annotations

from typing import Union

import torch

from repro_torch.kernels import _build

# kernel launches so far (a run zeroes it to show that a path used the kernel)
LAUNCHES = 0


def _lane_scale(rows: torch.Tensor, cols: torch.Tensor,
                col_scale: Union[torch.Tensor, float],
                diag: bool) -> torch.Tensor:
    """(b_r, b_c) factor of each output cell: the column's off-diagonal
    rescale, 1 on the self-loop lane of a diagonal block."""
    b_r, b_c = rows.shape[0], cols.shape[0]
    scale = torch.as_tensor(col_scale, dtype=torch.float32,
                            device=cols.device)
    scale = scale.expand(b_c).expand(b_r, b_c)
    if not diag:
        return scale
    on_diag = cols[None, :] == rows[:, None]
    return torch.where(on_diag, torch.ones_like(scale), scale)


def extract_dense_plain(rp: torch.Tensor, ci: torch.Tensor,
                        val: torch.Tensor, rows: torch.Tensor,
                        cols: torch.Tensor, *,
                        col_scale: Union[torch.Tensor, float], diag: bool,
                        max_deg: int) -> torch.Tensor:
    """The kernel's function in plain PyTorch: a per-edge ``searchsorted``
    over the rows' first ``max_deg`` edges, summed per cell, times the lane
    scale (the kernel's ``acc * lane_scale``)."""
    b_r, b_c = rows.shape[0], cols.shape[0]
    if b_r == 0 or b_c == 0:
        return torch.zeros((b_r, b_c), dtype=torch.float32,
                           device=rows.device)
    rows = rows.long()
    start = rp.long()[rows]
    cnt = (rp.long()[rows + 1] - start).clamp(max=max_deg)
    own = torch.repeat_interleave(torch.arange(b_r, device=rows.device), cnt)
    first = torch.cumsum(cnt, 0) - cnt                 # row's first slot
    slot = torch.arange(own.shape[0], device=rows.device)
    src = start[own] + slot - first[own]
    col = ci[src].to(cols.dtype)
    pos = torch.searchsorted(cols, col).clamp(max=max(b_c - 1, 0))
    hit = cols[pos] == col
    acc = torch.zeros((b_r, b_c), dtype=torch.float32, device=rows.device)
    acc.index_put_((own[hit], pos[hit]), val[src][hit].float(),
                   accumulate=True)
    return acc * _lane_scale(rows, cols.long(), col_scale, diag)


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int,
           device: torch.device) -> None:
    if t.device != device or t.dtype != dtype or t.dim() != ndim \
            or not t.is_contiguous():
        raise ValueError(
            f"extract_dense_fused: {name} must be a contiguous {ndim}-D "
            f"{dtype} tensor on {device}, got {tuple(t.shape)} {t.dtype} on "
            f"{t.device}")


def extract_dense_fused(rp: torch.Tensor, ci: torch.Tensor,
                        val: torch.Tensor, rows: torch.Tensor,
                        cols: torch.Tensor, *,
                        col_scale: Union[torch.Tensor, float],
                        diag: bool, max_deg: int) -> torch.Tensor:
    """The dense rescaled ``(b_r, b_c)`` float32 block of the sampled rows
    ``rows`` and sorted distinct columns ``cols`` (int32), straight from
    the CSR triple (int32 ``rp``/``ci``, float32 ``val``). ``col_scale`` is
    a float or a ``(b_c,)`` float32 tensor; ``diag`` marks coinciding row
    and column vertex sets."""
    if rows.device.type == "cpu":
        return extract_dense_plain(rp, ci, val, rows, cols,
                                   col_scale=col_scale, diag=diag,
                                   max_deg=max_deg)
    dev = rows.device
    if dev.type != "cuda":
        raise ValueError(f"extract_dense_fused: unsupported device {dev}")
    for t, name, dtype in ((rp, "rp", torch.int32), (ci, "ci", torch.int32),
                           (val, "val", torch.float32),
                           (rows, "rows", torch.int32),
                           (cols, "cols", torch.int32)):
        _check(t, name, dtype, 1, dev)
    b_r, b_c = rows.shape[0], cols.shape[0]
    if isinstance(col_scale, torch.Tensor):
        _check(col_scale, "col_scale", torch.float32, 1, dev)
        if col_scale.shape[0] != b_c:
            raise ValueError(f"extract_dense_fused: col_scale has "
                             f"{col_scale.shape[0]} entries for {b_c} columns")
        scale_ptr, scalar = col_scale.data_ptr(), 1.0
    else:
        scale_ptr, scalar = None, float(col_scale)
    if max_deg < 0:
        raise ValueError(f"extract_dense_fused: max_deg={max_deg} < 0")
    out = torch.empty((b_r, b_c), dtype=torch.float32, device=dev)
    if b_r == 0 or b_c == 0:
        return out
    lib = _build.load()
    rc = lib.repro_extract_dense_fused(
        rp.data_ptr(), ci.data_ptr(), val.data_ptr(), rows.data_ptr(),
        cols.data_ptr(), scale_ptr, scalar, int(bool(diag)), b_r, b_c,
        int(max_deg), out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "extract_dense_fused")
    global LAUNCHES
    LAUNCHES += 1
    return out
