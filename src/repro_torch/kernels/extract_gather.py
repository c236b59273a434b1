"""Fused mini-batch extraction — Alg. 2 phases 2-4 in one CUDA kernel.

Counterpart of ``repro/kernels/extract_gather.py``. For each sampled row the
kernel (``csrc/extract_gather.cu``) reads the row's CSR extent, walks up to
``max_deg`` of its edges, keeps those whose column is one of the sorted
distinct sampled columns, rescales per column (self-loops exempt when
``diag``, Eq. 24) and writes the dense ``(b_r, b_c)`` row once; no COO
triples round-trip through device memory. A CTA zero-fills the contiguous
range of its rows, then places the rows' few values (:func:`launch_config`
sizes the grid).

:func:`extract_dense_fused` launches the kernel for CUDA tensors and runs
:func:`extract_dense_plain`, the same function in plain PyTorch, for CPU
tensors; on the meta device it returns a block of the right shape and
computes nothing. :func:`extract_dense_cost` counts its work. On graphs
without duplicate edges both equal
``core.sampling.extract_dense_block`` bit for bit; where a row repeats an
edge, the kernel sums ``val * scale`` per edge and the plain version scales
the sum, so they agree up to rounding.

The block is float32 or, with ``dtype=torch.bfloat16`` (the training
step's ``block_dtype="bf16"``, the reference's ``dtype`` argument), bf16:
the values are computed in float32 and rounded once, so on graphs without
duplicate edges the bf16 block is the float32 block cast to bf16, bit for
bit; the kernel writes it directly, half the bytes.
"""
from __future__ import annotations

from typing import Union

import math

import torch

from repro_torch.kernels import _build, _observe

# kernel launches so far (a run zeroes them to show that a path used the
# kernel), in all and by the block's type
LAUNCHES = 0
ROUTE_LAUNCHES = {"f32": 0, "bf16": 0}
_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}

THREADS = 256                # threads a CTA has: 8 warps
CTAS_PER_SM = 4              # the grid aimed at: 4 CTAs an SM, ...
MIN_ROWS_PER_CTA = 4         # ... each owning at least 4 rows
MAX_ROWS_PER_CTA = 16        # ... and at most 16
STAGE_BYTES = 48 * 1024      # shared memory a launch gets by default


def launch_config(b_r: int, b_c: int, per_column: bool, n_sm: int) -> tuple:
    """``(grid, rows_per_cta, staged)`` of a launch on a card with ``n_sm``
    SMs. A CTA owns ``rows_per_cta`` consecutive rows (one contiguous
    range of the block): the least power of two from 4 to 16 that keeps
    the grid at about 4 CTAs an SM. The sorted columns (with their scales,
    from a 16-byte boundary, when ``per_column``) are staged in shared
    memory where they fit in 48 KB, else read from global memory."""
    rows_per_cta = MIN_ROWS_PER_CTA
    while rows_per_cta < MAX_ROWS_PER_CTA \
            and rows_per_cta * CTAS_PER_SM * n_sm < b_r:
        rows_per_cta *= 2
    grid = -(-b_r // rows_per_cta)
    staged = 4 * ((-(-b_c // 4) * 4 if per_column else 0) + b_c)
    return grid, rows_per_cta, staged <= STAGE_BYTES


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
                        max_deg: int,
                        dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The kernel's function in plain PyTorch: a per-edge ``searchsorted``
    over the rows' first ``max_deg`` edges, summed per cell in float32,
    times the lane scale (the kernel's ``acc * lane_scale``), rounded once
    to ``dtype``."""
    b_r, b_c = rows.shape[0], cols.shape[0]
    if b_r == 0 or b_c == 0:
        return torch.zeros((b_r, b_c), dtype=dtype, device=rows.device)
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
    return (acc * _lane_scale(rows, cols.long(), col_scale, diag)).to(dtype)


def edges_walked(rp: torch.Tensor, rows: torch.Tensor, max_deg: int) -> int:
    """The CSR edges the kernel walks for ``rows`` (at most ``max_deg`` a
    row; a host read), ``max_deg`` a row on the meta device."""
    if rows.device.type == "meta":
        return rows.shape[0] * max_deg
    r = rows.long()
    return int((rp[r + 1] - rp[r]).clamp(max=max_deg).sum())


def extract_dense_cost(rp: torch.Tensor, ci: torch.Tensor,
                       val: torch.Tensor, rows: torch.Tensor,
                       cols: torch.Tensor, *,
                       col_scale: Union[torch.Tensor, float], diag: bool,
                       max_deg: int, dtype: torch.dtype = torch.float32,
                       out=None) -> tuple:
    """(operations, bytes) of :func:`extract_dense_fused` on these inputs:
    the rows, their two row pointers, the edges walked (column and value),
    the sampled columns (and their scales) read once and the dense block
    written once (2 bytes a cell in bf16); a binary search of each walked
    edge among the columns, and a multiply and an add for each nonzero
    placed (``out``'s). The
    edges walked are read on the host; on the meta device every row walks
    ``max_deg`` edges and every walked edge is placed."""
    b_r, b_c = rows.shape[0], cols.shape[0]
    walked = edges_walked(rp, rows, max_deg)
    if rows.device.type == "meta":
        placed = min(walked, b_r * b_c)
    else:
        placed = walked if out is None else int(torch.count_nonzero(out))
    per_column = isinstance(col_scale, torch.Tensor)
    out_bytes = torch.empty((), dtype=dtype).element_size()
    n_bytes = (4 * b_r + 8 * b_r + 8 * walked + 4 * b_c
               + (4 * b_c if per_column else 0) + out_bytes * b_r * b_c)
    n_ops = walked * (math.ceil(math.log2(max(b_c, 2))) + 1) + 2 * placed
    return n_ops, n_bytes


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int,
           device: torch.device) -> None:
    if t.device != device or t.dtype != dtype or t.dim() != ndim \
            or not t.is_contiguous():
        raise ValueError(
            f"extract_dense_fused: {name} must be a contiguous {ndim}-D "
            f"{dtype} tensor on {device}, got {tuple(t.shape)} {t.dtype} on "
            f"{t.device}")


@_observe.counted(extract_dense_cost)
def extract_dense_fused(rp: torch.Tensor, ci: torch.Tensor,
                        val: torch.Tensor, rows: torch.Tensor,
                        cols: torch.Tensor, *,
                        col_scale: Union[torch.Tensor, float],
                        diag: bool, max_deg: int,
                        dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The dense rescaled ``(b_r, b_c)`` block of the sampled rows ``rows``
    and sorted distinct columns ``cols`` (int32), straight from the CSR
    triple (int32 ``rp``/``ci``, float32 ``val``), in ``dtype`` (float32
    or bfloat16; computed in float32, rounded once). ``col_scale`` is a
    float or a ``(b_c,)`` float32 tensor; ``diag`` marks coinciding row and
    column vertex sets."""
    if dtype not in _DTYPES:
        raise ValueError(f"extract_dense_fused: dtype must be float32 or "
                         f"bfloat16, got {dtype}")
    if rows.device.type == "cpu":
        return extract_dense_plain(rp, ci, val, rows, cols,
                                   col_scale=col_scale, diag=diag,
                                   max_deg=max_deg, dtype=dtype)
    dev = rows.device
    if dev.type not in ("cuda", "meta"):
        raise ValueError(f"extract_dense_fused: unsupported device {dev}")
    for t, name, want in ((rp, "rp", torch.int32), (ci, "ci", torch.int32),
                          (val, "val", torch.float32),
                          (rows, "rows", torch.int32),
                          (cols, "cols", torch.int32)):
        _check(t, name, want, 1, dev)
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
    out = torch.empty((b_r, b_c), dtype=dtype, device=dev)
    if b_r == 0 or b_c == 0 or dev.type == "meta":
        return out
    grid, rows_per_cta, staged = launch_config(
        b_r, b_c, scale_ptr is not None,
        torch.cuda.get_device_properties(dev).multi_processor_count)
    lib = _build.load()
    rc = lib.repro_extract_dense_fused(
        rp.data_ptr(), ci.data_ptr(), val.data_ptr(), rows.data_ptr(),
        cols.data_ptr(), scale_ptr, scalar, int(bool(diag)), b_r, b_c,
        int(max_deg), grid, rows_per_cta, int(staged),
        int(dtype == torch.bfloat16), out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "extract_dense_fused")
    global LAUNCHES
    LAUNCHES += 1
    ROUTE_LAUNCHES[_DTYPES[dtype]] += 1
    return out
