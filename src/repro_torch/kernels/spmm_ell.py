"""Block-ELL SpMM — the paper's aggregation (Eq. 5) as a CUDA kernel.

Counterpart of ``repro/kernels/spmm_ell.py``. A mini-batch adjacency is
stored as block-ELL: rows in blocks of ``bm``, each row-block holding ``S``
slots, each slot a dense ``(bm, bn)`` tile and the column-block it came
from::

    tiles  : (n_rb, S, bm, bn) float32 or bfloat16
    colidx : (n_rb, S)         int32   (padding: a zero tile at block 0)

:func:`spmm_ell` computes ``out[i*bm:(i+1)*bm] = sum_s tiles[i, s] @
x[colidx[i, s]*bn : +bn]`` in float32, output in x's type, on three routes:
all float32, all bfloat16, and bfloat16 tiles with a float32 x (the
``block_dtype="bf16"`` training step's, as the reference promotes the
tile): the CUDA kernel
(``csrc/spmm_ell.cu``) for CUDA tensors, :func:`spmm_ell_plain` — the same
function in plain PyTorch, slot by slot as the reference's oracle sums —
for CPU tensors, and on the meta device only its output's shape and type
(the counterpart of a Pallas call's abstract evaluation). The kernel finds padding from the tiles themselves, not
from ``colidx``, and skips every all-zero step of a tile (8 rows x 1
column, the work of one warp at a time; :func:`spmm_ell_work` counts
them): for finite x the same function (a non-finite x under a skipped
step no longer turns the output to NaN). :func:`spmm_ell_dx` is its input gradient
``A^T @ g`` (the reference's ``_spmm_bwd`` is plain jnp): a deterministic
kernel (``csrc/spmm_ell_dx.cu``) over the live steps of the transpose, with
:func:`spmm_ell_dx_plain` beside it. :func:`spmm_ell_cost` and
:func:`spmm_ell_dx_cost` count their work: the products of the tiles'
nonzeros (every slot on the meta device, where no value is known), each
input byte read once and the output written once. The layout helpers (:func:`dense_to_block_ell`,
:func:`dense_to_block_ell_ranked`, :func:`ell_to_dense`,
:func:`block_density`) are plain PyTorch and give the reference's layouts
bit for bit.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build, _observe

# kernel launches so far, of the product and of its input gradient, in all
# and by route (a run zeroes them to show that a path used the kernels)
LAUNCHES = 0
DX_LAUNCHES = 0
ROUTE_LAUNCHES = {"f32": 0, "bf16": 0, "bf16_f32": 0}
DX_ROUTE_LAUNCHES = {"f32": 0, "bf16": 0, "bf16_f32": 0}

# (tile type, operand type) -> (route, the C entry points' route code)
_ROUTES = {(torch.float32, torch.float32): ("f32", 0),
           (torch.bfloat16, torch.bfloat16): ("bf16", 1),
           (torch.bfloat16, torch.float32): ("bf16_f32", 2)}


def route_of(tiles: torch.Tensor, x: torch.Tensor, name: str = "spmm_ell",
             operand: str = "x") -> Tuple[str, int]:
    """The route of a tile type and an operand type: all float32, all
    bfloat16, or bfloat16 tiles with a float32 operand; raises on any
    other pair."""
    try:
        return _ROUTES[(tiles.dtype, x.dtype)]
    except KeyError:
        raise ValueError(
            f"{name}: tiles and {operand} must be all float32, all bfloat16, "
            f"or bfloat16 tiles with a float32 {operand}; got {tiles.dtype} "
            f"and {x.dtype}") from None


def spmm_ell_plain(tiles: torch.Tensor, colidx: torch.Tensor,
                   x: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch: accumulate slot by slot in
    float32 (``ref.spmm_ell_ref``'s order); column-block indices are
    clamped as the reference's dynamic slice clamps them."""
    n_rb, n_slots, bm, bn = tiles.shape
    d = x.shape[1]
    n_cb = x.shape[0] // bn
    c = colidx.long().clamp(0, max(n_cb - 1, 0))
    xb = x.reshape(n_cb, bn, d)
    acc = torch.zeros((n_rb, bm, d), dtype=torch.float32, device=x.device)
    for s in range(n_slots):
        acc = acc + torch.matmul(tiles[:, s].float(), xb[c[:, s]].float())
    return acc.reshape(n_rb * bm, d).to(x.dtype)


def _nonzeros(tiles: torch.Tensor) -> int:
    """The tiles' nonzeros (a host read), every slot on the meta
    device."""
    if tiles.device.type == "meta":
        return tiles.numel()
    return int(torch.count_nonzero(tiles))


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def spmm_ell_cost(tiles: torch.Tensor, colidx: torch.Tensor,
                  x: torch.Tensor, *, out=None) -> tuple:
    """(operations, bytes) of :func:`spmm_ell`: a multiply and an add per
    nonzero of the tiles and column of x; every tile (padding included,
    to find it), colidx and x read once, the output written once."""
    n_rb, _, bm, _ = tiles.shape
    d = x.shape[1]
    return (2 * _nonzeros(tiles) * d,
            _nbytes(tiles) + _nbytes(colidx) + _nbytes(x)
            + n_rb * bm * d * x.element_size())


def spmm_ell_dx_cost(tiles: torch.Tensor, colidx: torch.Tensor,
                     g: torch.Tensor, n_rows_x: int, *, out=None) -> tuple:
    """(operations, bytes) of :func:`spmm_ell_dx`: a multiply and an add
    per nonzero of the tiles and column of g; every tile, colidx and g
    read once, dX written once."""
    d = g.shape[1]
    return (2 * _nonzeros(tiles) * d,
            _nbytes(tiles) + _nbytes(colidx) + _nbytes(g)
            + n_rows_x * d * g.element_size())


def spmm_ell_work(tiles: torch.Tensor, colidx: torch.Tensor,
                  n_cb: Optional[int] = None) -> dict:
    """The work the two kernels find in a block-ELL matrix, at their own
    units, in plain PyTorch (a measurement aid: no path calls it).

    A chunk is 32 x 32 elements of a tile. A CTA owns a strip of 32 output
    rows (the forward: tile rows of one row-block; the dX: tile columns of
    one of the ``n_cb`` column blocks, by default as many as ``colidx``
    names), and each of its four warps 8 of them. A step is what one warp
    multiplies at a time: in the forward one tile column under its 8 rows,
    in the dX one tile row under its 8 columns; a step is live if any of
    its 8 elements is nonzero (-0 counts as zero, NaN does not). Returns
    the live tiles, live chunks, each kernel's live steps and the
    nonzeros; each kernel's CTAs (one feature tile) and the most that any
    one CTA carries (``fwd_cta_max`` / ``dx_cta_max``: its chunks, steps,
    the steps of its busiest warp and its nonzeros; the dX's also its
    live tiles)."""
    n_rb, n_slots, bm, bn = tiles.shape
    kc_n, cc_n = -(-bm // 32), -(-bn // 32)
    nz = torch.zeros((n_rb, n_slots, kc_n * 32, cc_n * 32), dtype=torch.bool,
                     device=tiles.device)
    nz[:, :, :bm, :bn] = tiles != 0
    # (rb, s, row strip, row group, 8 rows, column strip, column group, 8)
    e = nz.reshape(n_rb, n_slots, kc_n, 4, 8, cc_n, 4, 8)
    chunks = e.any(dim=(3, 4, 6, 7))                 # (rb, s, kc, cc)
    nzc = e.sum(dim=(3, 4, 6, 7))                    # nonzeros by chunk
    fsteps = e.any(dim=4)            # (rb, s, kc, g, cc, cg, column)
    dsteps = e.any(dim=7)            # (rb, s, kc, g, row, cc, cg)
    # the forward's CTA (rb, kc), its warps the row groups g
    f_warp = fsteps.sum(dim=(1, 4, 5, 6))            # (rb, kc, g)
    f_cta = {"chunks": chunks.sum(dim=(1, 3)), "steps": f_warp.sum(dim=2),
             "warp_steps": f_warp.amax(dim=2),
             "nonzeros": nzc.sum(dim=(1, 3))}
    # the dX's CTA (cb, cc): the tiles of column block cb, its warps the
    # column groups cg
    if n_cb is None:
        n_cb = int(colidx.max()) + 1 if colidx.numel() else 1
    n_cb = max(n_cb, 1)
    cb = colidx.long().clamp(0, n_cb - 1).reshape(-1)
    live = nz.reshape(n_rb * n_slots, -1).any(dim=1)

    def by_cb(per_tile: torch.Tensor) -> torch.Tensor:
        flat = per_tile.reshape(n_rb * n_slots, -1).long()
        return torch.zeros((n_cb, flat.shape[1]), dtype=torch.long,
                           device=tiles.device).index_add_(0, cb, flat)

    d_warp = by_cb(dsteps.sum(dim=(2, 3, 4))).reshape(n_cb, cc_n, 4)
    d_cta = {"tiles": by_cb(live), "chunks": by_cb(chunks.sum(dim=2)),
             "steps": d_warp.sum(dim=2), "warp_steps": d_warp.amax(dim=2),
             "nonzeros": by_cb(nzc.sum(dim=2))}
    return {"live_tiles": int(live.sum()), "nonzeros": int(nz.sum()),
            "live_chunks": int(chunks.sum()),
            "fwd_steps": int(fsteps.sum()), "dx_steps": int(dsteps.sum()),
            "fwd_ctas": n_rb * kc_n, "dx_ctas": n_cb * cc_n,
            "fwd_cta_max": {k: int(v.max()) for k, v in f_cta.items()},
            "dx_cta_max": {k: int(v.max()) for k, v in d_cta.items()}}


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple,
           device: torch.device) -> None:
    if t.device != device or t.dtype != dtype or tuple(t.shape) != shape \
            or not t.is_contiguous():
        raise ValueError(
            f"spmm_ell: {name} must be a contiguous {dtype} tensor of shape "
            f"{shape} on {device}, got {tuple(t.shape)} {t.dtype} on "
            f"{t.device}")


@_observe.counted(spmm_ell_cost)
def spmm_ell(tiles: torch.Tensor, colidx: torch.Tensor,
             x: torch.Tensor) -> torch.Tensor:
    """``A @ x`` for the block-ELL ``A = (tiles, colidx)``; ``x`` has
    ``n_cb * bn`` rows. float32 accumulation, output in x's type; the tiles
    and x all float32, all bfloat16, or bfloat16 tiles with a float32 x."""
    if x.device.type == "cpu":
        return spmm_ell_plain(tiles, colidx, x)
    dev = x.device
    if dev.type not in ("cuda", "meta"):
        raise ValueError(f"spmm_ell: unsupported device {dev}")
    if tiles.dim() != 4 or x.dim() != 2:
        raise ValueError(f"spmm_ell: tiles must be 4-D and x 2-D, got "
                         f"{tuple(tiles.shape)} and {tuple(x.shape)}")
    n_rb, n_slots, bm, bn = tiles.shape
    n_x, d = x.shape
    if bm <= 0 or bn <= 0 or n_x % bn != 0:
        raise ValueError(f"spmm_ell: x has {n_x} rows, not a multiple of "
                         f"bn={bn} (bm={bm})")
    route, code = route_of(tiles, x)
    _check(tiles, "tiles", tiles.dtype, (n_rb, n_slots, bm, bn), dev)
    _check(colidx, "colidx", torch.int32, (n_rb, n_slots), dev)
    _check(x, "x", x.dtype, (n_x, d), dev)
    out = torch.empty((n_rb * bm, d), dtype=x.dtype, device=dev)
    if n_rb == 0 or d == 0:
        return out
    if n_x == 0:
        raise ValueError("spmm_ell: x has no rows for the column blocks")
    if dev.type == "meta":
        return out
    lib = _build.load()
    rc = lib.repro_spmm_ell(
        tiles.data_ptr(), colidx.data_ptr(), x.data_ptr(), out.data_ptr(),
        n_rb, n_slots, bm, bn, n_x // bn, d, code,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "spmm_ell")
    global LAUNCHES
    LAUNCHES += 1
    ROUTE_LAUNCHES[route] += 1
    return out


def spmm_ell_dx_plain(tiles: torch.Tensor, colidx: torch.Tensor,
                      g: torch.Tensor, n_rows_x: int) -> torch.Tensor:
    """``A^T @ g`` for the block-ELL ``A = (tiles, colidx)`` in plain
    PyTorch: each slot's ``tiles[rb, s]^T @ g_rowblock`` added in float32
    into its (clamped) column block, slot by slot and, within a slot, row
    block by row block (the reference's ``_spmm_bwd`` order; ``index_add_``
    adds in index order on the CPU). ``n_rows_x`` rows, in g's type."""
    n_rb, n_slots, bm, bn = tiles.shape
    d = g.shape[1]
    n_cb = n_rows_x // bn
    c = colidx.long().clamp(0, max(n_cb - 1, 0))
    gb = g.reshape(n_rb, bm, d).float()
    dx = torch.zeros((n_cb, bn, d), dtype=torch.float32, device=g.device)
    for s in range(n_slots):
        dx.index_add_(0, c[:, s], torch.matmul(
            tiles[:, s].float().transpose(-1, -2), gb))
    return dx.reshape(n_rows_x, d).to(g.dtype)


@_observe.counted(spmm_ell_dx_cost)
def spmm_ell_dx(tiles: torch.Tensor, colidx: torch.Tensor, g: torch.Tensor,
                n_rows_x: int) -> torch.Tensor:
    """The SpMM's input gradient ``dX = A^T @ g`` (``n_rows_x = n_cb * bn``
    rows): the deterministic CUDA kernel (``csrc/spmm_ell_dx.cu``, no
    float atomics, all-zero steps of 1 row x 8 columns skipped) for CUDA
    tensors, its
    plain version for CPU tensors. float32 accumulation, dX in g's type;
    the forward's routes: all float32, all bfloat16, or bfloat16 tiles
    with a float32 g."""
    if g.device.type == "cpu":
        return spmm_ell_dx_plain(tiles, colidx, g, n_rows_x)
    dev = g.device
    if dev.type not in ("cuda", "meta"):
        raise ValueError(f"spmm_ell_dx: unsupported device {dev}")
    if tiles.dim() != 4 or g.dim() != 2:
        raise ValueError(f"spmm_ell_dx: tiles must be 4-D and g 2-D, got "
                         f"{tuple(tiles.shape)} and {tuple(g.shape)}")
    n_rb, n_slots, bm, bn = tiles.shape
    d = g.shape[1]
    if bm <= 0 or bn <= 0 or n_rows_x % bn != 0:
        raise ValueError(f"spmm_ell_dx: {n_rows_x} rows of dX are not a "
                         f"multiple of bn={bn} (bm={bm})")
    chunks = -(-bm // 32) * -(-bn // 32)
    if chunks > 1024:
        raise ValueError(f"spmm_ell_dx: ({bm}, {bn}) tiles hold {chunks} "
                         "32 x 32 chunks, more than 1024")
    route, code = route_of(tiles, g, "spmm_ell_dx", "g")
    _check(tiles, "tiles", tiles.dtype, (n_rb, n_slots, bm, bn), dev)
    _check(colidx, "colidx", torch.int32, (n_rb, n_slots), dev)
    _check(g, "g", g.dtype, (n_rb * bm, d), dev)
    out = torch.empty((n_rows_x, d), dtype=g.dtype, device=dev)
    if n_rows_x == 0 or d == 0 or dev.type == "meta":
        return out
    n_cb, n_t = n_rows_x // bn, n_rb * n_slots
    # the kernel's scratch: each tile's row words (a word of 32 row bits a
    # 32-row chunk and group of 8 columns) and its liveness
    work = torch.empty((16 * n_t * chunks + n_t,), dtype=torch.uint8,
                       device=dev)
    lib = _build.load()
    rc = lib.repro_spmm_ell_dx(
        tiles.data_ptr(), colidx.data_ptr(), g.data_ptr(), out.data_ptr(),
        work.data_ptr(), n_rb, n_slots, bm, bn, n_cb, d, code,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "spmm_ell_dx")
    global DX_LAUNCHES
    DX_LAUNCHES += 1
    DX_ROUTE_LAUNCHES[route] += 1
    return out


def _blocks(adj: torch.Tensor, bm: int, bn: int) -> torch.Tensor:
    """(R, C) -> (n_rb, n_cb, bm, bn) tile view (a copy)."""
    r, c = adj.shape
    if r % bm or c % bn:
        raise ValueError(f"({r}, {c}) does not tile into ({bm}, {bn})")
    return adj.reshape(r // bm, bm, c // bn, bn).permute(0, 2, 1, 3)


def dense_to_block_ell(adj: torch.Tensor, bm: int, bn: int, n_slots: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense (R, C) -> block-ELL keeping the ``n_slots`` column-blocks of
    largest L1 mass per row-block, in ascending block order; empty chosen
    blocks become padding. Ties go to the lower block index, as
    ``jax.lax.top_k`` breaks them (a stable descending sort)."""
    blocks = _blocks(adj, bm, bn)
    mass = blocks.abs().sum(dim=(2, 3))                     # (n_rb, n_cb)
    top = torch.sort(mass, dim=1, descending=True, stable=True).indices
    colidx = torch.sort(top[:, :n_slots], dim=1).values
    tiles = torch.gather(
        blocks, 1, colidx[:, :, None, None].expand(-1, -1, bm, bn))
    slot_mass = torch.gather(mass, 1, colidx)
    tiles = tiles * (slot_mass[:, :, None, None] > 0)
    colidx = torch.where(slot_mass > 0, colidx, torch.zeros_like(colidx))
    return tiles, colidx.to(torch.int32)


def dense_to_block_ell_ranked(adj: torch.Tensor, bm: int, bn: int,
                              n_slots: int
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense -> block-ELL with the direct extraction's slot layout
    (``core.sampling.extract_block_ell``): slot s of a row-block holds its
    s-th smallest non-empty column-block; blocks past ``n_slots`` are
    dropped. The tiles keep the block's type (a bf16 block gives bf16
    tiles); a tile's liveness sums ``abs`` in float32, as the reference
    does. Fixed-shape work with no read on the host (a CUDA graph can
    capture it): slot s's column-block is where the running count of
    non-empty blocks first reaches s + 1."""
    blocks = _blocks(adj, bm, bn)
    n_rb, n_cb = blocks.shape[:2]
    # the liveness sum in float32 without a float32 copy of the block
    cum = torch.cumsum(blocks.abs().sum(dim=(2, 3), dtype=torch.float32)
                       > 0, dim=1)
    s = torch.arange(n_slots, device=adj.device)
    cb = torch.searchsorted(cum, (s + 1).repeat(n_rb, 1))
    valid = s < cum[:, -1:]
    cb = torch.where(valid, cb, torch.zeros_like(cb))
    rb = torch.arange(n_rb, device=adj.device)[:, None]
    tiles = blocks[rb, cb]                              # (n_rb, S, bm, bn)
    tiles.masked_fill_(~valid[:, :, None, None], 0)
    return tiles, cb.to(torch.int32)


def ell_to_dense(tiles: torch.Tensor, colidx: torch.Tensor,
                 n_cols: int) -> torch.Tensor:
    """Densify a block-ELL matrix to float32; padding slots (zero tiles at
    column-block 0) contribute nothing."""
    n_rb, n_slots, bm, bn = tiles.shape
    if n_cols % bn:
        raise ValueError(f"n_cols={n_cols} is not a multiple of bn={bn}")
    out = torch.zeros((n_rb, n_cols // bn, bm, bn), dtype=torch.float32,
                      device=tiles.device)
    rb = torch.arange(n_rb, device=tiles.device)[:, None].expand(
        colidx.shape)
    out.index_put_((rb, colidx.long()), tiles.float(), accumulate=True)
    return out.permute(0, 2, 1, 3).reshape(n_rb * bm, n_cols)


def block_density(adj: torch.Tensor, bm: int, bn: int) -> torch.Tensor:
    """Fraction of (bm, bn) blocks with any non-zero entry — the kernel's
    work ratio against a dense product."""
    nz = _blocks(adj, bm, bn).abs().sum(dim=(2, 3)) > 0
    return nz.float().mean()
