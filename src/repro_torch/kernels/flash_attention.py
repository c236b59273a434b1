"""Flash-attention forward — grouped-query attention with a running softmax
as a CUDA kernel.

Counterpart of ``repro/kernels/flash_attention.py``. For

    q : (B, Sq, H, hd)      k, v : (B, T, KV, hd)      H % KV == 0

with a causal mask (``k_pos <= q_pos``), an optional sliding window
(``k_pos > q_pos - window``) or neither, query row ``i`` at ``q_pos =
q_offset + i`` (``q_offset >= 0``: 0 but for the reference's q-chunked
attention and a sequence-sharded hidden state, whose shard of rows attends
to all the keys), :func:`flash_attention` returns
``(out (B, Sq, H, hd) in q's type, lse (B, H, Sq) float32)``: the CUDA
kernel (``csrc/flash_attention.cu``) for CUDA tensors, and
:func:`flash_attention_plain` — the dense masked softmax in float32, as the
reference's oracle ``ref.flash_attention_ref`` computes it, plus the lse —
for CPU tensors; on the meta device it returns outputs of the right shape
and computes nothing. :func:`flash_attention_cost` counts its work. q head
``h`` reads kv head ``h // (H / KV)``. The kernel takes hd in {16, 32, 64,
80, 128} and float32 or bfloat16; any Sq and T; q, k and v 16-byte aligned
(both routes copy 16 bytes at a time). It has two routes, one per type,
each a CTA of 4 warps per (batch row, q head, 64 query rows) that streams
K/V through a ``cp.async`` double buffer: bfloat16 runs both products on
the tensor cores (``flash_attention_mma_kernel``, ``mma.sync`` with
float32 accumulation), float32 on the float32 CUDA cores
(``flash_attention_kernel``), never through TF32, in register tiles: a
lane scores 8 rows against 4 keys of a 64-key block (2 of 32 at hd 80
and 128),
the running max is reduced over the 16 lanes of a row, p goes through the
warp's own columns of shared memory, and the lane accumulates an 8 x hd/16
tile of the output. The float32 route is bound by operations (2 * 2 * hd a
visible pair and q head at 67 TFLOP/s): every shared-memory load and
softmax instruction takes an issue slot from its FMAs. :func:`fwd_plan`
gives the grid's order (the last query tile first under a causal mask, so
the heaviest CTAs start first) and :func:`fwd_steps` the key blocks each
CTA walks. ``kernels.ops.flash_attention`` is the public entry.

The backward, :func:`flash_attention_bwd`, returns ``(dq, dk, dv)`` in q's
type from ``(q, k, v, out, lse, dout)``: the CUDA kernels of
``csrc/flash_attention_bwd.cu`` for CUDA tensors and
:func:`flash_attention_bwd_plain` (the reference's ``layers._flash_bwd``
in dense form) for CPU tensors. It has no TPU kernel to replace: the
reference's backward is plain jnp. Its kernels take the forward's head
dims (hd 80, zamba2's shared attention, as five 16-column panels on the
bfloat16 route and 5 columns a lane on the float32 route). It is
deterministic (no float atomics:
a dq kernel, a dk/dv kernel whose units each sum a share of a kv head's q
heads, and, when the heads are split, a pass that sums the shares in a
fixed order), and it has the forward's two routes, counted in
``BWD_ROUTE_LAUNCHES``: bfloat16 on ``wgmma`` fed by TMA, float32 in
register tiles on the CUDA cores. :func:`bwd_plan` chooses the dk/dv
kernel's units from the shape (under a causal mask the key blocks the
diagonal crosses paired, those past the last query's position zeroed
without a unit; the q heads split as far as the card needs) and
:func:`bwd_steps` lists the work that plan gives each CTA.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch

from repro_torch.kernels import _build, _observe

# kernel launches so far, of both routes (a run zeroes it to show that a path
# used the kernel), and each route's own: "mma" for bfloat16, "f32"
LAUNCHES = 0
ROUTE_LAUNCHES = {"mma": 0, "f32": 0}
# the backward's launches, in total and by route
BWD_LAUNCHES = 0
BWD_ROUTE_LAUNCHES = {"mma": 0, "f32": 0}

HEAD_DIMS = (16, 32, 64, 80, 128)       # the forward's and the backward's
_DTYPES = (torch.float32, torch.bfloat16)


def attention_mask(sq: int, t: int, causal: bool, window: Optional[int],
                   device: torch.device, q_offset: int = 0) -> torch.Tensor:
    """(Sq, T) bool: which keys each query row (at position q_offset + its
    index) may see."""
    qp = torch.arange(sq, device=device)[:, None] + q_offset
    kp = torch.arange(t, device=device)[None, :]
    allow = torch.ones((sq, t), dtype=torch.bool, device=device)
    if causal:
        allow &= kp <= qp
    if window is not None:
        allow &= kp > qp - window
    return allow


def visible_pairs(sq: int, t: int, causal: bool = True,
                  window: Optional[int] = None, q_offset: int = 0) -> int:
    """The (query, key) pairs that :func:`attention_mask` lets through,
    counted row by row in closed form (no (Sq, T) mask is built)."""
    pos = torch.arange(sq, dtype=torch.int64) + q_offset
    hi = torch.full_like(pos, t - 1)
    if causal:
        hi = torch.minimum(hi, pos)
    lo = (torch.clamp(pos - window + 1, min=0) if window is not None
          else torch.zeros_like(pos))
    return int(torch.clamp(hi - lo + 1, min=0).sum())


def _check_offset(q_offset: int, what: str) -> int:
    if int(q_offset) != q_offset or q_offset < 0:
        raise ValueError(f"{what}: q_offset must be an int >= 0, got "
                         f"{q_offset!r}")
    return int(q_offset)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True, window: Optional[int] = None,
                          q_offset: int = 0
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch: the dense masked softmax in
    float32 over K/V repeated per q head, and the lse; a row with no key
    to see gives zeros and ``lse = log(1e-20)``, as the kernel does. out
    is contiguous, as the kernel's, so that the backward takes it."""
    b, sq, h, hd = q.shape
    t, kv = k.shape[1], k.shape[2]
    g = h // kv
    kk = k.float().repeat_interleave(g, dim=2)
    vv = v.float().repeat_interleave(g, dim=2)
    s = torch.einsum("bqhd,bthd->bhqt", q.float(), kk) / math.sqrt(hd)
    allow = attention_mask(sq, t, causal, window, q.device, q_offset)
    s = s.masked_fill(~allow, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - m_safe)
    l_sum = p.sum(dim=-1, keepdim=True).clamp_min(1e-20)
    out = torch.einsum("bhqt,bthd->bqhd", p / l_sum, vv)
    lse = (m_safe + torch.log(l_sum))[..., 0]
    return out.to(q.dtype).contiguous(), lse


def _visible_keys(sq: int, t: int, causal: bool, window: Optional[int],
                  q_offset: int) -> int:
    """How many keys any query row can see: the K/V rows a call must read
    (keys 0 .. q_offset + Sq - 1 under a causal mask, from the first row's
    window start under a window)."""
    hi = min(t, q_offset + sq) if causal else t
    lo = max(0, q_offset - window + 1) if window is not None else 0
    return max(hi - lo, 0)


def flash_attention_cost(q: torch.Tensor, k: torch.Tensor,
                         v: torch.Tensor, causal: bool = True,
                         window: Optional[int] = None, q_offset: int = 0, *,
                         out=None) -> tuple:
    """(operations, bytes) of :func:`flash_attention`: 2 * hd for q.k and
    2 * hd for p.v over the (query, key) pairs that the mask lets through
    (:func:`visible_pairs`, counted on the CPU, whatever the device); q and
    the K/V rows some row can see read once (under a query offset the keys
    past the last row's position are never read), out and the lse written
    once."""
    b, sq, h, hd = q.shape
    t, kv = k.shape[1], k.shape[2]
    tv = _visible_keys(sq, t, causal, window, q_offset)
    n_bytes = q.element_size() * (2 * b * sq * h * hd + 2 * b * tv * kv * hd) \
        + 4 * b * h * sq
    pairs = visible_pairs(sq, t, causal, window, q_offset)
    return 4 * hd * pairs * b * h, n_bytes


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple,
           device: torch.device) -> None:
    if t.device != device or t.dtype != dtype or tuple(t.shape) != shape \
            or not t.is_contiguous():
        raise ValueError(
            f"flash_attention: {name} must be a contiguous {dtype} tensor of "
            f"shape {shape} on {device}, got {tuple(t.shape)} {t.dtype} on "
            f"{t.device}")


@_observe.counted(flash_attention_cost)
def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: Optional[int] = None,
                    q_offset: int = 0
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Attention of ``q`` over ``k``/``v``, query row i at position
    ``q_offset + i``; returns ``(out, lse)``."""
    q_offset = _check_offset(q_offset, "flash_attention")
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal, window, q_offset)
    dev = q.device
    if dev.type not in ("cuda", "meta"):
        raise ValueError(f"flash_attention: unsupported device {dev}")
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"flash_attention: q and k must be 4-D, got "
                         f"{tuple(q.shape)} and {tuple(k.shape)}")
    b, sq, h, hd = q.shape
    t, kv = k.shape[1], k.shape[2]
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {hd} not in "
                         f"{HEAD_DIMS}")
    if q.dtype not in _DTYPES:
        raise ValueError(f"flash_attention: q must be float32 or bfloat16, "
                         f"got {q.dtype}")
    if kv <= 0 or h % kv != 0:
        raise ValueError(f"flash_attention: {h} q heads are not a multiple "
                         f"of {kv} kv heads")
    _check(q, "q", q.dtype, (b, sq, h, hd), dev)
    _check(k, "k", q.dtype, (b, t, kv, hd), dev)
    _check(v, "v", q.dtype, (b, t, kv, hd), dev)
    if dev.type == "cuda" and any(x.data_ptr() % 16 for x in (q, k, v)):
        raise ValueError("flash_attention: q, k and v must start on a "
                         "16-byte boundary (both routes copy 16 bytes at a "
                         "time)")
    out = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=dev)
    if b == 0 or sq == 0 or h == 0 or dev.type == "meta":
        return out, lse
    if t == 0:                       # no key to see: the kernel's empty rows
        out.zero_()
        lse.fill_(math.log(1e-20))
        return out, lse
    lib = _build.load()
    rc = lib.repro_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), b, sq, t, h, kv, hd, int(causal),
        int(window is not None), 0 if window is None else int(window),
        q_offset, float(hd ** -0.5), int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "flash_attention")
    global LAUNCHES
    LAUNCHES += 1
    ROUTE_LAUNCHES["mma" if q.dtype == torch.bfloat16 else "f32"] += 1
    return out, lse


# The forward's plan (csrc/flash_attention.cu): one CTA per (batch row, q
# head, FWD_TILE query rows), (batch row, q head) fastest in the grid and
# the query tile slowest; each CTA walks the key blocks its rows see.
FWD_TILE = 64


@dataclass(frozen=True)
class FwdPlan:
    """The forward kernel's grid for one shape: ``n_ctas`` = B * H *
    ``n_qt`` CTAs, launched (batch row, q head) fastest, then the query
    tile, the last tile first when ``reverse``; each walks the
    ``k_block``-key blocks its FWD_TILE rows can see, staged through
    ``smem_bytes`` of shared memory. Under a causal mask the last tile
    sees the most keys, up to T / 64 times the first's, at any query
    offset (a tile's last visible key is its last row's position): both
    routes launch it first, so that no CTA starts after one with less work
    and the light ones fill the card's last wave. Under a causal window a tile walks at
    most the blocks the window spans; under a window alone the first tile
    sees the most keys, and without a mask every tile sees every key: the
    float32 route keeps the tiles in order there, and the bfloat16 route
    reverses them all the same."""
    route: str
    k_block: int          # keys a staged block
    n_qt: int             # query tiles of FWD_TILE rows
    reverse: bool
    n_ctas: int
    smem_bytes: int       # dynamic shared memory a CTA

    def kernel(self) -> str:
        """The name of the kernel a call launches."""
        return ("flash_attention_mma_kernel" if self.route == "mma"
                else "flash_attention_kernel")


def fwd_plan(b: int, sq: int, t: int, h: int, kv: int, hd: int,
             dtype: torch.dtype, causal: bool = True,
             window: Optional[int] = None) -> FwdPlan:
    """The plan :func:`flash_attention` launches for this shape, at any
    query offset (the offset moves which key blocks a tile walks,
    :func:`fwd_steps`, not the grid)."""
    n_qt = -(-sq // FWD_TILE)
    if dtype == torch.bfloat16:
        return FwdPlan(route="mma", k_block=64, n_qt=n_qt, reverse=True,
                       n_ctas=b * h * n_qt,
                       smem_bytes=(FWD_TILE + 4 * 64) * (hd + 8) * 2)
    k_block = 32 if hd >= 80 else 64
    return FwdPlan(route="f32", k_block=k_block, n_qt=n_qt,
                   reverse=bool(causal), n_ctas=b * h * n_qt,
                   smem_bytes=4 * ((FWD_TILE + 4 * k_block) * (hd + 4)
                                   + k_block * (FWD_TILE + 4)))


def fwd_steps(plan: FwdPlan, b: int, sq: int, t: int, h: int, kv: int,
              causal: bool = True, window: Optional[int] = None,
              q_offset: int = 0) -> List[list]:
    """The work of each CTA under ``plan``, in launch order (blockIdx.y *
    B * H + blockIdx.x), as the kernel indexes it: a list of (batch row, q
    head, query tile of FWD_TILE, key block of plan.k_block) in the order
    it walks them."""
    ctas = []
    for y in range(plan.n_qt):
        tile = plan.n_qt - 1 - y if plan.reverse else y
        kb0, kb1 = _key_blocks(tile * FWD_TILE, FWD_TILE, plan.k_block, sq,
                               t, causal, window, q_offset)
        for x in range(b * h):
            bi, head = divmod(x, h)
            ctas.append([(bi, head, tile, kb) for kb in range(kb0, kb1)])
    return ctas


# ---------------------------------------------------------------------------
# Backward
# ---------------------------------------------------------------------------


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, out: torch.Tensor,
                              lse: torch.Tensor, dout: torch.Tensor,
                              causal: bool = True,
                              window: Optional[int] = None,
                              q_offset: int = 0
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """The backward's function in plain PyTorch, with the reference's
    numerics (``layers._flash_bwd``) over the whole of T at once:
    D = sum(dout * out) in float32; p = exp(s * scale - lse), masked;
    p and ds = p * (dp - D) * scale rounded to q's type before their
    products, which accumulate in float32; dk and dv summed over the g q
    heads of each kv head. Returns ``(dq, dk, dv)`` in q's type."""
    b, sq, h, hd = q.shape
    t, kv = k.shape[1], k.shape[2]
    g = h // kv
    scale = hd ** -0.5
    dt = q.dtype
    f = lambda x: x.float()
    qg = f(q).reshape(b, sq, kv, g, hd)
    dog = f(dout).reshape(b, sq, kv, g, hd)
    delta = torch.einsum("bqkgd,bqkgd->bkgq", dog,
                         f(out).reshape(b, sq, kv, g, hd))
    s = torch.einsum("bqkgd,btkd->bkgqt", qg, f(k)) * scale
    allow = attention_mask(sq, t, causal, window, q.device, q_offset)
    p = torch.where(allow, torch.exp(s - lse.reshape(b, kv, g, sq, 1)),
                    0.0)
    del s
    dv = torch.einsum("bkgqt,bqkgd->btkd", f(p.to(dt)), dog)
    dp = torch.einsum("bqkgd,btkd->bkgqt", dog, f(v))
    ds = f((p * (dp - delta[..., None]) * scale).to(dt))
    del p, dp
    dq = torch.einsum("bkgqt,btkd->bqkgd", ds, f(k))
    dk = torch.einsum("bkgqt,bqkgd->btkd", ds, qg)
    return dq.reshape(b, sq, h, hd).to(dt), dk.to(dt), dv.to(dt)


def flash_attention_bwd_cost(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, o: torch.Tensor,
                             lse: torch.Tensor, dout: torch.Tensor,
                             causal: bool = True,
                             window: Optional[int] = None,
                             q_offset: int = 0, *, out=None) -> tuple:
    """(operations, bytes) of the backward's function, whatever computes
    it: five products (s, dp, dv, dk, dq), each 2 * hd a visible (query,
    key) pair and q head; q, out, dout, the lse and the K/V rows some row
    can see read once, dq and those rows' dk and dv written once (the
    others are zeros, written without a read)."""
    b, sq, h, hd = q.shape
    t, kv = k.shape[1], k.shape[2]
    es = q.element_size()
    tv = _visible_keys(sq, t, causal, window, q_offset)
    n_bytes = es * (4 * b * sq * h * hd + 4 * b * tv * kv * hd) \
        + 4 * b * h * sq
    pairs = visible_pairs(sq, t, causal, window, q_offset)
    return 10 * hd * pairs * b * h, n_bytes


# The backward's plan (csrc/flash_attention_bwd.cu): a dq kernel of one CTA
# per (batch row, q head, BWD_TILE query rows) walking the key blocks its
# rows see, then a dk/dv kernel of one CTA per unit = (batch row, kv head,
# one or two BWD_TILE-key blocks, a share of the group's q heads) walking
# (key block, q head, query block). The dk/dv kernel steps over 64 query
# rows in bfloat16 and 32 in float32 (half as many at hd 128, for the
# registers; hd 80 keeps 64 and 32: ptxas reports no spill there); the
# float32 dq kernel streams 32 keys a step, the bfloat16 one 64.
BWD_TILE = 64
SMS = 132                 # the H100's streaming multiprocessors
BWD_CTAS_PER_SM = 2       # dk/dv CTAs resident on one SM, either route


@dataclass(frozen=True)
class BwdPlan:
    """The backward kernels' work for one shape: key blocks [0,
    ``pair_lo``) are one a unit, blocks [``pair_lo``, ``pair_hi``) are
    paired j with pair_lo + pair_hi - 1 - j, and blocks from ``pair_hi``
    on get no unit. Under a causal mask without a window the first are the
    blocks that every query row sees whole (none without a query offset),
    the paired ones those the diagonal crosses (their work falls along it,
    so every pair walks about the same number of query blocks: j and
    n_kb - 1 - j of a square triangle), and the last those past the last
    row's position, whose dk and dv rows the launch sets to zero; otherwise
    no block is paired (pair_lo = pair_hi = n_kb). ``pair`` says whether
    any unit holds two; ``split``
    shares a kv head's g q heads over that many units, whose float32
    partials (``part_floats``) a third kernel sums in order; ``stats``
    holds (lse * log2 e, D) of every query row, padded to ``sq_pad``."""
    route: str
    q_block: int          # dk/dv: query rows a step
    k_block: int          # dq: keys a step
    n_kb: int             # BWD_TILE-key blocks
    pair: bool
    pair_lo: int
    pair_hi: int
    split: int
    n_units: int          # dk/dv CTAs
    sq_pad: int
    stats_floats: int
    part_floats: int

    def kernels(self) -> Tuple[str, ...]:
        """The names of the kernels one call launches, in stream order."""
        kind = "wgmma" if self.route == "mma" else "f32"
        names = (f"flash_bwd_dq_{kind}_kernel",
                 f"flash_bwd_dkdv_{kind}_kernel")
        return names + (("flash_bwd_reduce_kernel",) if self.split > 1
                        else ())


def _pair_range(sq: int, n_kb: int, causal: bool, window: Optional[int],
                q_offset: int) -> Tuple[int, int]:
    """(pair_lo, pair_hi) of :class:`BwdPlan`."""
    if not causal or window is not None:
        return n_kb, n_kb
    return (min(n_kb, (q_offset + 1) // BWD_TILE),
            min(n_kb, (q_offset + sq - 1) // BWD_TILE + 1))


def bwd_plan(b: int, sq: int, t: int, h: int, kv: int, hd: int,
             dtype: torch.dtype, causal: bool = True,
             window: Optional[int] = None, q_offset: int = 0) -> BwdPlan:
    """The plan :func:`flash_attention_bwd` launches for this shape. The
    split is the divisor s of g = h / kv that minimises
    ceil(units * s / slots) / s, the waves of BWD_CTAS_PER_SM * SMS slots
    times a unit's share of the work, the smallest s on a tie: enough
    units to fill the card, and no partials where one wave already
    does."""
    route = "mma" if dtype == torch.bfloat16 else "f32"
    g = h // kv
    n_kb = -(-t // BWD_TILE)
    lo, hi = _pair_range(sq, n_kb, causal, window, q_offset)
    base = (lo + -(-(hi - lo) // 2)) * kv * b
    slots = SMS * BWD_CTAS_PER_SM
    split = min((s for s in range(1, g + 1) if g % s == 0),
                key=lambda s: (-(-base * s // slots) / s, s))
    sq_pad = -(-sq // BWD_TILE) * BWD_TILE
    return BwdPlan(
        route=route,
        q_block=(32 if hd == 128 else 64) if route == "mma"
        else (16 if hd == 128 else 32),
        k_block=64 if route == "mma" else 32,
        n_kb=n_kb, pair=hi - lo > 1, pair_lo=lo, pair_hi=hi, split=split,
        n_units=base * split,
        sq_pad=sq_pad, stats_floats=2 * b * h * sq_pad,
        part_floats=2 * split * b * t * kv * hd if split > 1 else 0)


def _key_blocks(q0, qn, kn, sq, t, causal, window, q_offset=0):
    """The kernels' ``key_blocks``: [begin, end) of the kn-key blocks
    that query rows [q0, q0 + qn) (at positions q_offset + row) can
    see."""
    end = -(-t // kn)
    if causal:
        end = min(end, (min(q0 + qn, sq) - 1 + q_offset) // kn + 1)
    begin = 0
    if window is not None:
        first = q0 + q_offset - window + 1
        begin = first // kn if first > 0 else 0
    return begin, max(end, begin)


def _query_blocks(k0, kn, sq, qb, causal, window, q_offset=0):
    """The kernels' ``query_blocks``: [begin, end) of the qb-row query
    blocks (row i at position q_offset + i) that can see keys [k0, k0 +
    kn)."""
    end = -(-sq // qb)
    begin = max(k0 - q_offset, 0) // qb if causal else 0
    if causal and k0 - q_offset >= sq:          # past the last row
        end = 0
    if window is not None:
        last = k0 + kn + window - 2 - q_offset
        end = 0 if last < 0 else min(end, last // qb + 1)
    return begin, max(end, begin)


def bwd_steps(plan: BwdPlan, b: int, sq: int, t: int, h: int, kv: int,
              causal: bool = True, window: Optional[int] = None,
              q_offset: int = 0) -> Tuple[List[list], List[list]]:
    """The work of each CTA under ``plan``, as the kernels index it: the dq
    kernel's CTAs (batch row, q head, 64-row block), each a list of
    (batch row, q head, query block, key block of plan.k_block); and the
    dk/dv kernel's units in blockIdx order, each a list of (batch row, q
    head, query block of plan.q_block, key block of BWD_TILE) in the order
    it sums them."""
    g = h // kv
    n_qb = -(-sq // BWD_TILE)
    dq = []
    for bi in range(b):
        for head in range(h):
            for qb in range(n_qb):
                kb0, kb1 = _key_blocks(qb * BWD_TILE, BWD_TILE,
                                       plan.k_block, sq, t, causal, window,
                                       q_offset)
                dq.append([(bi, head, qb, kb) for kb in range(kb0, kb1)])
    lo, hi = plan.pair_lo, plan.pair_hi
    n_u = lo + -(-(hi - lo) // 2)
    heads = g // plan.split
    dkdv = []
    for x in range(plan.n_units):
        u, r = x % n_u, x // n_u
        share, r = r % plan.split, r // plan.split
        kvh, bi = r % kv, r // kv
        kbs = [u] + ([hi - 1 - (u - lo)]
                     if lo <= u != hi - 1 - (u - lo) else [])
        steps = []
        for kb in kbs:
            q0, q1 = _query_blocks(kb * BWD_TILE, BWD_TILE, sq, plan.q_block,
                                   causal, window, q_offset)
            for head in range(kvh * g + share * heads,
                              kvh * g + (share + 1) * heads):
                steps.extend((bi, head, qb, kb) for qb in range(q0, q1))
        dkdv.append(steps)
    return dq, dkdv


@_observe.counted(flash_attention_bwd_cost)
def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor,
                        dout: torch.Tensor, causal: bool = True,
                        window: Optional[int] = None, q_offset: int = 0
                        ) -> Tuple[torch.Tensor, torch.Tensor,
                                   torch.Tensor]:
    """``(dq, dk, dv)`` of :func:`flash_attention` at ``dout``, from the
    forward's saved ``out`` and ``lse`` (``q_offset`` as there)."""
    q_offset = _check_offset(q_offset, "flash_attention_bwd")
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, out, lse, dout, causal,
                                         window, q_offset)
    dev = q.device
    if dev.type not in ("cuda", "meta"):
        raise ValueError(f"flash_attention_bwd: unsupported device {dev}")
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"flash_attention_bwd: q and k must be 4-D, got "
                         f"{tuple(q.shape)} and {tuple(k.shape)}")
    b, sq, h, hd = q.shape
    t, kv = k.shape[1], k.shape[2]
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention_bwd: head dim {hd} not in "
                         f"{HEAD_DIMS}")
    if q.dtype not in _DTYPES:
        raise ValueError(f"flash_attention_bwd: q must be float32 or "
                         f"bfloat16, got {q.dtype}")
    if kv <= 0 or h % kv != 0:
        raise ValueError(f"flash_attention_bwd: {h} q heads are not a "
                         f"multiple of {kv} kv heads")
    for name, x, dtype, shape in (
            ("q", q, q.dtype, (b, sq, h, hd)), ("k", k, q.dtype,
                                                (b, t, kv, hd)),
            ("v", v, q.dtype, (b, t, kv, hd)),
            ("out", out, q.dtype, (b, sq, h, hd)),
            ("dout", dout, q.dtype, (b, sq, h, hd)),
            ("lse", lse, torch.float32, (b, h, sq))):
        _check(x, name, dtype, shape, dev)
    if dev.type == "cuda" \
            and any(x.data_ptr() % 16 for x in (q, k, v, out, dout)):
        raise ValueError("flash_attention_bwd: q, k, v, out and dout must "
                         "start on a 16-byte boundary (the kernels copy 16 "
                         "bytes at a time)")
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    if dev.type == "meta":
        return dq, dk, dv
    if min(b, sq, t, h) == 0:     # nothing to see: every gradient is 0
        return dq.zero_(), dk.zero_(), dv.zero_()
    plan = bwd_plan(b, sq, t, h, kv, hd, q.dtype, causal, window, q_offset)
    stats = torch.empty(plan.stats_floats, dtype=torch.float32, device=dev)
    part = (torch.empty(plan.part_floats, dtype=torch.float32, device=dev)
            if plan.part_floats else None)
    lib = _build.load()
    rc = lib.repro_flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), dout.data_ptr(), stats.data_ptr(),
        None if part is None else part.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), b, sq, t, h, kv, hd, int(causal),
        int(window is not None), 0 if window is None else int(window),
        q_offset, plan.pair_lo, plan.pair_hi, plan.split, float(hd ** -0.5),
        int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "flash_attention_bwd")
    global BWD_LAUNCHES
    BWD_LAUNCHES += 1
    BWD_ROUTE_LAUNCHES[plan.route] += 1
    return dq, dk, dv
