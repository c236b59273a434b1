"""Flash-attention forward — grouped-query attention with a running softmax
as a CUDA kernel.

Counterpart of ``repro/kernels/flash_attention.py``. For

    q : (B, Sq, H, hd)      k, v : (B, T, KV, hd)      H % KV == 0

with a causal mask (``k_pos <= q_pos``), an optional sliding window
(``k_pos > q_pos - window``) or neither, :func:`flash_attention` returns
``(out (B, Sq, H, hd) in q's type, lse (B, H, Sq) float32)``: the CUDA
kernel (``csrc/flash_attention.cu``) for CUDA tensors, and
:func:`flash_attention_plain` — the dense masked softmax in float32, as the
reference's oracle ``ref.flash_attention_ref`` computes it, plus the lse —
for CPU tensors; on the meta device it returns outputs of the right shape
and computes nothing. :func:`flash_attention_cost` counts its work. q head ``h`` reads kv head ``h // (H / KV)``. The kernel
takes hd in {16, 32, 64, 128} and float32 or bfloat16; any Sq and T. It
has two routes, one per type: bfloat16 runs both products on the tensor
cores (``flash_attention_mma_kernel``, ``mma.sync`` with float32
accumulation; its inputs must be 16-byte aligned), float32 on the float32
CUDA cores (``flash_attention_kernel``), never through TF32.
``kernels.ops.flash_attention`` is the public entry.

The backward, :func:`flash_attention_bwd`, returns ``(dq, dk, dv)`` in q's
type from ``(q, k, v, out, lse, dout)``: the CUDA kernels of
``csrc/flash_attention_bwd.cu`` for CUDA tensors and
:func:`flash_attention_bwd_plain` (the reference's ``layers._flash_bwd``
in dense form) for CPU tensors. It has no TPU kernel to replace: the
reference's backward is plain jnp. It is deterministic (no float atomics:
dk and dv are summed over a kv head's q heads inside one CTA), and it
has the forward's two routes, counted in ``BWD_ROUTE_LAUNCHES``.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build, _observe

# kernel launches so far, of both routes (a run zeroes it to show that a path
# used the kernel), and each route's own: "mma" for bfloat16, "f32"
LAUNCHES = 0
ROUTE_LAUNCHES = {"mma": 0, "f32": 0}
# the backward's launches, in total and by route
BWD_LAUNCHES = 0
BWD_ROUTE_LAUNCHES = {"mma": 0, "f32": 0}

HEAD_DIMS = (16, 32, 64, 128)
_DTYPES = (torch.float32, torch.bfloat16)


def attention_mask(sq: int, t: int, causal: bool, window: Optional[int],
                   device: torch.device) -> torch.Tensor:
    """(Sq, T) bool: which keys each query row may see."""
    qp = torch.arange(sq, device=device)[:, None]
    kp = torch.arange(t, device=device)[None, :]
    allow = torch.ones((sq, t), dtype=torch.bool, device=device)
    if causal:
        allow &= kp <= qp
    if window is not None:
        allow &= kp > qp - window
    return allow


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True, window: Optional[int] = None
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
    allow = attention_mask(sq, t, causal, window, q.device)
    s = s.masked_fill(~allow, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - m_safe)
    l_sum = p.sum(dim=-1, keepdim=True).clamp_min(1e-20)
    out = torch.einsum("bhqt,bthd->bqhd", p / l_sum, vv)
    lse = (m_safe + torch.log(l_sum))[..., 0]
    return out.to(q.dtype).contiguous(), lse


def flash_attention_cost(q: torch.Tensor, k: torch.Tensor,
                         v: torch.Tensor, causal: bool = True,
                         window: Optional[int] = None, *, out=None) -> tuple:
    """(operations, bytes) of :func:`flash_attention`: 2 * hd for q.k and
    2 * hd for p.v over the (query, key) pairs that the mask lets through
    (counted on the CPU, whatever the device); q, k and v read once, out
    and the lse written once."""
    b, sq, h, hd = q.shape
    t, kv = k.shape[1], k.shape[2]
    n_bytes = q.element_size() * (2 * b * sq * h * hd + 2 * b * t * kv * hd) \
        + 4 * b * h * sq
    pairs = int(attention_mask(sq, t, causal, window, "cpu").sum())
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
                    causal: bool = True, window: Optional[int] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Attention of ``q`` over ``k``/``v``; returns ``(out, lse)``."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal, window)
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
    if q.dtype == torch.bfloat16 and dev.type == "cuda" \
            and any(x.data_ptr() % 16 for x in (q, k, v)):
        raise ValueError("flash_attention: bfloat16 q, k and v must start "
                         "on a 16-byte boundary (the kernel copies 16 bytes "
                         "at a time)")
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
        float(hd ** -0.5), int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "flash_attention")
    global LAUNCHES
    LAUNCHES += 1
    ROUTE_LAUNCHES["mma" if q.dtype == torch.bfloat16 else "f32"] += 1
    return out, lse


# ---------------------------------------------------------------------------
# Backward
# ---------------------------------------------------------------------------


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, out: torch.Tensor,
                              lse: torch.Tensor, dout: torch.Tensor,
                              causal: bool = True,
                              window: Optional[int] = None
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
    allow = attention_mask(sq, t, causal, window, q.device)
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
                             window: Optional[int] = None, *,
                             out=None) -> tuple:
    """(operations, bytes) of the backward's function, whatever computes
    it: five products (s, dp, dv, dk, dq), each 2 * hd a visible (query,
    key) pair and q head; q, k, v, out, dout and the lse read once, dq, dk
    and dv written once."""
    b, sq, h, hd = q.shape
    t, kv = k.shape[1], k.shape[2]
    es = q.element_size()
    n_bytes = es * (4 * b * sq * h * hd + 4 * b * t * kv * hd) \
        + 4 * b * h * sq
    pairs = int(attention_mask(sq, t, causal, window, "cpu").sum())
    return 10 * hd * pairs * b * h, n_bytes


@_observe.counted(flash_attention_bwd_cost)
def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor,
                        dout: torch.Tensor, causal: bool = True,
                        window: Optional[int] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor,
                                   torch.Tensor]:
    """``(dq, dk, dv)`` of :func:`flash_attention` at ``dout``, from the
    forward's saved ``out`` and ``lse``."""
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, out, lse, dout, causal,
                                         window)
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
    if q.dtype == torch.bfloat16 and dev.type == "cuda" \
            and any(x.data_ptr() % 16 for x in (q, k, v, dout)):
        raise ValueError("flash_attention_bwd: bfloat16 q, k, v and dout "
                         "must start on a 16-byte boundary (the kernels "
                         "copy 16 bytes at a time)")
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    if dev.type == "meta":
        return dq, dk, dv
    if min(b, sq, t, h) == 0:     # nothing to see: every gradient is 0
        return dq.zero_(), dk.zero_(), dv.zero_()
    delta = torch.empty((b, h, sq), dtype=torch.float32, device=dev)
    lib = _build.load()
    rc = lib.repro_flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), dout.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), b, sq, t, h, kv, hd, int(causal),
        int(window is not None), 0 if window is None else int(window),
        float(hd ** -0.5), int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "flash_attention_bwd")
    global BWD_LAUNCHES
    BWD_LAUNCHES += 1
    BWD_ROUTE_LAUNCHES["mma" if q.dtype == torch.bfloat16 else "f32"] += 1
    return dq, dk, dv
