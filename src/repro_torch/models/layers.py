"""Transformer building blocks (counterpart of ``repro/models/layers.py``).

Functions over parameter mappings: ``p["wq"]`` and ``"bq" in p`` work on a
dict of tensors and on the ``nn.ParameterDict``s of
``models/transformer.py`` alike. Norm and softmax statistics run in
float32 whatever the compute dtype, as in the reference; GQA stays grouped
(no K/V repetition in memory).

Full-sequence attention (:func:`blockwise_attention`, with the
reference's query offset and its q-chunked causal path) goes through
``kernels.ops.flash_attention`` — the CUDA flash kernel for CUDA tensors —
where the reference runs its jnp running-softmax scan; the two compute the
same function (``tests/test_kernels_flash.py`` holds the reference's Pallas
kernel and its scan equal). Gradients flow through it: the forward saves
(q, k, v, out, lse) and the backward recomputes the scores, as the
reference's custom VJP does. Every function that reaches it takes
``attn_impl``: ``"cuda"`` (the default) goes through the kernels' wrappers
(forward and backward), ``"torch"`` through their plain versions on any
device. Single-token
decode attention (:func:`decode_attention`) is plain PyTorch in float32,
as the reference's is plain jnp.
"""
from __future__ import annotations

from typing import Mapping, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops

ATTN_IMPLS = ("cuda", "torch")

# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    x32 = x.float()
    ms = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(ms + eps) * scale.float()).to(x.dtype)


def layernorm(x: torch.Tensor, scale: torch.Tensor,
              bias: Optional[torch.Tensor], eps: float) -> torch.Tensor:
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x32 - mu), dim=-1, keepdim=True)
    out = (x32 - mu) * torch.rsqrt(var + eps) * scale.float()
    if bias is not None:
        out = out + bias.float()
    return out.to(x.dtype)


def apply_norm(x: torch.Tensor, p: Mapping, kind: str,
               eps: float) -> torch.Tensor:
    if kind.startswith("layernorm"):      # "layernorm" | "layernorm_nobias"
        return layernorm(x, p["scale"], p["bias"] if "bias" in p else None,
                         eps)
    return rmsnorm(x, p["scale"], eps)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """Rotary embedding. x: (B, S, H, hd); positions: (B, S) or (S,)."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    if positions.dim() == 1:
        positions = positions[None, :]
    ang = positions[..., None].float() * freqs             # (B, S, half)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.split(x.float(), half, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


def _check_impl(attn_impl: str) -> None:
    if attn_impl not in ATTN_IMPLS:
        raise ValueError(f"attn_impl={attn_impl!r}, expected one of "
                         f"{ATTN_IMPLS}")


# Causal q-chunking (the reference's perf knob): when set, causal
# self-attention over a whole sequence splits the queries into chunks of
# this many rows and chunk i attends only to its KV prefix, with its first
# row's position as the query offset. None = off.
_Q_CHUNK: Optional[int] = None

# The reference's attention layout knob (its ``set_attn_sharding``):
# stored, read nowhere (see set_attn_sharding).
_ATTN_SHARDING = None


def set_q_chunk(n: Optional[int]) -> None:
    global _Q_CHUNK
    _Q_CHUNK = n


def set_attn_sharding(qs_kv: Optional[tuple]) -> None:
    """The reference's layout constraint for the attention operands,
    ``(q_sharding, kv_sharding)``: q over the sequence, K and V whole (its
    GSPMD would otherwise contract over a sharded head dim). The port's
    sharded step always lays attention out that way (a rank's query rows
    against the K/V gathered over ``model``, ``models/sharded.py``), so
    the argument is kept and changes nothing."""
    global _ATTN_SHARDING
    _ATTN_SHARDING = qs_kv


def blockwise_attention(
    q: torch.Tensor,                 # (B, Sq, H, hd)
    k: torch.Tensor,                 # (B, T, KV, hd)
    v: torch.Tensor,                 # (B, T, KV, hd)
    *,
    causal: bool = True,
    window: Optional[int] = None,
    q_offset: int = 0,
    attn_impl: str = "cuda",
) -> torch.Tensor:
    """Running-softmax attention, (B, Sq, H, hd) in q's type, with its
    autograd rule; query row i sits at position ``q_offset + i`` against
    keys 0 .. T - 1. The kernels stage their own blocks of 64 keys, so the
    reference's ``kv_block`` is not an argument. Under ``set_q_chunk(qc)``
    the reference's q-chunked path runs, on the reference's condition
    (causal, no window, ``q_offset == 0``, ``Sq == T``, ``Sq % qc == 0``,
    ``Sq > qc``): chunk [qs, qs + qc) attends to keys [0, qs + qc) with
    ``q_offset = qs`` (the reference rounds that prefix up to its
    ``kv_block``, keys its causal mask hides), and the gradients of the
    key slices add up across the chunks."""
    _check_impl(attn_impl)
    plain = attn_impl == "torch"
    sq, t = q.shape[1], k.shape[1]
    qc = _Q_CHUNK
    if (qc and causal and window is None and q_offset == 0 and sq == t
            and sq % qc == 0 and sq > qc):
        return torch.cat([
            ops.flash_attention(q[:, qs:qs + qc].contiguous(),
                                k[:, :qs + qc].contiguous(),
                                v[:, :qs + qc].contiguous(), causal, None,
                                plain=plain, q_offset=qs)
            for qs in range(0, sq, qc)], dim=1)
    return ops.flash_attention(q, k, v, causal, window, plain=plain,
                               q_offset=q_offset)


def decode_attention(
    q: torch.Tensor,            # (B, 1, H, hd), already roped at its position
    k_cache: torch.Tensor,      # (B, T, KV, hd), roped at insert time
    v_cache: torch.Tensor,      # (B, T, KV, hd)
    cache_len: Union[int, torch.Tensor],  # valid entries: scalar or (B, 1)
) -> torch.Tensor:
    """Single-token attention over a (possibly ring) KV cache, in float32.
    Slots below ``min(cache_len, T)`` hold data, which covers a ring buffer
    that has wrapped (every slot valid) and one that has not, so the
    reference's ``ring`` flag is not an argument. An int ``cache_len`` of
    at least T (a cross K/V, every entry valid) masks nothing, and reads
    nothing from the host."""
    b, _, h, hd = q.shape
    t, kv = k_cache.shape[1], k_cache.shape[2]
    g = h // kv
    scale = hd ** -0.5
    qg = q.reshape(b, kv, g, hd).float()
    s = torch.einsum("bkgd,btkd->bkgt", qg, k_cache.float()) * scale
    if not (isinstance(cache_len, int) and cache_len >= t):
        slot = torch.arange(t, device=q.device)
        cl = torch.as_tensor(cache_len, device=q.device)
        valid = slot[None] < torch.clamp(cl, max=t)           # (1|B, T)
        s = s.masked_fill(~valid[:, None, None, :], float("-inf"))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgt,btkd->bkgd", p, v_cache.float())
    return out.reshape(b, 1, h, hd).to(q.dtype)


def attn_project_qkv(p: Mapping, x: torch.Tensor, n_heads: int, n_kv: int,
                     hd: int) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    b, s, _ = x.shape
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if "bq" in p:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    return (q.reshape(b, s, n_heads, hd), k.reshape(b, s, n_kv, hd),
            v.reshape(b, s, n_kv, hd))


def attention_block(
    p: Mapping, x: torch.Tensor, *, n_heads: int, n_kv: int, hd: int,
    rope_theta: Optional[float], positions: torch.Tensor,
    causal: bool = True, window: Optional[int] = None,
    attn_impl: str = "cuda", return_kv: bool = False,
):
    """Full-sequence self-attention (train / prefill). With ``return_kv``
    also returns the roped ``(k, v)``, so that a prefill projects them once
    for its cache."""
    b, s, _ = x.shape
    q, k, v = attn_project_qkv(p, x, n_heads, n_kv, hd)
    if rope_theta is not None:
        q = rope(q, positions, rope_theta)
        k = rope(k, positions, rope_theta)
    out = blockwise_attention(q, k, v, causal=causal, window=window,
                              attn_impl=attn_impl)
    y = out.reshape(b, s, n_heads * hd) @ p["wo"]
    return (y, (k, v)) if return_kv else y


def cross_attention_block(
    p: Mapping, x: torch.Tensor, kv_src: torch.Tensor, *, n_heads: int,
    n_kv: int, hd: int, attn_impl: str = "cuda", return_kv: bool = False,
):
    """Cross-attention (the VLM's image layers, whisper's decoder): q from
    ``x``, k and v from the memory ``kv_src``, no RoPE and no mask, no
    bias (the reference's projections have none). The reference's
    ``kv_block`` halving only picks its scan's block for a memory that is
    no multiple of 512; the kernels stage 64-key blocks of any T, so it is
    not an argument. With ``return_kv`` also returns ``(k, v)``, so that a
    prefill projects the memory once for its cache."""
    b, s, _ = x.shape
    t = kv_src.shape[1]
    q = (x @ p["wq"]).reshape(b, s, n_heads, hd)
    k = (kv_src @ p["wk"]).reshape(b, t, n_kv, hd)
    v = (kv_src @ p["wv"]).reshape(b, t, n_kv, hd)
    out = blockwise_attention(q, k, v, causal=False, attn_impl=attn_impl)
    y = out.reshape(b, s, n_heads * hd) @ p["wo"]
    return (y, (k, v)) if return_kv else y


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------


def swiglu_mlp(p: Mapping, x: torch.Tensor) -> torch.Tensor:
    return (F.silu(x @ p["wg"]) * (x @ p["wu"])) @ p["wd"]


def gelu_mlp(p: Mapping, x: torch.Tensor) -> torch.Tensor:
    h = x @ p["w1"]
    if "b1" in p:
        h = h + p["b1"]
    h = F.gelu(h, approximate="tanh")      # jax.nn.gelu's default
    h = h @ p["w2"]
    if "b2" in p:
        h = h + p["b2"]
    return h


def mlp_block(p: Mapping, x: torch.Tensor, kind: str) -> torch.Tensor:
    return swiglu_mlp(p, x) if kind == "swiglu" else gelu_mlp(p, x)
