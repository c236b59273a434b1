"""Public wrappers of the port's kernels with their autograd rules
(counterpart of ``repro/kernels/ops.py``).

The SpMM and the tail are ``torch.autograd.Function``s: the forward is the
CUDA kernel for CUDA tensors (its plain version for CPU tensors). The
SpMM's dX and the tail's backward (dx and d_scale) are kernels of their
own (``spmm_ell.spmm_ell_dx``, ``fused_layer.fused_layer_bwd``: both
deterministic, so a training run repeats bit for bit on the card), though
the reference's custom VJPs are plain jnp (``_spmm_bwd``, ``_fused_bwd``)
with no Pallas kernel; the SpMM's dTiles, which no path asks for, is plain
PyTorch. The tail takes its keep bits as a mask or as the counter key, in
both directions. Attention saves (q, k, v, out, lse), as the reference's
``_fa_fwd`` does, and its backward is a deterministic kernel of its own
(``flash_attention.flash_attention_bwd``), where the reference's ``_fa_bwd``
is plain jnp.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import fused_layer as _fused
from repro_torch.kernels import spmm_ell as _spmm

# ---------------------------------------------------------------------------
# Block-ELL SpMM
# ---------------------------------------------------------------------------


class _SpmmEll(torch.autograd.Function):
    """out = A @ x for A = (tiles, colidx); colidx gets no gradient."""

    @staticmethod
    def forward(ctx, tiles, colidx, x):
        ctx.save_for_backward(tiles, colidx, x)
        return _spmm.spmm_ell(tiles, colidx, x)

    @staticmethod
    def backward(ctx, g):
        tiles, colidx, x = ctx.saved_tensors
        dtiles = dx = None
        if ctx.needs_input_grad[2]:
            # dX = A^T g: the deterministic kernel (its plain version on
            # the CPU)
            dx = _spmm.spmm_ell_dx(tiles, colidx, g.contiguous(), x.shape[0])
        if ctx.needs_input_grad[0]:
            # dTiles = g_rowblock @ x_colblock^T per slot (no path asks for
            # it: the tiles never require grad)
            n_rb, n_slots, bm, bn = tiles.shape
            d = x.shape[1]
            n_cb = x.shape[0] // bn
            c = colidx.long().clamp(0, max(n_cb - 1, 0))
            xb = x.reshape(n_cb, bn, d)[c]                 # (n_rb, S, bn, d)
            dtiles = torch.matmul(g.reshape(n_rb, bm, d)[:, None],
                                  xb.transpose(-1, -2)).to(tiles.dtype)
        return dtiles, None, dx


def spmm_ell(tiles: torch.Tensor, colidx: torch.Tensor,
             x: torch.Tensor) -> torch.Tensor:
    """Block-ELL SpMM (paper Eq. 5) with its autograd rule."""
    return _SpmmEll.apply(tiles, colidx, x)


# ---------------------------------------------------------------------------
# Fused element-wise layer tail
# ---------------------------------------------------------------------------


class _FusedTail(torch.autograd.Function):
    """RMSNorm -> ReLU -> dropout -> residual; the keep bits come from a
    mask or a counter key (at most one), which get no gradient."""

    @staticmethod
    def forward(ctx, x, scale, mask, key, residual, dropout_rate, eps,
                use_rmsnorm, use_relu):
        ctx.save_for_backward(x, scale, mask, key)
        ctx.cfg = (residual is not None, dropout_rate, eps, use_rmsnorm,
                   use_relu)
        return _fused.fused_layer(
            x, scale, mask, residual, dropout_rate=dropout_rate, eps=eps,
            use_rmsnorm=use_rmsnorm, use_relu=use_relu, dropout_key=key)

    @staticmethod
    def backward(ctx, g):
        """dx and d_scale from the backward kernel (its plain version on
        the CPU), which recomputes the forward up to the ReLU's input and
        redraws the keep bits; d_res is g before the mask."""
        x, scale, mask, key = ctx.saved_tensors
        has_res, dropout_rate, eps, use_rmsnorm, use_relu = ctx.cfg
        dx, d_scale = _fused.fused_layer_bwd(
            g.float().contiguous(), x, scale, mask,
            dropout_rate=dropout_rate, eps=eps, use_rmsnorm=use_rmsnorm,
            use_relu=use_relu, dropout_key=key)
        return (dx, d_scale, None, None,
                g.to(x.dtype) if has_res else None, None, None, None, None)


def fused_layer_tail(
    x: torch.Tensor,
    residual: Optional[torch.Tensor],
    scale: torch.Tensor,
    *,
    dropout_mask: Optional[torch.Tensor] = None,
    dropout_key: Optional[torch.Tensor] = None,
    dropout_rate: float = 0.0,
    eps: float = 1e-6,
    use_rmsnorm: bool = True,
    use_relu: bool = True,
) -> torch.Tensor:
    """Fused RMSNorm+ReLU+dropout+residual (paper §V-C) with its autograd
    rule: the CUDA kernels for CUDA tensors, their plain versions for CPU
    tensors. The keep bits come from ``dropout_mask`` (a (B, d) bool
    keep-mask) or ``dropout_key`` (the 0-d int64 key of
    ``counter_rng.keep_mask``, drawn inside the kernels, the same bits);
    giving both raises."""
    dropped = dropout_mask is not None or dropout_key is not None
    rate = float(dropout_rate) if dropped else 0.0
    return _FusedTail.apply(x, scale, dropout_mask, dropout_key, residual,
                            rate, float(eps), use_rmsnorm, use_relu)


# ---------------------------------------------------------------------------
# Flash attention
# ---------------------------------------------------------------------------


class _FlashAttention(torch.autograd.Function):
    """out of grouped-query attention; saves (q, k, v, out, lse) and
    recomputes the scores in the backward. ``plain`` takes the plain
    forward and backward on any device (``attn_impl="torch"``), else the
    kernels (their plain versions for CPU tensors); ``q_offset`` (query
    row i at position q_offset + i) goes to both."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, plain, q_offset):
        fwd = _flash.flash_attention_plain if plain else _flash.flash_attention
        out, lse = fwd(q, k, v, causal, window, q_offset)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.cfg = (causal, window, plain, q_offset)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        causal, window, plain, q_offset = ctx.cfg
        bwd = (_flash.flash_attention_bwd_plain if plain
               else _flash.flash_attention_bwd)
        dq, dk, dv = bwd(q, k, v, out, lse, dout.contiguous(), causal,
                         window, q_offset)
        return dq, dk, dv, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: Optional[int] = None, *,
                    plain: bool = False, q_offset: int = 0) -> torch.Tensor:
    """Grouped-query attention with a running softmax and its autograd
    rule; returns ``out`` (B, Sq, H, hd) in q's type: the CUDA kernels
    (forward and backward) for CUDA tensors, their plain versions for CPU
    tensors or, with ``plain``, on any device. Query row i sits at position
    ``q_offset + i`` against keys 0 .. T - 1."""
    return _FlashAttention.apply(q, k, v, causal, window, plain,
                                 int(q_offset))
